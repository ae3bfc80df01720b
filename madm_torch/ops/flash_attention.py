"""Flash attention: forward (kernel K1), backward (kernel K3), their plain
PyTorch twins, and the autograd Function that joins them.

``flash_attention`` takes ``[B, S, H, D]`` tensors (the JAX package's
layout).  A CPU tensor goes to the twins (``attention_reference``, and
``attention_backward_reference`` for its gradient); a CUDA tensor launches
the hand-written kernels ``csrc/flash_attention.cu`` (which replaces
``madm_tpu/ops/flash_attention.py::_attn_kernel``) and
``csrc/flash_attention_bwd.cu`` (which replaces ``_attn_bwd_kernel``), or
raises.  When a gradient is needed, K1 also writes the fp32 row
log-sum-exp that K3 recomputes the probabilities from; eval passes skip it.
K1's fp32 body runs on the tensor cores from tf32 pieces ("3xTF32",
``csrc/flash_fwd_tf32.cuh``) wherever TMA can address the tensors;
``attention_tf32x3_reference`` states its arithmetic (the rounded tf32
split of ``tf32_split``, the products of the pieces, the key tiles' online
softmax and the key-split partials merged in split order).  K3's fp32 body
is 3xTF32 on TMA too (``csrc/flash_bwd_tf32.cuh``), and
``attention_backward_tf32x3_reference`` states its arithmetic.
``flash_attention.launches`` and ``flash_attention_backward.launches`` count
kernel launches.  ``forward_plan`` and ``backward_plan`` state, as pure
functions of shape, strides and dtype, how the two kernels launch (body,
tiles, grids, shared memory, the dK/dV split, K3's workspace) and raise for
bf16 input that their TMA bodies cannot address; the wrappers go by them,
and ``split_dkdv_reference`` is the plain form of K3's split dK/dV sum.

The packed-head path (``packed_attention``) is the same function for the
self-attentions that ``pack_group`` picks when packing is on
(``MADMConfig.flash_pack``), with the TPU kernels' rounding points: kernel
K4 ``csrc/flash_attention_packed.cu`` (replaces ``_packed_attn_kernel``;
its bf16 body is K1's TMA body in a two-pass mode, ``csrc/flash_fwd_tma.cuh``)
and K5 (replaces ``_packed_bwd_kernel``; its bf16 body is K3's kernels on
K4's saved output and row log-sum-exp, entered as
``madm_packed_attention_bwd_tma`` in ``csrc/flash_attention_bwd.cu``, its
fp32 body ``csrc/flash_attention_packed_bwd.cu``).  Their twins are
``packed_attention_reference`` and ``packed_attention_backward_reference``;
``packed_attention_two_pass_reference`` and
``packed_backward_from_stats_reference`` state the bf16 bodies' own
arithmetic (tiles, online statistics, delta from the bf16 output).
``packed_forward_plan`` and ``packed_backward_plan`` state how they launch.
``packed_attention.launches`` and ``packed_attention_backward.launches``
count their launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from .. import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 512
MAX_BWD_HEAD_DIM = 160  # the UNet's widest head; the VAE's D=512 never trains


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v with an fp32 softmax; [B,S,H,D] in, q.dtype out."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype).contiguous()


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 g: torch.Tensor, scale: Optional[float] = None,
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``attention_reference`` for the output gradient ``g``,
    in fp32 as ``_attn_bwd_kernel`` states it: P recomputed from q and k,
    dS = P * (dP - rowsum(dP * P)); returned in the inputs' dtypes."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_LOG2E = 1.4426950408889634
_TF32_MASK = -8192  # 0xFFFFE000 as an int32: the low 13 mantissa bits cleared


def tf32(x: torch.Tensor) -> torch.Tensor:
    """The fp32 tensor ``x`` rounded to the nearest tf32 (10 explicit
    mantissa bits, ties away from zero), as K1's fp32 body rounds what it
    hands a tf32 wgmma: half of the dropped 13 bits added to the magnitude,
    then the 13 bits cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & _TF32_MASK).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of an fp32 tensor as K1's fp32 body splits it: hi = ``tf32(x)``,
    lo = x - hi (exact in fp32, so hi + lo == x); the body stores lo as
    ``tf32(lo)``, which is what a tf32 wgmma reads of it."""
    hi = tf32(x.float())
    return hi, x.float() - hi


def _tf32_product(eq: str, x: torch.Tensor, y: torch.Tensor, x3: bool = False, y3: bool = False) -> torch.Tensor:
    """einsum(eq, x, y) as K1's fp32 body forms it from tf32 pieces, the
    small products first: xl yh + xh yl + xh yh (x = xh + xl, xl read as
    tf32); with ``x3`` (``y3``) x's (y's) third piece xl2 = tf32(xl -
    tf32(xl)) too, so that x = xh + tf32(xl) + xl2, and the products xl2
    yh (xh yl2) and xl yl before them."""
    (xh, xl), (yh, yl) = tf32_split(x), tf32_split(y)
    xl, yl = tf32(xl), tf32(yl)
    out = torch.zeros(())
    if x3:
        out = out + torch.einsum(eq, tf32(x.float() - xh - xl), yh)
    if y3:
        out = out + torch.einsum(eq, xh, tf32(y.float() - yh - yl))
    if x3 or y3:
        out = out + torch.einsum(eq, xl, yl)
    return ((out + torch.einsum(eq, xl, yh)) + torch.einsum(eq, xh, yl)) + torch.einsum(eq, xh, yh)


def attention_tf32x3_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: Optional[float] = None, bk: int = 64, nsplit: int = 1,
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's fp32 body in plain torch: (o, lse) in fp32, o [B, Sq, H, D] and
    lse [B, H, Sq] (natural log of the scaled scores).  q * (scale *
    log2(e)) is formed in fp32; every product (the scores, P V) is formed
    from tf32 pieces as the kernel forms it (``_tf32_product``: hi and lo,
    and a third piece of q and k at D <= 80 and of P at D <= 160); the keys are walked
    in tiles of ``bk`` with the online base-2 softmax (running max m and sum
    l in fp32, o rescaled as m moves); the tiles are cut into ``nsplit``
    contiguous runs as the kernel's grid cuts them (run s takes tiles [s nkt
    // nsplit, (s + 1) nkt // nsplit)), and the runs' partials are merged in
    split order as the combine kernel merges them: M = max m_s, L = sum l_s
    2^(m_s - M), o = (sum o_s 2^(m_s - M)) / L."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qscale = float(torch.tensor(scale, dtype=torch.float32) * torch.tensor(_LOG2E, dtype=torch.float32))
    qs = q.float() * qscale
    kf, vf = k.float(), v.float()
    b, sq, h, d = q.shape
    sk = k.shape[1]
    nkt = -(-sk // bk)
    parts = []
    for sp in range(nsplit):
        m = torch.full((b, h, sq, 1), -math.inf, device=q.device)
        l = torch.zeros((b, h, sq, 1), device=q.device)
        o = torch.zeros((b, h, sq, d), device=q.device)
        for t in range(sp * nkt // nsplit, (sp + 1) * nkt // nsplit):
            k0, k1 = t * bk, min((t + 1) * bk, sk)
            st = _tf32_product("bqhd,bkhd->bhqk", qs, kf[:, k0:k1], d <= 80, d <= 80)
            n = torch.maximum(m, st.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m - n)
            p = torch.exp2(st - n)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            o = o * alpha + _tf32_product("bhqk,bkhd->bhqd", p, vf[:, k0:k1], x3=d <= 160)
            m = n
        parts.append((m, l, o))
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    total, acc = torch.zeros_like(mx), torch.zeros((b, h, sq, d), device=q.device)
    for m, l, o in parts:
        w = torch.exp2(m - mx)
        total = total + l * w
        acc = acc + o * w
    out = acc * (1.0 / total)
    lse = ((mx + torch.log2(total)) * math.log(2.0))[..., 0]
    return out.permute(0, 2, 1, 3).contiguous(), lse.contiguous()


def attention_backward_tf32x3_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                                        g: torch.Tensor, lse: torch.Tensor, scale: Optional[float] = None,
                                        bq: int = 64, bk: int = 64, nsplit: int = 1,
                                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's fp32 body in plain torch: (dq, dk, dv) in fp32 for the output
    gradient ``g`` of ``o`` = attention(q, k, v), from the forward's ``o``
    and its row log-sum-exp ``lse`` [B, H, Sq].  qs = q * (scale * log2(e))
    in fp32 as K1's fp32 body forms it; P = exp2(qs k^T - lse * log2(e));
    delta = rowsum(g o); dS = P (dP - delta) with dP = g v^T; every product
    from tf32 pieces, lo hi + hi lo + hi hi (``_tf32_product``).  dV = P^T g
    and dK = dS^T q * scale are summed over query tiles of ``bq`` rows, each
    tile's product added in fp32, the tiles cut into ``nsplit`` contiguous
    runs (run s takes tiles [s nqt // nsplit, (s + 1) nqt // nsplit)) whose
    sums are added in split order; dQ = dS k * scale over key tiles of
    ``bk``, each added in fp32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qscale = float(torch.tensor(scale, dtype=torch.float32) * torch.tensor(_LOG2E, dtype=torch.float32))
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    lse2 = lse.float() * torch.tensor(_LOG2E, dtype=torch.float32)
    p = torch.exp2(_tf32_product("bqhd,bkhd->bhqk", qf * qscale, kf) - lse2[..., None])
    delta = (gf * o.float()).sum(-1).permute(0, 2, 1)[..., None]  # [B, H, Sq, 1]
    ds = p * (_tf32_product("bqhd,bkhd->bhqk", gf, vf) - delta)
    sq, sk = q.shape[1], k.shape[1]
    nqt = -(-sq // bq)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for sp in range(nsplit):
        pk, pv = torch.zeros_like(kf), torch.zeros_like(vf)
        for t in range(sp * nqt // nsplit, (sp + 1) * nqt // nsplit):
            q0, q1 = t * bq, min((t + 1) * bq, sq)
            pv = pv + _tf32_product("bhqk,bqhd->bkhd", p[:, :, q0:q1], gf[:, q0:q1])
            pk = pk + _tf32_product("bhqk,bqhd->bkhd", ds[:, :, q0:q1], qf[:, q0:q1])
        dk, dv = dk + pk, dv + pv
    dq = torch.zeros_like(qf)
    for k0 in range(0, sk, bk):
        dq = dq + _tf32_product("bhqk,bkhd->bqhd", ds[..., k0:k0 + bk], kf[:, k0:k0 + bk])
    return dq * scale, dk * scale, dv


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,Sq,H,D], k/v [B,Sk,H,D]; got {q.shape}, {k.shape}, {v.shape}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B, H or D")
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k, v must lie on one CUDA device "
                         f"(got {q.device}, {k.device}, {v.device})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q/k/v, got {q.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention needs a unit-stride head dim")


# ------------------------------------------------------------ launch plans
SM_COUNT = 132          # H100 SXM
SMEM_LIMIT = 232_448    # dynamic shared memory a block may use on Hopper


@dataclass(frozen=True)
class Launch:
    kernel: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int  # dynamic shared-memory bytes

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


@dataclass(frozen=True)
class AttentionPlan:
    """How K1, K3, K4 or K5 runs a call: ``body`` "tma_wgmma" (bf16; K4's
    "tma_wgmma_two_pass"), "tma_tf32x3" (K1's and K3's fp32 bodies on the
    tensor cores) or "simt" (the other fp32 bodies, and K1's and K3's where
    TMA cannot address the tensors); ``dn`` the head dim padded for the
    tensor cores (the SIMT bodies' padded head dim); ``bq`` and ``bk`` the query rows and keys of a
    block's tiles (for K3, those of the dK/dV kernel; ``bk_dq``/``bq_dq``
    those of the dQ kernel); ``warpgroups`` the consumer warpgroups of the
    main kernel and ``split_d`` whether they share rows and split D (the
    D=512 VAE attention); ``stages`` the ring's raw tiles; ``nsplit`` the
    splits of K3's query loop or of K1's fp32 key loop; ``launches`` every
    kernel launched, in order; ``workspace_bytes`` K3's scratch (its
    ``delta`` argument) or the fp32 K1's key-split partials."""
    kernel: str
    body: str
    heads: int
    dn: int
    bq: int
    bk: int
    warpgroups: int = 1
    split_d: bool = False
    stages: int = 2
    nsplit: int = 1
    bq_dq: int = 0
    bk_dq: int = 0
    sqp: int = 0
    launches: Tuple[Launch, ...] = ()
    workspace_bytes: int = 0

    @property
    def fills_card(self) -> bool:
        """Every launch but the small prep and reduction runs >= SM_COUNT blocks."""
        return all(l.blocks >= SM_COUNT for l in self.launches
                   if l.kernel not in ("bwd_prep", "dkdv_reduce", "flash_fwd_combine", "bwd_tf32_prep",
                                       "dkdv_tf32_reduce"))

    @property
    def score_copies(self) -> int:
        """How many blocks of the main kernel compute each (query, key) score:
        its grid's y extent over the heads (a kernel that split D's output
        columns over blocks would recompute the scores in each)."""
        return self.launches[0 if self.kernel in ("K1", "K4") else 1].grid[1] // self.heads


def _tma_checks(name: str, d: int, h: int, tensors: Sequence[Tuple[int, Tuple[int, int, int]]],
                batch: int) -> None:
    """Raise unless TMA can address every bf16 tensor: D % 8 == 0, 16-byte
    aligned bases, sequence (and, for B > 1, batch) strides of a multiple of
    16 bytes, and heads side by side or a head stride of a multiple of 16
    bytes.  ``tensors`` holds (base address, (batch, seq, head) element
    strides) of each."""
    if d % 8:
        raise ValueError(f"{name}: bf16 needs a head dim divisible by 8 (got {d})")
    for ptr, (sb, ss, sh) in tensors:
        if ptr % 16:
            raise ValueError(f"{name}: bf16 tensors need 16-byte aligned storage (base {ptr:#x})")
        strides = [ss] + ([sb] if batch > 1 else []) + ([] if sh == d or h == 1 else [sh])
        if any((2 * st) % 16 for st in strides):
            raise ValueError(f"{name}: bf16 strides must be multiples of 16 bytes, got "
                             f"(batch, seq, head) = {(sb, ss, sh)} elements")


def _pad_dn(d: int) -> int:
    return 48 if d <= 48 else 80 if d <= 80 else 160 if d <= 160 else 512


def _fills(sq: int, h: int, b: int) -> bool:
    """Whether 128-row q tiles (two consumer warpgroups a block) still give
    SM_COUNT blocks; else a block takes 64 rows, so that more blocks run."""
    return -(-sq // 128) * h * b >= SM_COUNT


def _chunks(dn: int) -> int:
    return -(-dn // 64)


def _f32_addressable(d: int, h: int, b: int, tensors: Sequence[Tuple[int, Tuple[int, int, int]]]) -> bool:
    """Whether TMA can address every fp32 tensor of ``tensors`` ((base
    address, (batch, seq, head) element strides) of each): D % 4 == 0, a
    16-byte aligned base, and every stepped stride a positive multiple of 4
    elements (16 bytes)."""
    if d % 4:
        return False
    for ptr, (sb, ss, sh) in tensors:
        if ptr % 16 or ss <= 0 or ss % 4:
            return False
        if (b > 1 and (sb <= 0 or sb % 4)) or (h > 1 and (sh <= 0 or sh % 4)):
            return False
    return True


def _tf32_dn(d: int) -> int:
    return next(x for x in (40, 80, 160, 512) if d <= x)


def _tf32_tile(dn: int, bk: int, nwg: int) -> Tuple[int, int]:
    """(ring stages, dynamic shared memory bytes) of the fp32 body's tiles,
    as ``TfTile`` in csrc/flash_fwd_tf32.cuh computes them: Q hi and lo
    (D <= 160), two split regions (K hi and lo, or Vt hi and lo), the
    partial scores (D = 512), as many raw ring slots as fit (up to 3), the
    barriers and 1024 bytes of alignment."""
    split_d = dn == 512
    bq = 64 if split_d else 64 * nwg
    nchs = 2 if split_d else -(-dn // 32)
    cg, dvw = (nwg, 64) if split_d else (1, dn)
    qk_pieces = 3 if not split_d and dn <= 80 else 2  # q and k in three tf32 pieces where memory allows
    qbox, kbox = bq * 128, bk * 128
    s_raw = (nchs * qbox if split_d else 0) + nchs * kbox
    raw = max(s_raw, cg * -(-dvw // 32) * kbox)
    region = max(qk_pieces * s_raw, 2 * cg * -(-bk // 32) * dvw * 128)
    fixed = 1024 + (0 if split_d else qk_pieces * nchs * qbox) + 2 * region + (nwg * 64 * bk * 4 if split_d else 0)
    stages = min(3, (SMEM_LIMIT - fixed - 32) // raw)
    return stages, fixed + stages * raw + 8 * (1 + stages)


def _tf32_nsplit(blocks: int, nkt: int) -> int:
    """Key splits of the fp32 body: 1 where the query blocks fill the card;
    else from ceil(SM_COUNT / blocks) to twice that (at most the key tiles),
    the count whose last wave is fullest, the smallest of equals."""
    if blocks >= SM_COUNT:
        return 1
    lo = -(-SM_COUNT // blocks)
    if lo >= nkt:
        return nkt
    best, best_used, best_slots = lo, blocks * lo, -(-blocks * lo // SM_COUNT) * SM_COUNT
    for n in range(lo + 1, min(2 * lo, nkt) + 1):
        used = blocks * n
        slots = -(-used // SM_COUNT) * SM_COUNT
        if used * best_slots > best_used * slots:
            best, best_used, best_slots = n, used, slots
    return best


@functools.lru_cache(maxsize=256)
def _tf32_plan(b: int, sq: int, sk: int, h: int, d: int) -> AttentionPlan:
    """The fp32 TMA body's plan (``f32_plan`` in csrc/flash_fwd_tf32.cuh)."""
    dn = _tf32_dn(d)
    split_d = dn == 512
    nwg = 2 if split_d or (dn == 40 and _fills(sq, h, b)) else 1
    bq = 64 if split_d else 64 * nwg
    bk = 64 if split_d or dn == 40 else 32
    stages, smem = _tf32_tile(dn, bk, nwg)
    nsplit = _tf32_nsplit(-(-sq // bq) * h * b, -(-sk // bk))
    launches = [Launch("flash_fwd_tf32", (-(-sq // bq), h, b * nsplit), 128 * nwg, smem)]
    if nsplit > 1:
        launches.append(Launch("flash_fwd_combine", (-(-b * h * sq * (d // 4) // 256), 1, 1), 256, 0))
    return AttentionPlan("K1", "tma_tf32x3", h, dn, bq, bk, nwg, split_d, stages, nsplit, launches=tuple(launches),
                         workspace_bytes=4 * nsplit * b * h * sq * (d + 2) if nsplit > 1 else 0)


def _tf32_bwd_tile(dkdv: bool, dn: int, bt: int) -> Tuple[int, int]:
    """(ring stages, dynamic shared memory bytes) of the dK/dV (``dkdv``) or
    dQ kernel of K3's fp32 body, as ``BwdTile`` in csrc/flash_bwd_tf32.cuh
    computes them: the A side's hi and lo boxes of [64][32] resident at
    D <= 80; ring slots of the larger item (a score item: the streamed tile's
    boxes, at D = 160 with the A side's, and for dK/dV the tile's lse2 and
    delta; a product item: a transposed [DN][BT] tile's hi and lo), as many
    as fit up to 4; the barriers and 1024 bytes of alignment."""
    res = dn <= 80
    nch = -(-dn // 32)
    abox, bbox, tbox = 64 * 128, bt * 128, dn * 128
    a_bytes = 4 * nch * abox if res else 0
    s_item = (0 if res else 4 * abox) + 4 * (nch if res else 1) * bbox + (8 * bt if dkdv else 0)
    slot = -(-max(s_item, 2 * (bt // 32) * tbox) // 1024) * 1024
    stages = min(4, (SMEM_LIMIT - 1024 - a_bytes - 40) // slot)
    return stages, 1024 + a_bytes + stages * slot + 8 * (1 + stages)


def _tf32_bwd_bytes(b: int, sq: int, sk: int, h: int, d: int, nsplit: int) -> int:
    """K3's fp32 workspace (``f32_bwd_plan`` in csrc/flash_bwd_tf32.cuh lays
    it out alike, each array at a multiple of 256 bytes): lse2 and delta
    [B, H, Sq rounded up to 64]; the hi and lo pieces of qs, dO, k, v
    [B, S, H, D] and of q, dO, k transposed [B, H, D, S rounded up to 8];
    the split dK/dV loop's partials."""
    def up(x):
        return -(-x // 256) * 256
    sqs = -(-sq // 64) * 64
    nq, nk = b * sq * h * d, b * sk * h * d
    tq, tk = b * h * d * -(-sq // 8) * 8, b * h * d * -(-sk // 8) * 8
    off = up(4 * b * h * sqs)
    for size in (4 * b * h * sqs, 8 * nq, 8 * nq, 8 * nk, 8 * nk, 8 * tq, 8 * tq, 8 * tk):
        off = up(off + size)
    return off + (2 * 4 * nsplit * nk if nsplit > 1 else 0)


@functools.lru_cache(maxsize=256)
def _tf32_bwd_plan(b: int, sq: int, sk: int, h: int, d: int) -> AttentionPlan:
    """K3's fp32 TMA body's plan (``f32_bwd_plan`` in csrc/flash_bwd_tf32.cuh):
    the prep kernel; the dK/dV kernel, 64 keys a block over query tiles of
    64 (D <= 40) or 32, its query loop split as the bf16 body's; the
    reduction where split; the dQ kernel, 64 queries a block over key tiles
    of the same width."""
    dn = next(x for x in (40, 80, 160) if d <= x)
    bt = 64 if dn == 40 else 32
    blocks = -(-sk // 64) * h * b
    nsplit = 1 if blocks >= SM_COUNT else max(1, min(-(-SM_COUNT // blocks), -(-sq // bt) // 2))
    stages, smem_kv = _tf32_bwd_tile(True, dn, bt)
    smem_q = _tf32_bwd_tile(False, dn, bt)[1]
    sqs = -(-sq // 64) * 64
    launches = [Launch("bwd_tf32_prep", (-(-max(sqs, sk) // 32), h, 4 * b), 256, 0),
                Launch("dkdv_tf32", (-(-sk // 64), h, b * nsplit), 128, smem_kv)]
    if nsplit > 1:
        launches.append(Launch("dkdv_tf32_reduce", (min(-(-b * sk * h * d // 256), 4 * SM_COUNT), 1, 1), 256, 0))
    launches.append(Launch("dq_tf32", (-(-sq // 64), h, b), 128, smem_q))
    return AttentionPlan("K3", "tma_tf32x3", h, dn, bt, 64, 1, False, stages, nsplit, 64, bt, sqs,
                         tuple(launches), _tf32_bwd_bytes(b, sq, sk, h, d, nsplit))


def _f32_bwd_addressable(d: int, ptrs: Sequence[int]) -> bool:
    """Whether K3's fp32 TMA body takes contiguous tensors at ``ptrs``: D % 4
    == 0 (TMA's 16-byte strides of the workspace's arrays, the float2
    stores of the gradients) and every base 16-byte aligned."""
    return d % 4 == 0 and d <= MAX_BWD_HEAD_DIM and all(p % 16 == 0 for p in ptrs)


def forward_plan(b: int, sq: int, sk: int, h: int, d: int, dtype: torch.dtype,
                 tensors: Sequence[Tuple[int, Tuple[int, int, int]]] = ()) -> AttentionPlan:
    """K1's plan (``madm_flash_attention_fwd_plan`` and, for float32,
    ``madm_flash_attention_fwd_f32_plan`` in csrc/flash_attention.cu make
    the same choice); ``tensors``: (base address, (batch, seq, head)
    strides) of q, k, v, contiguous at aligned addresses if left out.
    bf16 runs the TMA body, raising for tensors TMA cannot address; float32
    runs the 3xTF32 TMA body where TMA can address the tensors, the SIMT
    body where it cannot (D % 4 != 0, a misaligned base or stride)."""
    if dtype == torch.float32:
        if _f32_addressable(d, h, b, tensors):
            return _tf32_plan(b, sq, sk, h, d)
        dpad = next(x for x in (48, 64, 80, 128, 160, 512) if d <= x)
        bq, bk = (32, 32) if dpad == 512 else (64, 64 if dpad <= 80 else 32)
        smem = 4 * (bq * (dpad + 1) + bk * (dpad + 1) + bk * dpad + bq * (bk + 1))
        return AttentionPlan("K1", "simt", h, dpad, bq, bk, launches=(
            Launch("flash_fwd_simt", (-(-sq // bq), h, b), 256, smem),))
    _tma_checks("flash_attention", d, h, tensors, b)
    dn = _pad_dn(d)
    split_d = dn == 512
    bk = 64 if split_d else 80 if sk <= 80 else 64 if dn == 160 else 128
    nwg = 2 if split_d or _fills(sq, h, b) else 1
    stages = 1 if split_d else 2
    bq = 64 if split_d else 64 * nwg
    nch = _chunks(dn)
    smem = (1024 + nch * bq * 128 + 2 * stages * nch * bk * 128 + (nwg * 64 * bk * 4 if split_d else 0)
            + 8 * (1 + 4 * stages))
    return AttentionPlan("K1", "tma_wgmma", h, dn, bq, bk, nwg, split_d, stages, launches=(
        Launch("flash_fwd_tma", (-(-sq // bq), h, b), 128 * nwg + 32, smem),))


def backward_plan(b: int, sq: int, sk: int, h: int, d: int, dtype: torch.dtype,
                  ptrs: Sequence[int] = ()) -> AttentionPlan:
    """K3's plan for contiguous [B, S, H, D] tensors at addresses ``ptrs``
    (bf16: q, k, v, g, dq, dk, dv; float32: q, k, v, o, g, dq, dk, dv;
    aligned if left out).  ``madm_flash_attention_bwd_plan`` and
    ``madm_flash_attention_bwd_f32_plan`` in csrc/flash_attention_bwd.cu make
    the same choice.  bf16: the prep kernel, the dK/dV kernel over 128-key
    tiles (64 at D=160), its query loop split until SM_COUNT blocks run (at
    least two q tiles a split; fp32 partials, then a reduction in split
    order), and the dQ kernel, raising for tensors TMA cannot address;
    float32: the 3xTF32 TMA body (``_tf32_bwd_plan``) where it can address
    the tensors, the SIMT body where it cannot (D % 4 != 0, a misaligned
    base)."""
    if dtype == torch.float32:
        if _f32_bwd_addressable(d, ptrs):
            return _tf32_bwd_plan(b, sq, sk, h, d)
        n = b * sq * h
        smem = 4 * (2 * 32 * 161 * 2 + 2 * 32 * 33 + 2 * 32)
        return AttentionPlan("K3", "simt", h, 160, 32, 32, launches=(
            Launch("delta", (-(-n // 8), 1, 1), 256, 0),
            Launch("dkdv_simt", (-(-sk // 32), h, b), 256, smem),
            Launch("dq_simt", (-(-sq // 32), h, b), 256, smem)), workspace_bytes=4 * b * h * sq)
    rq = h * d
    _tma_checks("flash_attention_backward", d, h, [(p, (rq * sq, rq, d)) for p in ptrs], b)
    dn = _pad_dn(d)
    # tiles that keep each consumer warpgroup within ptxas's 168 registers
    bq = 64 if dn == 48 else 32
    nwg = 1 if dn == 160 else 2
    bkv = 64 * nwg
    nkt, nqt = -(-sk // bkv), -(-sq // bq)
    blocks = nkt * h * b
    nsplit = 1 if blocks >= SM_COUNT else max(1, min(-(-SM_COUNT // blocks), nqt // 2))
    bk_dq = 80 if sk <= 80 else 64
    nwg_dq = 2 if _fills(sq, h, b) else 1
    sqp = -(-sq // 128) * 128
    nch = _chunks(dn)
    stage = -(-(3 * nch * bq * 128 + 2 * bq * 4) // 1024) * 1024
    smem_kv = 1024 + 2 * nch * bkv * 128 + 2 * stage + 8 * 5
    smem_q = 1024 + 2 * nch * 64 * nwg_dq * 128 + 4 * nch * bk_dq * 128 + 8 * 5
    rows = b * h * sqp
    part = b * sk * h * d * 4 if nsplit > 1 else 0
    off_dkp = -(-(8 * rows + 2 * b * sq * h * d) // 256) * 256
    launches = [Launch("bwd_prep", (-(-rows // 8), 1, 1), 256, 0),
                Launch("dkdv_tma", (nkt, h, b * nsplit), 128 * nwg + 32, smem_kv)]
    if nsplit > 1:
        launches.append(Launch("dkdv_reduce", (min(-(-b * sk * h * d // 256), 4 * SM_COUNT), 1, 1), 256, 0))
    launches.append(Launch("dq_tma", (-(-sq // (64 * nwg_dq)), h, b), 128 * nwg_dq + 32, smem_q))
    return AttentionPlan("K3", "tma_wgmma", h, dn, bq, bkv, nwg, False, 2, nsplit, 64 * nwg_dq, bk_dq, sqp,
                         tuple(launches), off_dkp + 2 * nsplit * part)


_backward_plan = functools.lru_cache(maxsize=256)(backward_plan)  # by shape and dtype alone


def split_dkdv_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                         scale: float, nsplit: int, bq: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) in fp32 as K3's split dK/dV kernel forms them: the q tiles of
    ``bq`` rows are cut into ``nsplit`` contiguous runs as the kernel's grid
    does, each run's partial sums are taken alone, and the partials are
    added in split order, as ``dkdv_reduce_kernel`` adds them."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    nqt = -(-q.shape[1] // bq)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for sp in range(nsplit):
        r0, r1 = sp * nqt // nsplit * bq, (sp + 1) * nqt // nsplit * bq
        dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds[:, :, r0:r1], qf[:, r0:r1])
        dv = dv + torch.einsum("bhqk,bqhd->bkhd", p[:, :, r0:r1], gf[:, r0:r1])
    return dk * scale, dv


def _bind(lib_name: str, fn_name: str, argtypes, restype=ctypes.c_int):
    """The library of ``csrc/<lib_name>.cu`` and its function ``fn_name``,
    typed once (retyping a ctypes function on every call costs host time)."""
    lib = kernels.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, restype
    return lib, fn


def _on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device (the kernels
    launch on the current device and its current stream); no context switch
    where it already is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


_FWD_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float, with_lse: bool = True,
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel K1 on CUDA tensors (raises for any other): (o, lse), lse the
    fp32 row log-sum-exp [B, H, Sq] of the scaled scores, or None unless
    ``with_lse``.  bf16 tensors must be what ``forward_plan`` takes; fp32
    tensors take the body ``forward_plan`` names, with the workspace of its
    key split."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    tensors = [(t.data_ptr(), t.stride()[:3]) for t in (q, k, v)]
    work, nbytes = None, 0
    if q.dtype == torch.bfloat16:
        _tma_checks("flash_attention", d, h, tensors, b)
    elif _f32_addressable(d, h, b, tensors) and q.numel() and k.numel():
        nbytes = _tf32_plan(b, sq, sk, h, d).workspace_bytes
        work = torch.empty(nbytes, dtype=torch.uint8, device=q.device) if nbytes else None
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    if o.numel() == 0:
        return o, lse
    lib, fn = _bind("flash_attention", "madm_flash_attention_fwd", _FWD_ARGS)
    with _on_device(q.device):
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(), None if work is None else work.data_ptr(), nbytes,
                 b, sq, sk, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                 float(scale), torch.cuda.current_stream().cuda_stream)
    kernels.check(lib, err, "flash_attention launch")
    flash_attention.launches += 1
    return o, lse


_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
_BWD_F32_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                 + [ctypes.c_float, ctypes.c_void_p])


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, g: torch.Tensor, lse: Optional[torch.Tensor],
                             scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) for the output gradient ``g`` of ``o = attention(q, k, v)``.
    CPU tensors run ``attention_backward_reference`` (``o`` and ``lse`` are
    not needed); CUDA tensors launch kernel K3 with the forward's ``o`` and
    fp32 ``lse`` [B, H, Sq]: D <= 160, and in bf16 what ``backward_plan``
    takes (D % 8 == 0, 16-byte aligned storage), else it raises; fp32 takes
    the body ``backward_plan`` names, with its workspace."""
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, g, scale)
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d > MAX_BWD_HEAD_DIM:
        raise ValueError(f"flash_attention_backward: head dim {d} > {MAX_BWD_HEAD_DIM}")
    if o.shape != q.shape or g.shape != q.shape or o.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"o {tuple(o.shape)} / g {tuple(g.shape)} must match q {tuple(q.shape)}")
    if lse is None or lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError("flash_attention_backward needs the forward's fp32 lse [B, H, Sq]")
    q, k, v, o, lse = (t.contiguous() for t in (q, k, v, o, lse))
    g = g.to(q.dtype).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.float32:
        plan = backward_plan(b, sq, sk, h, d, q.dtype, [t.data_ptr() for t in (q, k, v, o, g, dq, dk, dv)])
    else:
        plan = _backward_plan(b, sq, sk, h, d, q.dtype)
        backward_plan(b, sq, sk, h, d, q.dtype, [t.data_ptr() for t in (q, k, v, g, dq, dk, dv)])
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # K3's workspace: the body's scratch (the fp32 SIMT body's: delta [B, H, Sq])
    ws = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    if q.dtype == torch.float32:
        lib, fn = _bind("flash_attention_bwd", "madm_flash_attention_bwd_f32", _BWD_F32_ARGS)
        with _on_device(q.device):
            err = fn(*(t.data_ptr() for t in (q, k, v, o, g, lse, ws)), plan.workspace_bytes,
                     *(t.data_ptr() for t in (dq, dk, dv)), b, sq, sk, h, d, float(scale), stream)
    else:
        lib, fn = _bind("flash_attention_bwd", "madm_flash_attention_bwd", _BWD_ARGS)
        with _on_device(q.device):
            err = fn(*(t.data_ptr() for t in (q, k, v, o, g, lse, ws, dq, dk, dv)), b, sq, sk, h, d,
                     float(scale), stream)
    kernels.check(lib, err, "flash_attention_backward launch")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


class FlashAttention(torch.autograd.Function):
    """K1 forward saving (q, k, v, o, lse); K3 backward.  On CPU tensors the
    twins take both roles."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        if q.device.type == "cpu":
            o, lse = attention_reference(q, k, v, scale), None
        else:
            o, lse = flash_attention_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, g, lse, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention on [B, S, H, D]; returns [B, Sq, H, D]
    in q.dtype.  CPU tensors run the twins; CUDA tensors run kernel K1, and
    kernel K3 for the gradient when one is needed."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, float(scale))
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    return flash_attention_forward(q, k, v, scale, with_lse=False)[0]


flash_attention.launches = 0


# ------------------------------------------------------- packed-head path
MAX_PACKED_HEAD_DIM = 64  # 128 // D >= 2: wider heads never pack
PACKED_KEY_TILE = 64  # K4's bf16 keys a tile


def pack_group(sq: int, sk: int, d: int, enabled: bool) -> int:
    """Heads a block of the packed kernels takes; 1 = don't pack (the JAX
    package's ``_pack_group``, its switch ``MADM_FLASH_PACK`` made an
    argument).  Only large self-attention shapes pack: Sq == Sk, S >= 1024
    and S % 512 == 0; then G = min(128 // D, 4), the TPU's 128 lanes over
    the head dim, kept so that the same calls take the packed path."""
    if not enabled or sq != sk or sq < 1024 or sq % 512:
        return 1
    return max(1, min(128 // d, 4))


def packed_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: Optional[float] = None) -> torch.Tensor:
    """K4's function in fp32 with the TPU kernel's rounding points: q *
    scale * log2(e) rounded to q.dtype, a base-2 softmax whose normaliser
    multiplies P before the PV product, P rounded to q.dtype.  [B,S,H,D] in,
    q.dtype out."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs = (q.float() * (scale * _LOG2E)).to(q.dtype).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    p = (e * (1.0 / e.sum(dim=-1, keepdim=True))).to(q.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype).contiguous()


def packed_attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                        g: torch.Tensor, scale: Optional[float] = None,
                                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``packed_attention_reference`` as ``_packed_bwd_kernel``
    states it: P recomputed with the forward's q rounding, delta =
    rowsum(dP * P) in fp32, P and dS rounded to q.dtype before the dV, dQ
    and dK products; returned in the inputs' dtypes."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dt = q.dtype
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.to(dt).float()
    s = torch.einsum("bqhd,bkhd->bhqk", (qf * (scale * _LOG2E)).to(dt).float(), kf)
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), gf)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def packed_attention_two_pass_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                        scale: Optional[float] = None, bk: int = PACKED_KEY_TILE,
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's bf16 body in plain torch: (o, lse).  q * scale * log2(e) rounded
    to q.dtype; pass 1 walks the keys in tiles of ``bk`` (the kernel's key
    width) and keeps the online row max m and sum l in fp32, rescaling l as
    m moves; pass 2 recomputes each tile's scores and accumulates
    bf16(exp2(s - m) * (1/l)) V in fp32; o in q.dtype, lse the fp32 row
    log-sum-exp [B, H, S] of the scaled scores in K1's convention,
    (m + log2 l) * ln 2."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dt = q.dtype
    qs = (q.float() * (scale * _LOG2E)).to(dt).float()
    kf, vf = k.float(), v.float()
    b, s, h, _ = q.shape
    m = torch.full((b, h, s, 1), -math.inf)
    l = torch.zeros((b, h, s, 1))
    tiles = [(k0, min(k0 + bk, kf.shape[1])) for k0 in range(0, kf.shape[1], bk)]
    for k0, k1 in tiles:
        st = torch.einsum("bqhd,bkhd->bhqk", qs, kf[:, k0:k1])
        n = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        l = l * torch.exp2(m - n) + torch.exp2(st - n).sum(dim=-1, keepdim=True)
        m = n
    inv = 1.0 / l
    o = torch.zeros(qs.shape)
    for k0, k1 in tiles:
        st = torch.einsum("bqhd,bkhd->bhqk", qs, kf[:, k0:k1])
        p = (torch.exp2(st - m) * inv).to(dt).float()
        o = o + torch.einsum("bhqk,bkhd->bqhd", p, vf[:, k0:k1])
    lse = ((m + torch.log2(l)) * math.log(2.0))[..., 0]
    return o.to(dt).contiguous(), lse.contiguous()


def packed_backward_from_stats_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                         o: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                                         scale: Optional[float] = None,
                                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's bf16 body (K3's kernels) in plain torch: (dq, dk, dv) of the packed
    forward from its output ``o`` and fp32 ``lse`` [B, H, S].  P = exp2(qs
    k^T - lse * log2(e)) with qs = q * scale * log2(e) rounded to q.dtype;
    delta = rowsum(dO * O) with ``o`` as given (K4's output, in q.dtype),
    where the TPU kernel takes rowsum(dP * P) with fp32 P; P and dS rounded
    to q.dtype before the dV, dQ and dK products; returned in the inputs'
    dtypes."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dt = q.dtype
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.to(dt).float()
    qs = (qf * (scale * _LOG2E)).to(dt).float()
    lse2 = lse.float()[..., None] * _LOG2E
    p = torch.exp2(torch.einsum("bqhd,bkhd->bhqk", qs, kf) - lse2)
    delta = (gf * o.float()).sum(-1).permute(0, 2, 1)[..., None]  # [B, H, S, 1]
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), gf)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def _packed_pad(d: int) -> int:
    """The fp32 packed bodies' head dim padding."""
    return next(x for x in (8, 16, 32, 48, 64) if d <= x)


def _check_packed_shape(b: int, s: int, h: int, d: int, g: int) -> None:
    if d > MAX_PACKED_HEAD_DIM or not 1 <= g <= min(4, 128 // d):
        raise ValueError("packed attention takes D <= 64 and 1 <= g <= min(4, 128 // D) heads "
                         f"a block; got D={d}, g={g}")
    if s % 64:
        raise ValueError(f"packed attention needs S % 64 == 0, got S={s}")


def packed_forward_plan(b: int, s: int, h: int, d: int, dtype: torch.dtype,
                        tensors: Sequence[Tuple[int, Tuple[int, int, int]]] = (),
                        g: Optional[int] = None) -> AttentionPlan:
    """K4's plan for a [B, S, H, D] self-attention (``madm_packed_attention_fwd_plan``
    in csrc/flash_attention_packed.cu makes the same choice).  bf16: K1's TMA
    body in its two-pass mode, K1's rows, warpgroups and D padding for Sq ==
    Sk == S but 64-key tiles (two blocks an SM at D <= 48), one head a consumer
    warpgroup whatever ``g``, raising for tensors TMA cannot address
    (``tensors`` as for ``forward_plan``); float32: the SIMT body, one thread
    a (row, head), ``g`` heads a block (default min(4, 128 // D))."""
    g = min(4, 128 // d) if g is None else g
    _check_packed_shape(b, s, h, d, g)
    if dtype == torch.float32:
        dp = _packed_pad(d)
        return AttentionPlan("K4", "simt", h, dp, 64, 32, launches=(
            Launch("packed_fwd_simt", (s // 64, -(-h // g), b), 64 * g, 4 * 2 * 32 * g * dp),))
    k1 = forward_plan(b, s, s, h, d, dtype, tensors)
    bk, nch = PACKED_KEY_TILE, _chunks(k1.dn)
    smem = 1024 + nch * k1.bq * 128 + 2 * k1.stages * nch * bk * 128 + 8 * (1 + 4 * k1.stages)
    return dataclasses.replace(k1, kernel="K4", body="tma_wgmma_two_pass", bk=bk, launches=tuple(
        dataclasses.replace(l, kernel="packed_fwd_tma", smem=smem) for l in k1.launches))


def packed_backward_plan(b: int, s: int, h: int, d: int, dtype: torch.dtype,
                         ptrs: Sequence[int] = (), g: Optional[int] = None) -> AttentionPlan:
    """K5's plan for a [B, S, H, D] self-attention (``madm_packed_attention_bwd_plan``
    in csrc/flash_attention_bwd.cu makes the same choice).  bf16: K3's
    kernels at Sq == Sk == S (prep, dK/dV, its reduction where split, dQ)
    on the forward's o and lse, raising for tensors TMA cannot address;
    float32: the SIMT dq kernel (statistics, then dQ) and dkdv kernel,
    ``g`` heads a block, its workspace the base-2 log-sum-exp and delta."""
    g = min(4, 128 // d) if g is None else g
    _check_packed_shape(b, s, h, d, g)
    if dtype == torch.float32:
        dp = _packed_pad(d)
        grid, smem = (s // 64, -(-h // g), b), 4 * 2 * 32 * g * dp
        return AttentionPlan("K5", "simt", h, dp, 64, 32, launches=(
            Launch("packed_dq_simt", grid, 64 * g, smem),
            Launch("packed_dkdv_simt", grid, 64 * g, smem + 4 * 2 * g * 32)),
            workspace_bytes=2 * 4 * b * h * s)
    return dataclasses.replace(backward_plan(b, s, s, h, d, dtype, ptrs), kernel="K5")


_packed_backward_plan = functools.lru_cache(maxsize=64)(packed_backward_plan)  # by shape and dtype alone


def _check_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: int) -> None:
    """What K4 and K5 take; raises for anything else."""
    _check(q, k, v)
    b, s, h, d = q.shape
    if k.shape != q.shape:
        raise ValueError(f"packed attention is self-attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    _check_packed_shape(b, s, h, d, g)
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("packed attention needs contiguous [B, S, H, D] q, k, v")
    if q.dtype == torch.bfloat16:  # what packed_forward_plan checks, without building the plan
        _tma_checks("packed_attention", d, h, [(t.data_ptr(), t.stride()[:3]) for t in (q, k, v)], b)


_PACKED_FWD_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                    + [ctypes.c_float, ctypes.c_void_p])


def packed_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                             g: int, with_lse: bool = False,
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel K4 on CUDA tensors (raises for any other): (o, lse) for
    softmax(q k^T * scale) v on a [B, S, H, D] self-attention, ``g`` heads a
    block (``pack_group``); lse the fp32 row log-sum-exp [B, H, S] (bf16
    only, when ``with_lse``; else None)."""
    _check_packed(q, k, v, g)
    if with_lse and q.dtype != torch.bfloat16:
        raise ValueError("packed_attention_forward writes lse in bf16 only (the fp32 backward "
                         "recomputes its statistics)")
    b, s, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    lib, fn = _bind("flash_attention_packed", "madm_packed_attention_fwd", _PACKED_FWD_ARGS)
    with _on_device(q.device):
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(), b, s, h, d, g, float(scale),
                 torch.cuda.current_stream().cuda_stream)
    kernels.check(lib, err, "packed_attention launch")
    packed_attention.launches += 1
    return o, lse


_PACKED_BWD_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
_PACKED_BWD_TMA_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def packed_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
                              scale: float, g: int, o: Optional[torch.Tensor] = None,
                              lse: Optional[torch.Tensor] = None,
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) for the output gradient ``dout`` of ``packed_attention``.
    CPU tensors run ``packed_attention_backward_reference``; CUDA tensors
    launch kernel K5 or raise.  In bf16 K5 starts from the forward's output
    ``o`` and fp32 ``lse`` [B, H, S] (K4's ``with_lse``); without them it
    runs K4 first to get them (and ``packed_attention.launches`` says so).
    In fp32 it recomputes the row statistics, as the TPU kernel does."""
    if q.device.type == "cpu":
        return packed_attention_backward_reference(q, k, v, dout, scale)
    _check_packed(q, k, v, g)
    if dout.shape != q.shape or dout.device != q.device:
        raise ValueError(f"dout {tuple(dout.shape)} must match q {tuple(q.shape)}")
    dout = dout.to(q.dtype).contiguous()
    b, s, h, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.float32:
        lse2 = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        delta = torch.empty_like(lse2)
        lib, fn = _bind("flash_attention_packed_bwd", "madm_packed_attention_bwd", _PACKED_BWD_ARGS)
        with _on_device(q.device):
            err = fn(0, *(t.data_ptr() for t in (q, k, v, dout, lse2, delta, dq, dk, dv)),
                     b, s, h, d, g, float(scale), torch.cuda.current_stream().cuda_stream)
    else:
        if o is None or lse is None:
            o, lse = packed_attention_forward(q, k, v, scale, g, with_lse=True)
        if o.shape != q.shape or o.dtype != q.dtype or lse.shape != (b, h, s) or lse.dtype != torch.float32:
            raise ValueError("packed_attention_backward needs the forward's o and fp32 lse [B, H, S]")
        o, lse = o.contiguous(), lse.contiguous()
        plan = _packed_backward_plan(b, s, h, d, q.dtype, (), g)
        rows = (s * h * d, h * d, d)  # q, k, v were checked with their strides
        _tma_checks("packed_attention_backward", d, h, [(t.data_ptr(), rows) for t in (dout, dq, dk, dv)], b)
        ws = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=q.device)
        lib, fn = _bind("flash_attention_bwd", "madm_packed_attention_bwd_tma", _PACKED_BWD_TMA_ARGS)
        with _on_device(q.device):
            err = fn(*(t.data_ptr() for t in (q, k, v, o, dout, lse, ws, dq, dk, dv)),
                     b, s, h, d, g, float(scale), torch.cuda.current_stream().cuda_stream)
    kernels.check(lib, err, "packed_attention_backward launch")
    packed_attention_backward.launches += 1
    return dq, dk, dv


packed_attention_backward.launches = 0


class PackedAttention(torch.autograd.Function):
    """K4 forward, saving (q, k, v) and, in bf16 on the card, K4's o and lse;
    K5 backward.  On CPU tensors the twins take both roles."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, g: int):
        if q.device.type == "cpu":
            o, lse = packed_attention_reference(q, k, v, scale), None
        else:
            o, lse = packed_attention_forward(q, k, v, scale, g, with_lse=q.dtype == torch.bfloat16)
        ctx.save_for_backward(q, k, v, o if lse is not None else None, lse)
        ctx.scale, ctx.g = scale, g
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = packed_attention_backward(q, k, v, dout, ctx.scale, ctx.g, o, lse)
        return dq, dk, dv, None, None


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: int,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention on [B, S, H, D] with ``g`` heads a block (``pack_group``);
    returns [B, S, H, D] in q.dtype.  CPU tensors run the twins; CUDA tensors
    run kernel K4, and kernel K5 for the gradient when one is needed."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return PackedAttention.apply(q, k, v, float(scale), int(g))
    if q.device.type == "cpu":
        return packed_attention_reference(q, k, v, scale)
    return packed_attention_forward(q, k, v, scale, g)[0]


packed_attention.launches = 0
