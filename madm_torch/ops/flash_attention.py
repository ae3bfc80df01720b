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
``flash_attention.launches`` and ``flash_attention_backward.launches`` count
kernel launches.  ``forward_plan`` and ``backward_plan`` state, as pure
functions of shape, strides and dtype, how the two kernels launch (body,
tiles, grids, shared memory, the dK/dV split, K3's workspace) and raise for
bf16 input that their TMA bodies cannot address; the wrappers go by them,
and ``split_dkdv_reference`` is the plain form of K3's split dK/dV sum.

The packed-head path (``packed_attention``) is the same function for the
self-attentions that ``pack_group`` picks when packing is on
(``MADMConfig.flash_pack``): kernel K4 ``csrc/flash_attention_packed.cu``
(replaces ``_packed_attn_kernel``) and K5 ``csrc/flash_attention_packed_bwd.cu``
(replaces ``_packed_bwd_kernel``) take G heads a block, with the TPU kernels'
rounding points; their twins are ``packed_attention_reference`` and
``packed_attention_backward_reference``.  K5 recomputes the row statistics
from q, k, v and dO, as the TPU kernel does, so nothing but the inputs is
saved for it.  ``packed_attention.launches`` and
``packed_attention_backward.launches`` count their launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
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
    """How K1 or K3 runs a call: ``body`` "tma_wgmma" (bf16) or "simt"
    (float32); ``dn`` the head dim padded for the tensor cores; ``bq`` and
    ``bk`` the query rows and keys of a block's tiles (for K3, those of the
    dK/dV kernel; ``bk_dq``/``bq_dq`` those of the dQ kernel); ``warpgroups``
    the consumer warpgroups of the main kernel and ``split_d`` whether they
    share rows and split D (the D=512 VAE attention); ``nsplit`` the splits
    of K3's query loop; ``launches`` every kernel launched, in order;
    ``workspace_bytes`` K3's scratch (its ``delta`` argument)."""
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
        return all(l.blocks >= SM_COUNT for l in self.launches if l.kernel not in ("bwd_prep", "dkdv_reduce"))

    @property
    def score_copies(self) -> int:
        """How many blocks of the main kernel compute each (query, key) score:
        its grid's y extent over the heads (a kernel that split D's output
        columns over blocks would recompute the scores in each)."""
        return self.launches[0 if self.kernel == "K1" else 1].grid[1] // self.heads


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


def forward_plan(b: int, sq: int, sk: int, h: int, d: int, dtype: torch.dtype,
                 tensors: Sequence[Tuple[int, Tuple[int, int, int]]] = ()) -> AttentionPlan:
    """K1's plan (``madm_flash_attention_fwd_plan`` in csrc/flash_attention.cu
    makes the same choice): bf16 runs the TMA body, raising for tensors TMA
    cannot address (``tensors``: (base address, (batch, seq, head) strides)
    of q, k, v); float32 runs the SIMT body."""
    if dtype == torch.float32:
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
    (``madm_flash_attention_bwd_plan`` in csrc/flash_attention_bwd.cu makes
    the same choice).  bf16: the prep kernel, the dK/dV kernel over 128-key
    tiles (64 at D=160), its query loop split until SM_COUNT blocks run (at least two q
    tiles a split; fp32 partials, then a reduction in split order), and the
    dQ kernel; float32: the SIMT body."""
    if dtype == torch.float32:
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


_FWD_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float, with_lse: bool = True,
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel K1 on CUDA tensors (raises for any other): (o, lse), lse the
    fp32 row log-sum-exp [B, H, Sq] of the scaled scores, or None unless
    ``with_lse``.  bf16 tensors must be what ``forward_plan`` takes."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if q.dtype == torch.bfloat16:
        _tma_checks("flash_attention", d, h, [(t.data_ptr(), t.stride()[:3]) for t in (q, k, v)], b)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    if o.numel() == 0:
        return o, lse
    lib, fn = _bind("flash_attention", "madm_flash_attention_fwd", _FWD_ARGS)
    with _on_device(q.device):
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(), b, sq, sk, h, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                 float(scale), torch.cuda.current_stream().cuda_stream)
    kernels.check(lib, err, "flash_attention launch")
    flash_attention.launches += 1
    return o, lse


_BWD_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, g: torch.Tensor, lse: Optional[torch.Tensor],
                             scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) for the output gradient ``g`` of ``o = attention(q, k, v)``.
    CPU tensors run ``attention_backward_reference`` (``o`` and ``lse`` are
    not needed); CUDA tensors launch kernel K3 with the forward's ``o`` and
    fp32 ``lse`` [B, H, Sq]: D <= 160, and in bf16 what ``backward_plan``
    takes (D % 8 == 0, 16-byte aligned storage), else it raises."""
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
    plan = _backward_plan(b, sq, sk, h, d, q.dtype)
    if q.dtype == torch.bfloat16:
        backward_plan(b, sq, sk, h, d, q.dtype, [t.data_ptr() for t in (q, k, v, g, dq, dk, dv)])
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # K3's workspace: the fp32 delta [B, H, Sq], or the bf16 body's scratch
    delta = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=q.device)
    lib, fn = _bind("flash_attention_bwd", "madm_flash_attention_bwd", _BWD_ARGS)
    with _on_device(q.device):
        err = fn(_DTYPES[q.dtype], *(t.data_ptr() for t in (q, k, v, o, g, lse, delta, dq, dk, dv)),
                 b, sq, sk, h, d, float(scale), torch.cuda.current_stream().cuda_stream)
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
_LOG2E = 1.4426950408889634
MAX_PACKED_HEAD_DIM = 64  # 128 // D >= 2: wider heads never pack


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


def _check_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: int) -> None:
    """What K4 and K5 take; raises for anything else."""
    _check(q, k, v)
    b, s, h, d = q.shape
    if k.shape != q.shape:
        raise ValueError(f"packed attention is self-attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if d > MAX_PACKED_HEAD_DIM or not 1 <= g <= min(4, 128 // d):
        raise ValueError("packed attention takes D <= 64 and 1 <= g <= min(4, 128 // D) heads "
                         f"a block; got D={d}, g={g}")
    if s % 64:
        raise ValueError(f"packed attention needs S % 64 == 0, got S={s}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("packed attention needs contiguous [B, S, H, D] q, k, v")
    if q.dtype == torch.bfloat16 and (d % 8 or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError(f"packed attention in bf16 needs D % 8 == 0 and 16-byte aligned tensors (D={d})")


def packed_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                             g: int) -> torch.Tensor:
    """Kernel K4 on CUDA tensors (raises for any other): softmax(q k^T *
    scale) v for [B, S, H, D] self-attention, ``g`` heads a block."""
    _check_packed(q, k, v, g)
    b, s, h, d = q.shape
    o = torch.empty_like(q)
    lib = kernels.load("flash_attention_packed")
    fn = lib.madm_packed_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 b, s, h, d, g, float(scale), stream)
    kernels.check(lib, err, "packed_attention launch")
    packed_attention.launches += 1
    return o


def packed_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
                              scale: float, g: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) for the output gradient ``dout`` of ``packed_attention``.
    CPU tensors run ``packed_attention_backward_reference``; CUDA tensors
    launch kernel K5, which recomputes the row statistics, or raise."""
    if q.device.type == "cpu":
        return packed_attention_backward_reference(q, k, v, dout, scale)
    _check_packed(q, k, v, g)
    if dout.shape != q.shape or dout.device != q.device:
        raise ValueError(f"dout {tuple(dout.shape)} must match q {tuple(q.shape)}")
    dout = dout.to(q.dtype).contiguous()
    if q.dtype == torch.bfloat16 and dout.data_ptr() % 16:
        raise ValueError("packed_attention_backward: bf16 dout must be 16-byte aligned")
    b, s, h, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse2 = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse2)
    lib = kernels.load("flash_attention_packed_bwd")
    fn = lib.madm_packed_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[q.dtype], *(t.data_ptr() for t in (q, k, v, dout, lse2, delta, dq, dk, dv)),
                 b, s, h, d, g, float(scale), stream)
    kernels.check(lib, err, "packed_attention_backward launch")
    packed_attention_backward.launches += 1
    return dq, dk, dv


packed_attention_backward.launches = 0


class PackedAttention(torch.autograd.Function):
    """K4 forward saving (q, k, v); K5 backward.  On CPU tensors the twins
    take both roles."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, g: int):
        if q.device.type == "cpu":
            o = packed_attention_reference(q, k, v, scale)
        else:
            o = packed_attention_forward(q, k, v, scale, g)
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.g = scale, g
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = packed_attention_backward(q, k, v, dout, ctx.scale, ctx.g)
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
    return packed_attention_forward(q, k, v, scale, g)


packed_attention.launches = 0
