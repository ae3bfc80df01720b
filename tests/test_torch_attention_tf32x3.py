"""K1's fp32 body on the CPU: ``attention_tf32x3_reference`` (the body's
arithmetic in plain torch: the tf32 hi/lo split, three tf32 products for
each fp32 one, the key tiles' online softmax, the key-split partials merged
in split order) against the JAX flash-attention kernel in Pallas interpret
mode; the split's invariants; the merge of 1, 2 and 3 key splits against
one pass; the fp32 ``forward_plan`` at the eval pass's shapes; and the
layout of the transposed V tiles, emulated as the kernel's threads write
them and as its tf32 wgmma reads them.  The CUDA body itself is held to the
twin and to this reference on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FLASH_SHAPES
from madm_torch.kernels import CSRC
from madm_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from madm_torch.ops.flash_attention import (
    SM_COUNT,
    SMEM_LIMIT,
    attention_reference,
    attention_tf32x3_reference,
    forward_plan,
    tf32,
    tf32_split,
)
from madm_torch.tf32_variants import BWD_EDITS, EDITS

ATOL = 2e-5  # fp32 both sides, as tests/test_torch_attention.py holds the twin to the JAX kernel
MERGE_TOL = 1e-6  # of max(1, max|ref|): the split merge only reorders fp32 sums
SHAPES = [pytest.param(b, *s[:4], id=f"B{b}-" + "x".join(map(str, s[:4])))
          for s in FLASH_SHAPES for b in (1, 2)]


def contiguous(b, s, h, d, ptr=0):
    return (ptr, (s * h * d, h * d, d))


def inputs(seed, b, sq, sk, h, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for s in (sq, sk, sk)]


@pytest.mark.parametrize(
    "sq,sk,h,d",
    [
        (64, 64, 2, 40),     # mid-block self-attention width
        (256, 77, 2, 80),    # cross-attention: ragged 77 keys
        (128, 128, 2, 160),  # four 32-key tiles in four key splits
        (64, 64, 1, 512),    # single-head VAE mid-block attention
    ],
)
def test_tf32x3_reference_matches_jax_flash_kernel(sq, sk, h, d):
    q, k, v = inputs(0, 1, sq, sk, h, d)
    ref = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         scale=d ** -0.5, interpret=True))
    plan = forward_plan(1, sq, sk, h, d, torch.float32)
    assert plan.body == "tma_tf32x3"
    out, lse = attention_tf32x3_reference(*(torch.from_numpy(t) for t in (q, k, v)), d ** -0.5,
                                          plan.bk, plan.nsplit)
    assert out.shape == (1, sq, h, d) and lse.shape == (1, h, sq)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    scores = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) * d ** -0.5
    lse_ref = np.log(np.exp(scores - scores.max(-1, keepdims=True)).sum(-1)) + scores.max(-1)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=ATOL * max(1.0, np.abs(lse_ref).max()), rtol=0)


def test_tf32_split_invariants():
    """hi has its low 13 mantissa bits zero and hi + lo == x exactly; for
    normal x (and lo), lo as the body stores it (``tf32(lo)``) is within
    2^-11 of lo, and lo within 2^-11 of x (rounding to the nearest tf32);
    a product of two tf32 words is exact in fp32, so the reference's three
    products carry no rounding of their own."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(size=4000) * 10.0 ** rng.integers(-30, 30, size=4000),
                        [0.0, -0.0, 1.0, -1.5, 3.0e38, -1.0e-38, 1.0e-45, np.pi]]).astype(np.float32)
    xt = torch.from_numpy(x)
    hi, lo = tf32_split(xt)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert torch.equal(hi + lo, xt)
    lo_t = tf32(lo)
    assert ((lo_t.view(torch.int32) & 0x1FFF) == 0).all()
    normal = xt.abs() >= torch.finfo(torch.float32).tiny * 2.0 ** 24  # lo normal too
    assert ((lo - lo_t).abs() <= lo.abs() * 2.0 ** -11)[normal].all()
    assert ((xt - hi).abs() <= xt.abs() * 2.0 ** -11)[normal].all()
    # V's third piece: hi + tf32(lo) + lo2 == x exactly, lo2 itself a tf32 word
    lo2 = tf32(lo - lo_t)
    assert torch.equal((hi.double() + lo_t.double() + lo2.double())[normal], xt.double()[normal])
    # ties away from zero, on both signs
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    assert tf32(ties).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
    a, b = (tf32(torch.from_numpy(rng.normal(size=2000).astype(np.float32))) for _ in range(2))
    assert torch.equal((a * b).double(), a.double() * b.double())


@pytest.mark.parametrize("nsplit", [1, 2, 3])
def test_key_split_merge_equals_one_pass(nsplit):
    """200 keys in 64-key tiles (the last one 8 keys long) cut into 1, 2 or 3
    runs: the merged partials equal one pass over all tiles, o and lse."""
    q, k, v = (torch.from_numpy(t) for t in inputs(2, 2, 96, 200, 2, 40))
    one, lse_one = attention_tf32x3_reference(q, k, v, bk=64, nsplit=1)
    out, lse = attention_tf32x3_reference(q, k, v, bk=64, nsplit=nsplit)
    torch.testing.assert_close(out, one, rtol=0, atol=MERGE_TOL * max(1.0, one.abs().max().item()))
    torch.testing.assert_close(lse, lse_one, rtol=0, atol=MERGE_TOL * max(1.0, lse_one.abs().max().item()))
    torch.testing.assert_close(out, attention_reference(q, k, v), rtol=0, atol=ATOL)


@pytest.mark.parametrize("b,sq,sk,h,d", SHAPES)
def test_fp32_forward_plan_fits_and_fills_the_card(b, sq, sk, h, d):
    plan = forward_plan(b, sq, sk, h, d, torch.float32, [contiguous(b, s, h, d) for s in (sq, sk, sk)])
    assert plan.body == "tma_tf32x3"
    main = plan.launches[0]
    assert main.kernel == "flash_fwd_tf32" and main.smem <= SMEM_LIMIT
    assert main.threads == 128 * plan.warpgroups  # consumer warpgroups only: one of their threads loads
    assert plan.dn >= d and plan.dn % 8 == 0 and 1 <= plan.stages <= 3
    assert main.grid == (-(-sq // plan.bq), h, b * plan.nsplit)
    # the key split: only where the query tiles leave SMs idle, every key tile in one run
    nkt = -(-sk // plan.bk)
    blocks = -(-sq // plan.bq) * h * b
    assert (plan.nsplit > 1) == (blocks < SM_COUNT and nkt > 1)
    runs = [(s * nkt // plan.nsplit, (s + 1) * nkt // plan.nsplit) for s in range(plan.nsplit)]
    assert all(t1 > t0 for t0, t1 in runs) and [t for r in runs for t in range(*r)] == list(range(nkt))
    if plan.nsplit > 1:
        assert [l.kernel for l in plan.launches] == ["flash_fwd_tf32", "flash_fwd_combine"]
        assert plan.workspace_bytes == 4 * plan.nsplit * b * h * sq * (d + 2)  # o, m, l of every run
        assert blocks * plan.nsplit >= min(SM_COUNT, blocks * nkt)
    else:
        assert len(plan.launches) == 1 and plan.workspace_bytes == 0
    assert plan.score_copies == 1  # D=512 splits D over warpgroups of one block, not over blocks
    assert plan.split_d == (d == 512)
    if d == 512:
        assert plan.bq == 64 and plan.warpgroups == 2 and main.blocks >= SM_COUNT
    # 64-key tiles at D=40 and 512 (a 77-key cross-attention is two, the
    # second masked), 32 at D=80 and 160, where q and k take three pieces
    assert plan.bk == (64 if plan.dn in (40, 512) else 32)


def test_fp32_plan_takes_simt_only_where_tma_cannot_address():
    good = [contiguous(2, 64, 2, 40)] * 3
    assert forward_plan(2, 64, 64, 2, 40, torch.float32, good).body == "tma_tf32x3"
    faults = {
        "base": (8, (64 * 80, 80, 40)),
        "seq stride": (0, (64 * 82, 82, 40)),
        "head stride": (0, (64 * 84, 84, 42)),
        "batch stride": (0, (64 * 80 + 2, 80, 40)),
    }
    for name, bad in faults.items():
        plan = forward_plan(2, 64, 64, 2, 40, torch.float32, [good[0], bad, good[2]])
        assert plan.body == "simt", name
    # a stride that is never stepped does not matter: B=1, H=1
    assert forward_plan(1, 64, 64, 1, 40, torch.float32, [(0, (7, 40, 3))] * 3).body == "tma_tf32x3"
    for d in (4, 12, 36, 300, 512):
        assert forward_plan(1, 64, 64, 2, d, torch.float32).body == "tma_tf32x3", d
    for d in (1, 6, 34, 510):
        assert forward_plan(1, 64, 64, 2, d, torch.float32).body == "simt", d


def swizzled(row, col):
    """Word index of (row, 32-bit column) in a 128-byte-swizzled tile of
    128-byte rows (the 16-byte unit XORed with row % 8), as TMA writes a
    [rows][32] fp32 box and as a K-major wgmma descriptor reads it."""
    return row * 32 + (((col // 4) ^ (row % 8)) * 4) + col % 4


@pytest.mark.parametrize("dvw,bk,cg", [(40, 64, 1), (16, 80, 1), (160, 32, 1), (64, 64, 2)])
def test_transposed_v_tiles_as_the_kernel_writes_and_reads_them(dvw, bk, cg):
    """split_v (csrc/flash_fwd_tf32.cuh) on a raw V item, emulated task by
    task with its addressing, then O = P V formed as the tf32 wgmma forms it:
    the A fragments straight from the score accumulators (a0..a3 = keys 2tg,
    2tg, 2tg+1, 2tg+1 of rows g, g+8, g, g+8), B read K-major from the Vt
    tiles at the descriptor's k-step offsets.  Equal to P V in fp64."""
    rng = np.random.default_rng(dvw + bk)
    vb, kc = -(-dvw // 32), -(-bk // 32)
    v = rng.normal(size=(cg, bk, dvw))
    p = rng.uniform(size=(64, bk))
    raw = np.zeros((cg * vb * bk * 32,))  # [group][box][keys][32 columns], swizzled
    for w in range(cg):
        for key in range(bk):
            for c in range(dvw):
                raw[(w * vb + c // 32) * bk * 32 + swizzled(key, c % 32)] = v[w, key, c]
    group = kc * dvw * 32  # words of one group's Vt tile
    vt = np.full((cg * group,), np.nan)
    quads, octs = dvw // 4, bk // 8
    for e in range(cg * octs * 2 * quads):  # the kernel's tasks: 4 even or odd keys x 4 columns each
        cq, par, o8, w = e % quads, (e // quads) % 2, (e // (2 * quads)) % octs, e // (2 * quads * octs)
        qq, src = cq % 8, ((w * vb + cq // 8) * bk + 8 * o8) * 32
        r = [raw[src + (par + 2 * i) * 32 + (qq ^ (par + 2 * i)) * 4:][:4] for i in range(4)]
        dst, u = w * group + (o8 // 4) * dvw * 32, 2 * (o8 % 4) + par
        for m in range(4):
            n = 4 * cq + m
            at = dst + n * 32 + (u ^ (n % 8)) * 4
            vt[at:at + 4] = [r[i][m] for i in range(4)]
    for w in range(cg):
        out = np.zeros((64, dvw))
        for kk in range(bk // 8):
            # B (k8 x N) at the descriptor's start: chunk kk // 4, 32 bytes a k-step
            base = w * group + (kk // 4) * dvw * 32
            b_op = np.array([[vt[base + n * 32 + (((((kk % 4) * 8 + c) // 4) ^ (n % 8)) * 4) + c % 4]
                              for n in range(dvw)] for c in range(8)])
            assert not np.isnan(b_op).any()  # every word the wgmma reads was written
            a_op = np.zeros((64, 8))
            for row in range(64):
                for tg in range(4):  # the accumulator's keys 2tg, 2tg+1 are A's columns tg, tg+4
                    a_op[row, tg] = p[row, 8 * kk + 2 * tg]
                    a_op[row, tg + 4] = p[row, 8 * kk + 2 * tg + 1]
            out += a_op @ b_op
        np.testing.assert_allclose(out, p @ v[w], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(EDITS) + sorted(BWD_EDITS))
def test_tf32_variant_edits_find_their_lines(name):
    """Each build of ``madm_torch.tf32_variants`` (the kept body, fewer tf32
    pieces, the one-product controls, K3's delta and SIMT builds) edits
    lines that stand once in csrc/flash_fwd_tf32.cuh (K1's) or
    csrc/flash_bwd_tf32.cuh (K3's), and the edited text differs from the
    source (a variant that changed nothing would compare the body with
    itself)."""
    src = (CSRC / ("flash_bwd_tf32.cuh" if name in BWD_EDITS else "flash_fwd_tf32.cuh")).read_text()
    text = src
    for old, new in {**EDITS, **BWD_EDITS}[name]:
        assert src.count(old) == 1, old
        text = text.replace(old, new)
    assert (text == src) == (name == "kept")
