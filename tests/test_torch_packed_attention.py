"""The packed-head attention path of madm_torch against the JAX package.

K4's and K5's plain twins (``packed_attention_reference``,
``packed_attention_backward_reference``) and the autograd Function that joins
them on CPU tensors, against ``_packed_fwd_impl`` / ``_packed_bwd_impl`` run
in interpret mode (called directly: the jitted entry points cache the
``MADM_FLASH_PACK`` switch at trace time), fp32 at the tolerance JAX's own
tests use; ``pack_group`` against ``_pack_group``; and the UNet's routing of
its self-attentions with ``flash_pack``.  The bf16 bodies' own arithmetic,
``packed_attention_two_pass_reference`` (K4: two passes over key tiles of
the plan's width, online statistics, the normaliser in P before PV) and
``packed_backward_from_stats_reference`` (K5: K3's kernels on K4's o and
lse, delta from the bf16 output), is held against the same JAX kernels in
fp32 and in bf16 at the card's tolerances.  The CUDA kernels themselves are
held against the twins on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.ops.flash_attention import _pack_group, _packed_bwd_impl, _packed_fwd_impl
from madm_torch.ops import attention as attention_mod
from madm_torch.ops.flash_attention import (
    attention_reference,
    pack_group,
    packed_attention,
    packed_attention_backward,
    packed_attention_backward_reference,
    packed_attention_forward,
    packed_attention_reference,
    packed_attention_two_pass_reference,
    packed_backward_from_stats_reference,
    packed_forward_plan,
)

ATOL = 3e-5  # JAX's own packed-kernel tests (tests/test_flash_attention.py)
# bf16 inputs, the card's tolerances (PERF.md section 2): K4's output
# rounding, and for K5 the bf16 rounding of q*scale, P and dS (and here of
# delta's O) before the products, summed over S terms
K4_TOL = 2.0 ** -7
K5_TOL = 2.0 ** -6


def _inputs(b, s=1024, h=8, d=40, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("b", [1, 2])
def test_forward_twin_matches_jax_packed_kernel(b):
    q, k, v, _ = _inputs(b)
    scale = 40 ** -0.5
    want = _packed_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, 3, interpret=True)
    got = packed_attention_reference(*(torch.from_numpy(t) for t in (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("b", [1, 2])
def test_backward_twin_matches_jax_packed_kernel(b):
    q, k, v, g = _inputs(b, seed=1)
    scale = 40 ** -0.5
    want = _packed_bwd_impl(*(jnp.asarray(t) for t in (q, k, v, g)), scale, 3, interpret=True)
    got = packed_attention_backward_reference(*(torch.from_numpy(t) for t in (q, k, v, g)), scale)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=ATOL)


def test_autograd_function_matches_jax_packed_vjp():
    """packed_attention with a gradient on CPU tensors: the twins behind
    ``PackedAttention``, against JAX's packed forward and backward."""
    q, k, v, g = _inputs(1, seed=2)
    scale = 40 ** -0.5
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    out = packed_attention(tq, tk, tv, 3, scale=scale)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    jq, jk, jv, jg = (jnp.asarray(t) for t in (q, k, v, g))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(_packed_fwd_impl(jq, jk, jv, scale, 3, interpret=True)), atol=ATOL)
    for x, w in zip(grads, _packed_bwd_impl(jq, jk, jv, jg, scale, 3, interpret=True)):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=ATOL)
    # the wrapper's CPU backward is the twin
    for x, w in zip(packed_attention_backward(*(torch.from_numpy(t) for t in (q, k, v, g)), scale, 3), grads):
        torch.testing.assert_close(x, w, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["0", "auto"])
def test_pack_group_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("MADM_FLASH_PACK", mode)
    for sq in (64, 256, 512, 1024, 1536, 2048, 4096):
        for sk in (77, 1024, sq):
            for d in (4, 8, 16, 32, 40, 64, 80, 160, 512):
                assert pack_group(sq, sk, d, mode != "0") == _pack_group(sq, sk, d), (sq, sk, d)


def test_bf16_twin_rounds_p_before_pv():
    """In bf16 the twin multiplies the normaliser into P and rounds P
    (the TPU kernel's rounding point); it agrees with the fp32 attention to
    bf16 accuracy."""
    q, k, v, _ = (torch.from_numpy(t).bfloat16() for t in _inputs(1, s=64))
    got = packed_attention_reference(q, k, v).float()
    ref = attention_reference(q.float(), k.float(), v.float())
    assert got.dtype == torch.float32 and (got - ref).abs().max() <= 2.0 ** -7 * max(1.0, ref.abs().max())
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", (q.float() * 40 ** -0.5 * 1.4426950408889634)
                                   .bfloat16().float(), k.float()) * 0.6931471805599453, -1)
    want = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), v.float()).bfloat16().float()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def test_kernel_wrappers_take_cuda_tensors_only():
    q = torch.zeros(1, 1024, 8, 40)
    with pytest.raises(ValueError, match="CUDA"):
        packed_attention_forward(q, q, q, 40 ** -0.5, 3)


@pytest.mark.parametrize("flash_pack", [False, True])
def test_unet_packs_its_large_self_attentions(flash_pack, monkeypatch):
    """At a 32x32 latent (a 256x256 crop) the toy UNet's two down_blocks[0]
    and three up_blocks[3] self-attentions have S=1024 and pack with G=4
    (D=4); cross-attention and the smaller levels never pack.  Packed or
    not, eps and the taps agree (fp32)."""
    from madm_torch.models.sd.unet import UNet2DCondition

    calls = []
    real = attention_mod.packed_attention

    def spy(q, k, v, g, scale=None):
        calls.append((tuple(q.shape), g))
        return real(q, k, v, g, scale=scale)

    monkeypatch.setattr(attention_mod, "packed_attention", spy)
    torch.manual_seed(0)
    plain = UNet2DCondition((32, 64, 128, 128))
    unet = UNet2DCondition((32, 64, 128, 128), flash_pack=flash_pack)
    unet.load_state_dict(plain.state_dict())
    x, t, ctx = torch.randn(1, 4, 32, 32), torch.tensor([10]), torch.randn(1, 77, 768)
    with torch.no_grad():
        eps, taps = unet(x, t, ctx)
        eps0, taps0 = plain(x, t, ctx)
    assert calls == ([((1, 1024, 8, 4), 4)] * 5 if flash_pack else [])
    torch.testing.assert_close(eps, eps0, rtol=1e-4, atol=1e-4)
    for a, b in zip(taps, taps0):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _j(t, dtype=jnp.float32):
    return jnp.asarray(t, dtype)


def _kernel_key_width(b, s, h, d):
    return packed_forward_plan(b, s, h, d, torch.bfloat16).bk


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_pass_form_matches_jax_packed_kernel(b, dtype):
    """K4's two-pass arithmetic (tiles of the kernel's key width, online max
    and sum, then bf16(exp2(s - m) / l) V) against the TPU kernel."""
    q, k, v, _ = _inputs(b, seed=3)
    scale = 40 ** -0.5
    tdt = getattr(torch, dtype)
    want = np.asarray(_packed_fwd_impl(*(_j(t, getattr(jnp, dtype)) for t in (q, k, v)), scale, 3,
                                       interpret=True)).astype(np.float32)
    got, _ = packed_attention_two_pass_reference(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)), scale,
                                                 bk=_kernel_key_width(b, 1024, 8, 40))
    assert got.dtype == tdt
    tol = ATOL if dtype == "float32" else K4_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("s,bk", [(1088, 128), (576, 80), (640, 256)])
def test_two_pass_form_with_a_ragged_last_tile(s, bk):
    """Key tiles that do not divide S (the last one short, as TMA's zero rows
    masked to -inf leave it) give the twin's output."""
    q, k, v = (torch.from_numpy(t) for t in _inputs(1, s=s, h=3, d=40, seed=4)[:3])
    got, _ = packed_attention_two_pass_reference(q, k, v, bk=bk)
    torch.testing.assert_close(got, packed_attention_reference(q, k, v), rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_pass_lse_matches_reference_statistics(dtype):
    """The lse K4 writes for K5, (m + log2 l) ln 2, against the natural-log
    row log-sum-exp of attention_reference's scaled scores; in bf16 q *
    scale * log2(e) is rounded first (chip_smoke.py's K1 lse tolerance)."""
    q, k, v = (torch.from_numpy(t).to(getattr(torch, dtype)) for t in _inputs(2, s=512, seed=5)[:3])
    scale = 40 ** -0.5
    _, lse = packed_attention_two_pass_reference(q, k, v, scale)
    want = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale, -1)
    assert lse.shape == (2, 8, 512) and lse.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8
    assert (lse - want).abs().max() <= tol * max(1.0, want.abs().max())
    # the same statistics give attention_reference's probabilities
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale - lse[..., None])
    if dtype == "float32":
        torch.testing.assert_close(p.sum(-1), torch.ones(2, 8, 512), rtol=0, atol=1e-5)


# (B, S, H, D, G): the UNet's packed shape at S=1024 (H=8, G=3: the last
# group ragged) at B=1 and 2, a full group, and the toy D=8 (G=4)
BWD_SHAPES = [(1, 1024, 8, 40, 3), (2, 1024, 8, 40, 3), (1, 512, 6, 40, 3), (1, 1024, 8, 8, 4)]


def _kernel_path_grads(q, k, v, g, scale):
    """K5's bf16 arithmetic from K4's own output and statistics."""
    o, lse = packed_attention_two_pass_reference(q, k, v, scale, bk=_kernel_key_width(*q.shape))
    return packed_backward_from_stats_reference(q, k, v, o, lse, g, scale)


@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_path_backward_matches_jax_packed_kernel(shape):
    """K5's bf16 body (P from K4's lse, delta = rowsum(dO * O) with K4's bf16
    O) against the TPU kernel (statistics recomputed, delta with fp32 P) on
    the same bf16 inputs: within K5's tolerance of each gradient."""
    b, s, h, d, grp = shape
    q, k, v, g = _inputs(b, s, h, d, seed=6)
    scale = d ** -0.5
    want = _packed_bwd_impl(*(_j(t, jnp.bfloat16) for t in (q, k, v, g)), scale, grp, interpret=True)
    got = _kernel_path_grads(*(torch.from_numpy(t).bfloat16() for t in (q, k, v, g)), scale)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w).astype(np.float32)
        err = np.abs(x.float().numpy() - w).max()
        assert x.dtype == torch.bfloat16 and err <= K5_TOL * np.abs(w).max(), (name, err, np.abs(w).max())


@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_path_backward_matches_twin(shape):
    """The same against K5's fp32 twin on the bf16 inputs (what chip_smoke.py
    holds the card to), and in fp32 to the twin exactly but for summation
    order."""
    b, s, h, d, grp = shape
    q, k, v, g = (torch.from_numpy(t) for t in _inputs(b, s, h, d, seed=7))
    scale = d ** -0.5
    refs = packed_attention_backward_reference(q, k, v, g, scale)
    for x, r in zip(_kernel_path_grads(q, k, v, g, scale), refs):
        torch.testing.assert_close(x, r, rtol=0, atol=ATOL)
    q, k, v, g = (t.bfloat16() for t in (q, k, v, g))
    refs = packed_attention_backward_reference(q.float(), k.float(), v.float(), g.float(), scale)
    for x, r in zip(_kernel_path_grads(q, k, v, g, scale), refs):
        assert (x.float() - r).abs().max() <= K5_TOL * r.abs().max()


def test_delta_from_the_bf16_output_is_the_one_rounding_change():
    """rowsum(dO * O) with K4's bf16 O against the TPU's rowsum(dP * P) with
    fp32 P: they part only by bf16 rounding (a few 2^-8 of the largest
    delta), and with fp32 O they agree to fp32 rounding."""
    q, k, v, g = (torch.from_numpy(t) for t in _inputs(1, s=512, seed=8))
    scale = 40 ** -0.5
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, -1)
    tpu = (torch.einsum("bqhd,bkhd->bhqk", g, v) * p).sum(-1)
    o32, _ = packed_attention_two_pass_reference(q, k, v, scale)
    o16, _ = packed_attention_two_pass_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(), scale)
    for o, tol in ((o32, 1e-5), (o16, 2.0 ** -6)):
        delta = (g * o.float()).sum(-1).permute(0, 2, 1)
        assert (delta - tpu).abs().max() <= tol * tpu.abs().max()


def test_autograd_function_bf16_matches_jax_packed_vjp():
    """packed_attention with a gradient on bf16 CPU tensors (the twins)
    against JAX's packed forward and backward in bf16, at the card's
    tolerances."""
    q, k, v, g = _inputs(1, seed=9)
    scale = 40 ** -0.5
    tq, tk, tv = (torch.from_numpy(t).bfloat16().requires_grad_(True) for t in (q, k, v))
    out = packed_attention(tq, tk, tv, 3, scale=scale)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g).bfloat16())
    jq, jk, jv, jg = (_j(t, jnp.bfloat16) for t in (q, k, v, g))
    want = np.asarray(_packed_fwd_impl(jq, jk, jv, scale, 3, interpret=True)).astype(np.float32)
    assert np.abs(out.detach().float().numpy() - want).max() <= K4_TOL * max(1.0, np.abs(want).max())
    for x, w in zip(grads, _packed_bwd_impl(jq, jk, jv, jg, scale, 3, interpret=True)):
        w = np.asarray(w).astype(np.float32)
        assert np.abs(x.float().numpy() - w).max() <= K5_TOL * np.abs(w).max()
