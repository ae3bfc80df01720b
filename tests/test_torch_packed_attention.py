"""The packed-head attention path of madm_torch against the JAX package.

K4's and K5's plain twins (``packed_attention_reference``,
``packed_attention_backward_reference``) and the autograd Function that joins
them on CPU tensors, against ``_packed_fwd_impl`` / ``_packed_bwd_impl`` run
in interpret mode (called directly: the jitted entry points cache the
``MADM_FLASH_PACK`` switch at trace time), fp32 at the tolerance JAX's own
tests use; ``pack_group`` against ``_pack_group``; and the UNet's routing of
its self-attentions with ``flash_pack``.  The CUDA kernels themselves are
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
)

ATOL = 3e-5  # JAX's own packed-kernel tests (tests/test_flash_attention.py)


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
