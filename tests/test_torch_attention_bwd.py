"""Kernel K3's module in the PyTorch port: the backward twin against the JAX
Pallas backward kernel in interpret mode, the CPU autograd Function against
torch autograd through the forward twin, and the wrapper's routing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.ops.flash_attention import _flash_attention_bwd_impl
from madm_torch.ops.flash_attention import (
    attention_backward_reference,
    attention_reference,
    flash_attention,
    flash_attention_backward,
)

# fp32 both sides, different summation orders (XLA dots vs torch einsum):
# relative to the largest gradient entry
RTOL_OF_MAX = 1e-5


def _inputs(sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(2, s, h, d)).astype(np.float32) for s in (sq, sk, sk))
    g = rng.normal(size=(2, sq, h, d)).astype(np.float32)
    return q, k, v, g


def _close(out, ref, name):
    ref = np.asarray(ref)
    err = np.abs(out.detach().numpy() - ref).max()
    assert err <= RTOL_OF_MAX * np.abs(ref).max(), (name, err, np.abs(ref).max())


@pytest.mark.parametrize(
    "sq,sk,h,d",
    [
        (128, 128, 2, 40),   # self-attention, D=40 (padded to 48 in K3)
        (128, 77, 2, 40),    # cross-attention: ragged 77 keys
        (64, 77, 2, 80),
        (64, 64, 2, 160),
    ],
)
def test_backward_twin_matches_jax_pallas_backward(sq, sk, h, d):
    q, k, v, g = _inputs(sq, sk, h, d)
    ref = _flash_attention_bwd_impl(*(jnp.asarray(x) for x in (q, k, v, g)),
                                    scale=d ** -0.5, interpret=True)
    before = flash_attention_backward.launches
    out = attention_backward_reference(*(torch.from_numpy(x) for x in (q, k, v, g)), d ** -0.5)
    assert flash_attention_backward.launches == before  # the twin is not a launch
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        assert o.shape == r.shape and o.dtype == torch.float32
        _close(o, r, name)


@pytest.mark.parametrize("sq,sk,d", [(64, 64, 40), (64, 77, 16)])
def test_autograd_function_matches_torch_autograd_on_cpu(sq, sk, d):
    """flash_attention with a gradient on CPU runs the forward twin and the
    backward twin; torch autograd through the forward twin gives the same."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(sq, sk, 2, d, seed=1))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    out.backward(g)
    auto = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = attention_reference(*auto)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-6, rtol=0)
    ref.backward(g)
    for name, a, b in zip(("dq", "dk", "dv"), leaves, auto):
        _close(a.grad, b.grad.numpy(), name)


def test_no_grad_pass_skips_the_autograd_function():
    q = torch.randn(1, 16, 2, 8, requires_grad=True)
    with torch.no_grad():
        out = flash_attention(q, q, q)
    assert out.grad_fn is None


def test_backward_wrapper_refuses_non_cpu_tensors():
    """Only CPU tensors take the twin; anything else goes to K3, which raises
    here (no CUDA) instead of falling back."""
    q = torch.empty(1, 64, 2, 40, device="meta")
    lse = torch.empty(1, 2, 64, device="meta")
    before = flash_attention_backward.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_backward(q, q, q, q, q, lse, 40 ** -0.5)
    assert flash_attention_backward.launches == before
