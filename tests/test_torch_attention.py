"""Kernel K1's module in the PyTorch port: its CPU twin against the JAX
flash-attention kernel run in Pallas interpret mode, and the wrapper's
routing (twin for CPU tensors, kernel or an error for anything else)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from madm_torch import kernels
from madm_torch.ops.attention import dot_product_attention
from madm_torch.ops.flash_attention import flash_attention

ATOL = 2e-5  # fp32 both sides; the JAX kernel's own test holds it to XLA at this tolerance


@pytest.mark.parametrize(
    "sq,sk,h,d",
    [
        (64, 64, 2, 40),     # mid-block self-attention width
        (256, 77, 2, 80),    # cross-attention: ragged 77 keys
        (128, 128, 2, 160),
        (64, 64, 1, 512),    # single-head VAE mid-block attention
    ],
)
def test_twin_matches_jax_flash_kernel(sq, sk, h, d):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(1, s, h, d)).astype(np.float32) for s in (sq, sk, sk))
    ref = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         scale=d ** -0.5, interpret=True))
    before = flash_attention.launches
    out = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert out.shape == (1, sq, h, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    assert flash_attention.launches == before  # the twin is not a launch


def test_wrapper_refuses_non_cpu_tensors():
    """Only a CPU tensor takes the twin: any other device goes to the kernel
    path, which raises here instead of falling back."""
    q = torch.empty(1, 64, 2, 40, device="meta")
    before = flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    assert flash_attention.launches == before


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """The kernel modules import without nvcc; building is deferred to the
    first CUDA call and fails loudly on a host without the toolkit."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_loaded", {})
    if not kernels.library_path("flash_attention").name.startswith("libflash_attention-"):
        raise AssertionError("library name is not keyed by the kernel")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load("flash_attention")
