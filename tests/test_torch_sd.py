"""SD-v1.4 modules of the PyTorch port against the JAX package at toy
widths: GroupNorm, the noise schedule and shared noise, the timestep
embedding, the UNet and the VAE encoder/decoder.  JAX weights go through
``state_dict_from_jax``; inputs come from numpy; both sides run in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.models.sd import scheduler as jax_scheduler
from madm_tpu.models.sd.layers import timestep_embedding as jax_timestep_embedding
from madm_tpu.models.sd.unet import UNet2DCondition as JaxUNet
from madm_tpu.models.sd.vae import Decoder as JaxDecoder
from madm_tpu.models.sd.vae import Encoder as JaxEncoder
from madm_tpu.ops.group_norm import group_norm as jax_group_norm
from madm_torch.checkpoint.from_jax import state_dict_from_jax
from madm_torch.models.sd import scheduler
from madm_torch.models.sd.layers import timestep_embedding
from madm_torch.models.sd.unet import UNet2DCondition
from madm_torch.models.sd.vae import AutoencoderKL
from madm_torch.ops.group_norm import group_norm

UNET_CH = (32, 64, 128, 128)
VAE_CH = (32, 32, 64, 64)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def rel_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def submodule_state(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("eps,act", [(1e-5, None), (1e-6, "silu"), (1e-5, "relu")])
def test_group_norm_matches_jax(eps, act):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 6, 5, 64)) * 3 + 1).astype(np.float32)
    scale, bias = rng.normal(size=64).astype(np.float32), rng.normal(size=64).astype(np.float32)
    ref = np.asarray(jax_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                    32, eps, act))
    out = group_norm(nchw(x), torch.from_numpy(scale), torch.from_numpy(bias), 32, eps, act)
    np.testing.assert_allclose(nhwc(out), ref, atol=2e-5, rtol=0)


def test_scheduler_matches_jax():
    for hw in ((8, 8), (64, 64)):  # shared noise: bit-equal
        np.testing.assert_array_equal(scheduler.shared_noise(*hw), jax_scheduler.shared_noise(*hw))
    np.testing.assert_array_equal(scheduler.alphas_cumprod(), jax_scheduler.alphas_cumprod())
    rng = np.random.default_rng(1)
    lat, noise = (rng.normal(size=(3, 8, 8, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 37, 999], np.int32)
    ref = np.asarray(jax_scheduler.add_noise(jnp.asarray(lat), jnp.asarray(noise), jnp.asarray(t)))
    out = scheduler.add_noise(nchw(lat), nchw(noise), torch.from_numpy(t).long())
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-6, rtol=0)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 37, 999], np.int32)
    ref = np.asarray(jax_timestep_embedding(jnp.asarray(t), 320))
    # cos/sin of arguments up to ~1e3, whose fp32 spacing is 6e-5
    np.testing.assert_allclose(timestep_embedding(torch.from_numpy(t), 320).numpy(), ref,
                               atol=2e-4, rtol=0)


def test_unet_matches_jax():
    """eps and the 'after' taps 5/8/11, with the residual time embedding."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    t = np.array([0, 37], np.int32)
    ctx = rng.normal(size=(2, 77, 768)).astype(np.float32)
    res_t = (rng.normal(size=(2, 1, UNET_CH[0] * 4)) * 0.1).astype(np.float32)
    jm = JaxUNet(unet_block_indices=(5, 8, 11), block_out_channels=UNET_CH)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(ctx))["params"]
    ref_eps, ref_taps = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(res_t))

    unet = UNet2DCondition(UNET_CH, (5, 8, 11))
    unet.load_state_dict(submodule_state(state_dict_from_jax({"params": {"unet": params}}),
                                         "unet."))
    with torch.no_grad():
        eps, taps = unet(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx),
                         torch.from_numpy(res_t))
    assert rel_err(nhwc(eps), np.asarray(ref_eps)) < 1e-5
    assert [tuple(tp.shape) for tp in taps] == [(2, 128, 2, 2), (2, 64, 4, 4), (2, 32, 8, 8)]
    for tp, rt in zip(taps, ref_taps):
        assert rel_err(nhwc(tp), np.asarray(rt)) < 1e-5


def test_vae_encoder_decoder_match_jax():
    """``encode`` = the JAX Encoder's posterior mean x scaling factor;
    ``decode`` = the JAX Decoder, through diffusers' AutoencoderKL layout."""
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, size=(1, 64, 64, 3)).astype(np.float32)
    lat = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    je, jd = JaxEncoder(block_out_channels=VAE_CH), JaxDecoder(block_out_channels=VAE_CH)
    pe = jax.jit(je.init)(jax.random.PRNGKey(1), jnp.asarray(img))["params"]
    pd = jax.jit(jd.init)(jax.random.PRNGKey(2), jnp.asarray(lat))["params"]
    ref_lat, _ = jax.jit(lambda p, a: je.apply({"params": p}, a))(pe, jnp.asarray(img))
    ref_img, _ = jax.jit(lambda p, a: jd.apply({"params": p}, a))(pd, jnp.asarray(lat))

    vae = AutoencoderKL(VAE_CH)
    sd = state_dict_from_jax({"params": {"vae_encoder": pe, "vae_decoder": pd}})
    vae.load_state_dict(submodule_state(sd, "vae."))
    with torch.no_grad():
        out_lat, out_img = vae.encode(nchw(img)), vae.decode(nchw(lat))
    assert rel_err(nhwc(out_lat), np.asarray(ref_lat)) < 1e-5
    assert rel_err(nhwc(out_img), np.asarray(ref_img)) < 1e-5
