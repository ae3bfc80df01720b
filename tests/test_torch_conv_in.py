"""conv_in surgery, the port against the JAX package at toy width in fp32:
``expand_conv_in``'s rules, the pixel-unshuffle tower, the mask_diff
constant and mixed masks, the eval logits of a mask_diff and a
pixel-shuffle model (logits within 1e-4 x max(1, max|logit|)), and the
CLI's snapshot load, which widens the snapshot's conv_in as JAX
``main.py`` does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.checkpoint.converter import expand_conv_in as jax_expand_conv_in
from madm_tpu.models.madm import PixelUnshuffleTower as JaxTower
from madm_torch.checkpoint import expand_conv_in, save_sd_snapshot
from madm_torch.main import load_snapshot_
from madm_torch.models.madm import MADM, MADMConfig, PixelUnshuffleTower, init_random_
from torch_port_toy import TOY, assert_close, toy_pair


@pytest.mark.parametrize("plus,shuffle", [(1, False), (2, False), (0, True), (1, True), (0, False)])
def test_expand_conv_in_matches_jax(plus, shuffle):
    w = torch.randn(32, 4, 3, 3, generator=torch.Generator().manual_seed(plus))
    ref = jax_expand_conv_in(w.numpy().transpose(2, 3, 1, 0), plus, shuffle)
    out = expand_conv_in(w, plus, shuffle)
    assert out.shape[1] == 4 + plus + (64 if shuffle and not plus else 0)
    np.testing.assert_array_equal(out.numpy().transpose(2, 3, 1, 0), ref)


def test_pixel_unshuffle_tower_matches_jax():
    """PixelUnshuffle(8) channel order dy * 8 + dx, conv/BN/SiLU/conv/BN
    on batch statistics."""
    g = torch.Generator().manual_seed(0)
    tower = PixelUnshuffleTower()
    with torch.no_grad():
        for p in tower.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (0.1 if p.ndim == 1 else 1 / 24))
    gray = np.random.default_rng(1).uniform(-1, 1, (2, 64, 96, 1)).astype(np.float32)
    sd = {k: v.numpy() for k, v in tower.state_dict().items()}
    params = {k: ({"kernel": sd[f"{k}.weight"].transpose(2, 3, 1, 0), "bias": sd[f"{k}.bias"]}
                  if k.startswith("conv") else sd[k])
              for k in ("conv1", "conv2", "bn1_scale", "bn1_bias", "bn2_scale", "bn2_bias")}
    ref = JaxTower().apply({"params": params}, jnp.asarray(gray))
    with torch.no_grad():
        out = tower(torch.from_numpy(gray).permute(0, 3, 1, 2))
    assert out.shape == (2, 64, 8, 12)
    assert_close(out.permute(0, 2, 3, 1), ref, 1e-5)


def test_modality_masks_match_jax():
    port, jm, _ = toy_pair(mask_diff="rgb=0.25_Depth=1", input_channel_plus=2)
    images = np.zeros((2, 64, 64, 3), np.float32)
    for modal in ("rgb", "Depth"):
        assert_close(port.modality_mask(images, modal).permute(0, 2, 3, 1), jm.modality_mask(images, modal), 0)
    mix = (np.random.default_rng(2).uniform(size=(2, 64, 64)) > 0.5).astype(np.float32)
    assert_close(port.mixed_modality_mask(torch.from_numpy(mix), "Depth").permute(0, 2, 3, 1),
           jm.mixed_modality_mask(jnp.asarray(mix), "Depth"), 0)
    assert toy_pair()[0].modality_mask(images, "rgb") is None


@pytest.mark.parametrize("variant", [dict(mask_diff="rgb=0_Depth=1", input_channel_plus=1),
                                     dict(concat_pixel_shuffle=True)], ids=["mask_diff", "pixel_shuffle"])
def test_conv_in_surgery_eval_logits_match_jax(variant):
    """The eval pass of a widened conv_in: the target modality's constant
    channel, or the tower's 64 channels."""
    port, jm, jvars = toy_pair(**variant)
    assert port.unet.conv_in.weight.shape[1] == jm.unet_in_channels
    images = np.random.default_rng(6).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.eval_forward)(jvars, images))
    out = port.eval_forward(torch.from_numpy(images)).numpy()
    assert_close(out, ref, 1e-4)


def test_snapshot_load_widens_conv_in(tmp_path):
    """``load_snapshot_`` on a mask_diff model: the 4-channel snapshot's
    conv_in through expand_conv_in, every other UNet weight as written."""
    plain = init_random_(MADM(MADMConfig(**TOY, compute_dtype=torch.float32), device="cpu"),
                         torch.Generator().manual_seed(0))
    save_sd_snapshot(str(tmp_path / "sd"), plain)
    cfg = MADMConfig(**TOY, compute_dtype=torch.float32, mask_diff="rgb=0_Depth=1", input_channel_plus=1)
    model = load_snapshot_(MADM(cfg, device="cpu"), str(tmp_path / "sd"))
    w = plain.unet.conv_in.weight
    assert torch.equal(model.unet.conv_in.weight, expand_conv_in(w, 1))
    assert torch.equal(model.unet.conv_out.weight, plain.unet.conv_out.weight)
