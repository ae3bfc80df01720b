"""The port's mixed-precision train path on CPU: fp32 master parameters cast
to bf16 at each use.  One shipped-config step of a toy model in bf16 compute
against the same step in fp32 compute, from the same masters, batch and
draws (the mix mask all source, so that no near-tie pseudo-label of the
random teacher enters the losses), and the head's bilinear resize of a bf16
tensor that needs a gradient."""

import dataclasses

import numpy as np
import pytest
import torch

from madm_torch.models.daformer import resize_bilinear
from madm_torch.models.madm import MADM, MADMConfig, init_random_, trainable_parameters
from madm_torch.train.loop import synthetic_batches
from madm_torch.train.train_step import TrainConfig, make_train_state, sample_draws, train_step

WIDE_TOY = MADMConfig(num_classes=11, crop_size=(64, 64), unet_channels=(64, 128, 256, 256),
                      vae_channels=(32, 32, 64, 64), feature_dims=(3, 64, 128, 256),
                      projection_dim=(32, 32, 32, 32), compute_dtype=torch.float32)
# bf16 keeps 8 significant bits (2^-9 relative rounding per operation); the
# losses and the gradient norm are means over many pixels: 2^-5 relative
LOSS_RTOL = 2.0 ** -5


@pytest.fixture(scope="module")
def stepped():
    """The two steps on one thread (restored after): the bf16 sums depend
    on the thread count."""
    tc = TrainConfig()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m32 = init_random_(MADM(WIDE_TOY, device="cpu", trainable=True), torch.Generator().manual_seed(0))
        m16 = MADM(dataclasses.replace(WIDE_TOY, compute_dtype=torch.bfloat16), device="cpu",
                   trainable=True)
        m16.load_state_dict(m32.state_dict())
        gen = torch.Generator().manual_seed(5)
        batch = next(synthetic_batches(2, WIDE_TOY.crop_size, WIDE_TOY.num_classes, gen))
        draws = sample_draws(gen, tc, batch["source_label"], WIDE_TOY.num_classes, m32.sem_seg_head)
        draws["mix_mask"] = torch.ones_like(draws["mix_mask"])
        metrics = [train_step(make_train_state(m, tc), batch, draws=draws) for m in (m32, m16)]
    finally:
        torch.set_num_threads(threads)
    return m32, m16, metrics


def test_bf16_model_keeps_fp32_masters(stepped):
    _, m16, _ = stepped
    assert all(p.dtype == torch.float32 for _, p in trainable_parameters(m16))
    assert m16.vae.quant_conv.weight.dtype == torch.bfloat16  # frozen: cast once
    assert m16._compute(m16.unet) is not m16.unet
    feats = {k: torch.ones(2, c, 4, 4, dtype=torch.bfloat16)
             for k, c in zip(WIDE_TOY.in_keys, WIDE_TOY.projection_dim)}
    assert m16.head_forward(feats, train=True).dtype == torch.bfloat16  # the cast copy's


def test_eval_model_needs_no_cast():
    model = MADM(WIDE_TOY, device="cpu")
    assert model._compute(model.unet) is model.unet


def test_bf16_step_losses_match_fp32(stepped):
    _, _, (ref, out) = stepped
    for key, val in ref.items():
        assert abs(out[key] - val) <= LOSS_RTOL * max(abs(val), 1e-3), (key, out[key], val)


def test_bf16_step_gradients_reach_every_trained_tensor(stepped):
    """Every trained tensor gets a finite fp32 gradient through the bf16
    casts, all zero only where fp32's is (tanh(alpha_cond_time) = 0 at step 0
    zeroes time_embed's; alpha_uncond_prompt multiplies the zero
    empty-prompt embedding)."""
    m32, m16, _ = stepped
    ref = dict(trainable_parameters(m32))
    named = trainable_parameters(m16)
    assert [n for n, _ in named] == list(ref)
    for n, p in named:
        assert p.grad is not None and p.grad.dtype == torch.float32, n
        assert torch.isfinite(p.grad).all(), n
        assert bool(p.grad.any()) == bool(ref[n].grad.any()), n


@pytest.mark.parametrize("factor", [2, 8, 32])
def test_bf16_resize_gradient_matches_fp32(factor):
    """The head upsamples s3-s5 embeds 8-32x; the gradient of a bf16 input
    equals the fp32 one up to its final bf16 rounding (2^-8 relative)."""
    rng = np.random.default_rng(factor)
    x = torch.from_numpy(rng.normal(size=(1, 4, 2, 2)).astype(np.float32))
    g = torch.from_numpy(rng.uniform(0.5, 1.0, size=(1, 4, 2 * factor, 2 * factor)).astype(np.float32))
    grads = []
    for dtype in (torch.float32, torch.bfloat16):
        xi = x.to(dtype).detach().requires_grad_(True)
        out = resize_bilinear(xi, (2 * factor, 2 * factor))
        assert out.dtype == dtype
        out.backward(g.to(dtype))
        grads.append(xi.grad.float())
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), rtol=2.0 ** -7, atol=0)
