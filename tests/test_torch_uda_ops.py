"""The port's train-side ops against the JAX package, on CPU, each fed the
same inputs (made with numpy) and the same random values (the ones the JAX
functions draw from their keys): DACS mask / jitter / blur, palette,
criterion, EMA, the learning-rate schedule, one clipped AdamW update, and
the shipped TrainConfig."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from madm_tpu.ops import dacs as jdacs
from madm_tpu.ops import palette as jpalette
from madm_tpu.train import criterion as jcrit
from madm_tpu.train import ema as jema
from madm_tpu.train import optimizer as jopt
from madm_torch.models.sd.layers import GroupNorm
from madm_torch.ops import dacs, palette
from madm_torch.train import criterion, ema, optimizer
from madm_torch.train.train_step import TrainConfig

ATOL = 1e-6  # fp32 elementwise maths on both sides


def _labels(seed, b=2, h=32, w=32, num_classes=11):
    rng = np.random.default_rng(seed)
    lbl = rng.integers(0, num_classes, size=(b, h, w)).astype(np.int32)
    lbl[:, :4, :5] = 255
    return lbl


# ------------------------------------------------------------------ DACS
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_class_masks_match_jax(seed):
    labels = _labels(seed, num_classes=7)
    labels[1][labels[1] == 3] = 4  # a class present in one sample only
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jdacs.sample_class_masks(key, jnp.asarray(labels), 11))
    scores = np.stack([np.asarray(jax.random.uniform(k, (11,))) for k in jax.random.split(key, 2)])
    out = dacs.class_masks(torch.from_numpy(labels), torch.from_numpy(scores), 11)
    np.testing.assert_array_equal(out.numpy(), ref)


def _jax_jitter_draw(key, s, p):
    k_apply, k_b, k_c, k_s, k_h, k_order = jax.random.split(key, 6)

    def u(k, lo, hi):
        return float(jax.random.uniform(k, (), minval=lo, maxval=hi))

    return dacs.JitterDraw(apply=float(jax.random.uniform(k_apply, ())) > p,
                           brightness=u(k_b, 1 - s, 1 + s), contrast=u(k_c, 1 - s, 1 + s),
                           saturation=u(k_s, 1 - s, 1 + s), hue=u(k_h, -s, s),
                           order=tuple(int(i) for i in jax.random.permutation(k_order, 4)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_color_jitter_matches_jax(seed):
    images = np.random.default_rng(seed).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jdacs.color_jitter(key, jnp.asarray(images), 0.2, 0.0))
    draw = _jax_jitter_draw(key, 0.2, 0.0)
    assert draw.apply
    np.testing.assert_allclose(dacs.color_jitter(torch.from_numpy(images), draw).numpy(), ref,
                               atol=1e-5, rtol=0)  # hsv round trip: a few fp32 ulps of 1


def test_color_jitter_probability_one_never_applies():
    """Jitter applies when U > p: p = 1 turns it off, in both packages."""
    images = np.random.default_rng(5).uniform(size=(1, 8, 8, 3)).astype(np.float32)
    ref = np.asarray(jdacs.color_jitter(jax.random.PRNGKey(5), jnp.asarray(images), 0.2, 1.0))
    np.testing.assert_array_equal(ref, images)
    draw = dacs.draw_color_jitter(torch.Generator().manual_seed(5), 0.2, 1.0)
    assert not draw.apply
    np.testing.assert_array_equal(dacs.color_jitter(torch.from_numpy(images), draw).numpy(), images)


@pytest.mark.parametrize("seed", [0, 3, 4])
def test_gaussian_blur_and_strong_transform_match_jax(seed):
    images = np.random.default_rng(seed).uniform(size=(2, 40, 48, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    ref = np.asarray(jdacs.strong_transform(key, jnp.asarray(images), 0.2, 0.0, True))
    k_apply, k_sigma = jax.random.split(k2)
    blur = dacs.BlurDraw(apply=float(jax.random.uniform(k_apply, ())) > 0.5,
                         sigma=float(jax.random.uniform(k_sigma, (), minval=0.15, maxval=1.15)))
    out = dacs.strong_transform(torch.from_numpy(images), _jax_jitter_draw(k1, 0.2, 0.0), blur)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_forced_blur_matches_jax():
    images = np.random.default_rng(7).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    for seed in range(50):  # the first key whose draw applies a wide blur
        k_apply, k_sigma = jax.random.split(jax.random.PRNGKey(seed))
        sigma = float(jax.random.uniform(k_sigma, (), minval=0.15, maxval=1.15))
        if float(jax.random.uniform(k_apply, ())) > 0.5 and sigma > 0.8:
            break
    ref = np.asarray(jdacs.gaussian_blur(jax.random.PRNGKey(seed), jnp.asarray(images)))
    out = dacs.gaussian_blur(torch.from_numpy(images), dacs.BlurDraw(True, sigma))
    assert np.abs(ref - images).max() > 1e-3  # the blur did apply
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


# --------------------------------------------------------------- palette
def test_palette_tables_and_label_colours_match_jax():
    table = palette.palette_table(palette.DELIVER_11_PALETTE)
    np.testing.assert_array_equal(table, jpalette.palette_table(palette.DELIVER_11_PALETTE))
    np.testing.assert_array_equal(table, jpalette.reg_target_table(palette.DELIVER_11_PALETTE, None))
    labels = _labels(3)
    ref_rgb, ref_valid = jpalette.label_to_rgb(jnp.asarray(labels), jnp.asarray(table))
    rgb, valid = palette.label_to_rgb(torch.from_numpy(labels), torch.from_numpy(table))
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(ref_rgb))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert (rgb.numpy()[labels == 255] == -1).all()  # ignored pixels are black


def test_palette_distance_pseudo_label_matches_jax():
    table = jpalette.palette_table(palette.DELIVER_11_PALETTE)[:11]
    dec = np.random.default_rng(4).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    ref = jpalette.palette_distance_pseudo_label(jnp.asarray(dec), jnp.asarray(table))
    out = palette.palette_distance_pseudo_label(torch.from_numpy(dec), torch.from_numpy(table))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), atol=ATOL, rtol=0)


def test_shipped_palette_is_the_configs():
    from madm_tpu.config import LazyConfig, instantiate

    cfg = LazyConfig.load("config_files/SemSeg/MTMADISE/mtmadise_cityscapes_rgb_to_depth_11.py")
    assert tuple(instantiate(cfg.dataloader.evaluator)[0].palette) == palette.DELIVER_11_PALETTE


# ------------------------------------------------------------- criterion
@pytest.mark.parametrize("lowres,weighted", [(False, False), (True, True)])
def test_cross_entropy_matches_jax(lowres, weighted):
    rng = np.random.default_rng(6)
    hw = 16 if lowres else 32
    logits = rng.normal(size=(2, hw, hw, 11)).astype(np.float32) * 3
    labels = _labels(6)
    weight = rng.uniform(size=(2, 32, 32)).astype(np.float32) if weighted else None
    ref = float(jcrit.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if weight is None else jnp.asarray(weight)))
    out = criterion.cross_entropy(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                  torch.from_numpy(labels),
                                  None if weight is None else torch.from_numpy(weight))
    assert abs(out.item() - ref) <= 1e-6 * abs(ref)


@pytest.mark.parametrize("weight", [1.0, 0.7])
def test_vae_decoder_loss_matches_jax(weight):
    rng = np.random.default_rng(8)
    pred, gt = (rng.normal(size=(2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(2, 64, 64, 1)) > 0.3).astype(np.float32)
    ref = float(jcrit.vae_decoder_loss(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask),
                                       "L1", weight))
    out = criterion.vae_decoder_loss(*(torch.from_numpy(x).permute(0, 3, 1, 2) for x in (pred, gt)),
                                     torch.from_numpy(mask), weight)
    assert abs(out.item() - ref) <= 1e-6 * abs(ref)


# ------------------------------------------------------------------- EMA
class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, 3)
        self.norm = nn.LayerNorm(3)
        self.gn = GroupNorm(32)
        self.prompt = nn.Parameter(torch.zeros(1, 2, 3))


def _tiny_pair(seed):
    rng = np.random.default_rng(seed)
    mods = [_Tiny(), _Tiny()]
    for m in mods:
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32)))
    return mods


def _tree(m):
    return {k: jnp.asarray(v.detach().numpy()) for k, v in m.named_parameters()}


@pytest.mark.parametrize("step", [0, 1, 5, 2000])
def test_ema_update_matches_jax(step):
    e, s = _tiny_pair(step)
    alpha_ref = float(jema.ema_alpha(jnp.float32(step), 0.999))
    assert abs(ema.ema_alpha(step, 0.999) - alpha_ref) <= 1e-7
    ref = jema.update_ema(_tree(e), _tree(s), jnp.float32(alpha_ref))
    ema.update_ema([(e, s)], ema.ema_alpha(step, 0.999))
    for k, v in e.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(ref[k]), atol=ATOL, rtol=0)


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("count", [0, 1, 13, 27, 28, 100, 8888, 8889, 9629, 9630, 9999])
def test_lr_schedule_matches_jax(count):
    ref = float(jopt.lr_schedule(5e-6, 10000)(count))
    assert abs(optimizer.lr_schedule(5e-6, 10000)(count) - ref) <= 1e-6 * ref


def test_clipped_adamw_updates_match_optax():
    """Two updates on the same gradients: the port's groups, schedule and
    clip against the JAX package's ``make_optimizer`` (optax).  Leaf names
    follow the flax convention, so ``wd_mask`` exempts bias / norm scale."""
    torch.manual_seed(0)
    model = _Tiny()
    for p in model.parameters():
        p.data.normal_()
    named = list(model.named_parameters())
    flax_name = {"lin.weight": ("lin", "kernel"), "lin.bias": ("lin", "bias"),
                 "norm.weight": ("norm", "scale"), "norm.bias": ("norm", "bias"),
                 "gn.weight": ("gn", "scale"), "gn.bias": ("gn", "bias"),
                 "prompt": ("prompt", "prompt_embed")}

    def tree(arrays):
        out = {}
        for name, a in arrays.items():
            mod, leaf = flax_name[name]
            out.setdefault(mod, {})[leaf] = jnp.asarray(a)
        return out

    params = tree({n: p.detach().numpy() for n, p in named})
    tx = jopt.make_optimizer(params, base_lr=1e-3, weight_decay=0.05, max_iter=100, grad_clip=0.01)
    opt_state = tx.init(params)
    port = optimizer.make_optimizer(model, named, lr=1e-3, weight_decay=0.05)
    sched = optimizer.lr_schedule(1e-3, 100)
    rng = np.random.default_rng(1)
    for count in range(2):
        grads = {n: (rng.normal(size=tuple(p.shape)) * 0.1).astype(np.float32) for n, p in named}
        updates, opt_state = tx.update(tree(grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        for n, p in named:
            p.grad = torch.from_numpy(grads[n].copy())
        norm = optimizer.clip_by_global_norm_([p for _, p in named], 0.01)
        ref_norm = float(optax.global_norm(tree(grads)))
        assert abs(norm.item() - ref_norm) <= 1e-6 * ref_norm and ref_norm > 0.01  # the clip acts
        for group in port.param_groups:
            group["lr"] = sched(count)
        port.step()
    for n, p in named:
        mod, leaf = flax_name[n]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[mod][leaf]),
                                   atol=1e-7, rtol=1e-6)


def test_shipped_train_config_matches_the_jax_build():
    from madm_tpu.config import LazyConfig, instantiate
    from madm_tpu.train import build_train_config

    cfg = LazyConfig.load("config_files/SemSeg/MTMADISE/mtmadise_cityscapes_rgb_to_depth_11.py")
    for key, val in dict(unet_channels=[8, 8, 16, 16], vae_channels=[8, 8, 16, 16],
                         feature_dims=[3, 8, 8, 16], projection_dim=[8, 8, 8, 8],
                         crop_size=[64, 64], remat=False).items():
        cfg.model[key] = val
    model = instantiate(cfg.model)
    ref = build_train_config(cfg, model.cfg)
    port = TrainConfig()
    for f in dataclasses.fields(port):
        if hasattr(ref, f.name):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.train_palette == tuple(model.cfg.train_palette)
    assert (port.lr, port.weight_decay, port.grad_clip) == (
        cfg.optimizer["lr"], cfg.optimizer["weight_decay"], cfg.train.grad_clip)
