"""The port's UDA train step against the JAX package's, on CPU, at toy width.

One toy MADM (the verify recipe without LoRA: crop 64x64, fp32) is
initialised by the JAX package; its variables go through
``state_dict_from_jax`` into a trainable port model.  The JAX
``make_train_step`` (shipped TrainConfig, but colour jitter off with p = 1,
blur off, the teacher timestep fixed at 60, and the head's dropout set to 0
on the test's own object) is compiled once and takes one step; the port takes
the same step with the DACS mask the JAX step drew.  The head's conv_seg is
scaled up so that the teacher is confident on part of the image and the
pseudo-weighted terms are not zero.  Also here: the train-mode head alone,
the unported flags, and the draws' determinism.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.models.daformer import DAFormerHead as JaxHead
from madm_tpu.models.madm import MADM as JaxMADM
from madm_tpu.models.madm import MADMConfig as JaxMADMConfig
from madm_tpu.ops import dacs as jdacs
from madm_tpu.train import (
    TrainConfig as JaxTrainConfig,
    make_optimizer,
    make_train_state,
    make_train_step,
    split_trainable,
)
from madm_torch.checkpoint.from_jax import state_dict_from_jax
from madm_torch.models.daformer import DAFormerHead
from madm_torch.models.madm import MADM, MADMConfig
from madm_torch.ops import dacs, palette
from madm_torch.train import train_step as ts
from madm_torch.train.train_step import TrainConfig, make_train_state as port_state, train_step

TOY = dict(num_classes=11, crop_size=(64, 64), unet_channels=(32, 64, 128, 128),
           vae_channels=(32, 32, 64, 64), feature_dims=(3, 32, 64, 128),
           projection_dim=(32, 32, 32, 32))
STEP_KW = dict(color_jitter_probability=1.0, blur=False, denoise_timestep_range=(60, 60))
LR = 1e-3  # the first update (lr 6.7e-5 after warmup scaling) stands far above fp32 rounding
SEG_SCALE = 40.0  # conv_seg x40: about half the teacher's pixels pass the 0.968 threshold
# fp32 on both sides through three backbone passes and two backward passes
# (XLA vs torch summation orders): losses and the gradient norm to 1e-4
# relative (measured: losses 6e-7, gradient norm 3.3e-5).  Gradients, read from Adam's first moment
# (0.1 * clipped g): an activation within fp32 noise of 0 flips its ReLU's
# mask, moving a channel's summed gradient by ~1/(pixels), and train-mode BN
# spreads that over the channel; measured over the whole step, the worst
# entry is off by 4.2e-4 of the largest gradient entry and the worst tensor
# by 2.7e-3 in l2.  Held to 2e-3 of the largest entry, and to 1e-2 in l2 for
# every tensor whose gradient is more than fp32 noise (largest entry above
# 1e-3 of the global one; at toy width a per-channel bias before a GroupNorm
# of one channel per group has a true gradient of 0).  The first AdamW
# update is lr * (g / (|g| + eps) + wd * w): it may differ by 1% of lr plus
# lr * |g_port - g_jax| / eps, its largest sensitivity to g (clipped entries
# of ~1e-9 sit next to eps = 1e-8).
RTOL = 1e-4
GRAD_ATOL_OF_MAX = 2e-3
GRAD_L2_RTOL = 1e-2
ADAM_EPS = 1e-8


def _batch():
    rng = np.random.default_rng(0)
    labels = np.full((2, 64, 64), 5, np.int32)
    yy, xx = np.mgrid[:64, :64]
    for b in range(2):
        for c in rng.integers(0, 11, size=5):
            cy, cx, r = rng.uniform(0, 64, 2).tolist() + [rng.uniform(6, 20)]
            labels[b][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = c
    labels[:, 3:9, 40:50] = 255
    return {"source_rgb": rng.uniform(size=(2, 64, 64, 3)).astype(np.float32),
            "source_label": labels,
            "target_second_modality": rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def stepped():
    jm = JaxMADM(JaxMADMConfig(**TOY, compute_dtype=jnp.float32,
                               train_palette=palette.DELIVER_11_PALETTE))
    jm.head = jm.head.clone(dropout_ratio=0.0)
    variables = jm.init_params(jax.random.PRNGKey(0))
    params = variables["params"]
    conv_seg = dict(params["head"]["conv_seg"], kernel=params["head"]["conv_seg"]["kernel"] * SEG_SCALE)
    variables["params"] = dict(params, head=dict(params["head"], conv_seg=conv_seg))
    tc = JaxTrainConfig(**STEP_KW)
    trainable, _ = split_trainable(variables)
    tx = make_optimizer(trainable, base_lr=LR, max_iter=tc.max_iter)
    state = make_train_state(jm, variables, tx)
    batch = _batch()
    rng = jax.random.PRNGKey(42)
    new_state, metrics = jax.jit(make_train_step(jm, tc, tx))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    adam = [x for x in jax.tree_util.tree_leaves(new_state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(x, "mu")]
    assert len(adam) == 1
    mask = jdacs.sample_class_masks(jax.random.split(rng, 15)[0],
                                    jnp.asarray(batch["source_label"]), 11)

    model = MADM(MADMConfig(**TOY, compute_dtype=torch.float32), device="cpu", trainable=True)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pstate = port_state(model, TrainConfig(lr=LR, **STEP_KW))
    draws = {"mix_mask": torch.from_numpy(np.array(mask)),
             "jitter": dacs.JitterDraw(False, 1.0, 1.0, 1.0, 0.0, (0, 1, 2, 3)),
             "blur": None, "t_pl": 60, "dropout": [None, None, None]}
    port_metrics = train_step(pstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                              draws=draws)
    grads = {n: pstate.optimizer.state[p]["exp_avg"] / 0.1 for n, p in model.named_parameters()
             if p.requires_grad}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "port_metrics": port_metrics,
            "grads": grads,
            "jax_grads": {k: v / 0.1 for k, v in state_dict_from_jax({"params": adam[0].mu}).items()},
            "new": state_dict_from_jax({"params": new_state.params, "ema": new_state.ema,
                                        "state": new_state.state}),
            "before": before, "model": model, "pstate": pstate}


def test_step_losses_and_grad_norm_match_jax(stepped):
    ref, out = stepped["metrics"], stepped["port_metrics"]
    assert set(ref) == set(out) - {"step_ms"}
    assert 0.1 < ref["pseudo_val"] < 0.9  # the pseudo-weighted terms are live
    assert ref["vae_decoder_target_loss"] > 0
    for key, val in ref.items():
        assert abs(out[key] - val) <= RTOL * max(abs(val), 1e-3), (key, out[key], val)
    assert stepped["pstate"].step == 1


PREFIXES = ["unet.", "prompt.", "feature_projections.", "sem_seg_head."]


@pytest.mark.parametrize("prefix", PREFIXES)
def test_gradients_match_jax(stepped, prefix):
    grads, ref = stepped["grads"], stepped["jax_grads"]
    keys = [k for k in grads if k.startswith(prefix)]
    assert keys and set(grads) == set(ref)  # the same parameters train
    gmax = max(r.abs().max().item() for r in ref.values())
    for k in keys:
        err = (grads[k] - ref[k]).abs().max().item()
        assert err <= GRAD_ATOL_OF_MAX * gmax, (k, err, gmax)
        if ref[k].abs().max().item() > 1e-3 * gmax:
            rel = ((grads[k] - ref[k]).norm() / ref[k].norm()).item()
            assert rel <= GRAD_L2_RTOL, (k, rel)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_updated_parameters_match_jax(stepped, prefix):
    lr0 = stepped["pstate"].schedule(0)
    new, state, before = stepped["new"], stepped["model"].state_dict(), stepped["before"]
    keys = [k for k in stepped["grads"] if k.startswith(prefix)]
    for k in keys:
        allowed = 1e-2 * lr0 + lr0 * (stepped["grads"][k] - stepped["jax_grads"][k]).abs() / ADAM_EPS
        excess = ((state[k] - new[k]).abs() - allowed).max().item()
        assert excess <= 0, (k, excess)
        assert not torch.equal(state[k], before[k]), k  # the step did update it


def test_frozen_parameters_unchanged(stepped):
    state, before = stepped["model"].state_dict(), stepped["before"]
    for k in state:
        if k.startswith(("vae.", "unet.conv_out.", "unet.conv_norm_out.")):
            assert torch.equal(state[k], before[k]), k


def test_ema_tree_and_bn_state_match_jax(stepped):
    new, state = stepped["new"], stepped["model"].state_dict()
    ema_keys = [k for k in new if k.startswith("ema.")
                and not k.endswith(("num_batches_tracked", "running_mean", "running_var"))]
    assert ema_keys
    for k in ema_keys:  # step 0: the teacher copies the student before its update
        assert (state[k] - new[k]).abs().max().item() <= 1e-6 * max(1.0, new[k].abs().max().item()), k
    for k in new:
        # head_bn and ema_head_bn: fp32 sums over B*H*W pixels in another order
        # (measured 3e-6 of the largest statistic)
        if k.endswith(("running_mean", "running_var")):
            assert (state[k] - new[k]).abs().max().item() <= 1e-5 * max(1.0, new[k].abs().max().item()), k


def test_train_mode_head_matches_jax():
    """BN by batch statistics and the running-statistics update (momentum
    0.9, biased variance) against the flax head, no dropout rng."""
    keys, dims = ("s0", "s3", "s4", "s5"), (8, 16, 16, 16)
    jhead = JaxHead(in_keys=keys, num_classes=11, channels=32)
    rng = np.random.default_rng(2)
    feats = {k: rng.normal(size=(2, 32 // (1 << i), 32 // (1 << i), d)).astype(np.float32)
             for i, (k, d) in enumerate(zip(keys, dims))}
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = jhead.init(jax.random.PRNGKey(3), jfeats)
    ref, mut = jhead.apply(variables, jfeats, train=True, mutable=["batch_stats"])
    head = DAFormerHead(dims, keys, 11, channels=32)
    sd = state_dict_from_jax({"params": {"head": variables["params"]},
                              "state": {"head_bn": variables["batch_stats"]}})
    head.load_state_dict({k[len("sem_seg_head."):]: v for k, v in sd.items()}, strict=True)
    out = head({k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats.items()},
               train=True, update_bn=True)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=1e-4 * np.abs(np.asarray(ref)).max(), rtol=0)
    new = state_dict_from_jax({"params": {"head": variables["params"]},
                               "state": {"head_bn": mut["batch_stats"]}})
    for k, v in head.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), new["sem_seg_head." + k].numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("flag,value", [(k, v) for k, v in [
    ("mic", True), ("mic_reg", 1.0), ("fd", 0.5), ("noise_reg", 1.0), ("pl_crop", True),
    ("mask_prompt_ratio", 0.5), ("prompt_perturbation", 0.1), ("prompt_confidence", 0.5),
    ("merge_with_pl_data", "linear_mix"), ("remove_texture", True), ("denoise_supervise", 1.0),
    ("fd_attention", 1.0), ("target_attention_loss", True), ("enable_mixup", False),
    ("rev_noise_sup", False), ("rev_noise_gradually", False), ("vae_decoder_loss_type", "L2"),
    ("reg_uncertain", False), ("pseudo_weight_scope", "batch"), ("reg_target_palette", "discrete")]])
def test_unported_train_flags_raise(flag, value):
    assert flag in ts._UNPORTED
    with pytest.raises(NotImplementedError, match=flag):
        TrainConfig(**{flag: value})


@pytest.mark.parametrize("flag,value", [("ema_w_unet", True), ("slide_training", True),
                                        ("finetune_unet", "attention")])
def test_unported_model_flags_raise(flag, value):
    with pytest.raises(NotImplementedError, match=flag):
        MADMConfig(**{flag: value})


def test_draws_come_from_the_generator():
    tc = TrainConfig()
    labels = torch.from_numpy(_batch()["source_label"])
    head = DAFormerHead((8, 8, 8, 8), ("s0", "s3", "s4", "s5"), 11)
    a, b = (ts.sample_draws(torch.Generator().manual_seed(7), tc, labels, 11, head) for _ in range(2))
    assert torch.equal(a["mix_mask"], b["mix_mask"]) and a["jitter"] == b["jitter"]
    assert a["blur"] == b["blur"] and a["t_pl"] == b["t_pl"] and 60 <= a["t_pl"] <= 61
    assert all(torch.equal(x, y) for x, y in zip(a["dropout"], b["dropout"]))
    assert set(a["mix_mask"].unique().tolist()) == {0.0, 1.0}
    assert (a["mix_mask"][labels == 255] == 0).all()
    drop = a["dropout"][0]
    assert drop.shape == (2, 256) and set(drop.unique().tolist()) <= {0.0, torch.tensor(1 / 0.9).item()}


@pytest.mark.parametrize("step,expected", [(0, 60), (2500, 30), (5000, 0), (5001, 0)])
def test_rev_noise_timestep_decays(step, expected):
    assert ts.rev_noise_timestep(60, step, TrainConfig()) == expected
