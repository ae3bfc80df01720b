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
each ported ablation flag's branch running on the port's own toy step, and
the draws' determinism.  The model variants' step branches are held to JAX
in ``tests/test_torch_variant_step_*.py`` and
``tests/test_torch_attention_capture.py``.
"""

import copy
import dataclasses

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
from madm_torch.models.madm import MADM, MADMConfig, init_random_, trainable_parameters
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


# --------------------------------------- each ported flag's branch runs
RUN_STEP = 2500  # half way to rev_noise_end_iter: the teacher's t is 30, not 60 or 0


@pytest.fixture(scope="module")
def flag_base():
    """A toy model (conv_seg scaled as above, so that pseudo-weights are
    live), a batch with the ablations' extra images, and the shipped step's
    metrics from it at step RUN_STEP."""
    model = init_random_(MADM(MADMConfig(**TOY, compute_dtype=torch.float32), device="cpu",
                              trainable=True), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in (model.sem_seg_head, model.ema["sem_seg_head"]):
            m.conv_seg.weight.mul_(SEG_SCALE)  # pseudo_val 0.23
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for k in ("source_pl_data", "target_second_modality_pha"):
        batch[k] = torch.from_numpy(rng.uniform(size=(2, 64, 64, 3)).astype(np.float32))
    return model, batch, _flag_step(model, batch, {}, {})[0]


def _flag_step(model, batch, tc_kw, model_kw, prepare=None):
    """One step of a copy of ``model`` (its config updated by ``model_kw``)
    at RUN_STEP with ``TrainConfig(**tc_kw)`` and draws from a fixed seed;
    returns (metrics, the stepped copy)."""
    m = copy.deepcopy(model)
    m.cfg = dataclasses.replace(m.cfg, **model_kw)
    if "finetune_unet" in model_kw:
        names = {n for n, _ in trainable_parameters(m)}
        for n, p in m.named_parameters():
            p.requires_grad_(n in names)
    if prepare is not None:
        prepare(m)
    tc = TrainConfig(**STEP_KW, **tc_kw)
    state = port_state(m, tc)
    state.step = RUN_STEP
    if tc.fd:
        ts.add_feature_distance_baseline(state)
        with torch.no_grad():
            m.unet.conv_in.weight.mul_(1.01)
    draws = ts.sample_draws(torch.Generator().manual_seed(7), tc, batch["source_label"].long(), 11,
                            m.sem_seg_head, m.cfg)
    return train_step(state, batch, draws=draws), m


def _perturb_teacher_unet(m):
    with torch.no_grad():
        for p in m.ema["unet"].parameters():
            p.mul_(1.05)


# (TrainConfig fields, MADMConfig fields, the metric that shows the branch ran:
# a key of its own, or (key, 'differs') from the shipped step's, or (key, value))
PORTED_FLAGS = {
    "mic": ({"mic": True}, {}, "masked_prompt_consistency_loss"),
    "mic_reg": ({"mic_reg": 1.0}, {}, "mic_vae_decoder_loss"),
    "fd": ({"fd": 0.5}, {}, "feature_distance_loss"),
    "noise_reg": ({"noise_reg": 1.0}, {}, "noise_reg_loss"),
    "pl_crop": ({"pl_crop": True, "psweight_ignore_top": 40}, {}, ("target_loss", "differs")),
    "mask_prompt_ratio": ({"mask_prompt_ratio": 0.5}, {"mask_prompt_ratio": 0.5},
                          "masked_prompt_consistency_loss"),
    "prompt_perturbation": ({"prompt_perturbation": 0.1}, {"prompt_perturbation": 0.1},
                            "masked_prompt_consistency_loss"),
    "prompt_confidence": ({"prompt_confidence": 0.5}, {"rand_prompt_scale": 5.0}, ("target_loss", "differs")),
    "merge_with_pl_data": ({"merge_with_pl_data": "linear_mix"}, {}, ("source_loss", "differs")),
    "remove_texture": ({"remove_texture": True}, {}, "masked_prompt_consistency_loss"),
    "denoise_supervise": ({"denoise_supervise": 1.0}, {}, "denoise_consistency_loss"),
    "enable_mixup": ({"enable_mixup": False}, {}, ("target_loss", "differs")),
    "rev_noise_sup": ({"rev_noise_sup": False}, {}, ("pseudo_val", "differs")),
    "rev_noise_gradually": ({"rev_noise_gradually": False}, {}, ("pseudo_val", "differs")),
    "vae_decoder_loss_type": ({"vae_decoder_loss_type": "L2"}, {}, ("vae_decoder_source_loss", "differs")),
    "reg_uncertain": ({"reg_uncertain": False}, {}, ("reg_prob_mean", 0.0)),
    "pseudo_weight_scope": ({"pseudo_weight_scope": "batch"}, {}, ("target_loss", "differs")),
    "reg_target_palette": ({}, {"reg_target_palette": "discrete"}, ("vae_decoder_source_loss", "differs")),
}


@pytest.mark.parametrize("flag", list(PORTED_FLAGS))
def test_ported_train_flags_run(flag_base, flag):
    """Each step setting that the port now takes is accepted, and its branch
    runs: the step shows its loss, or a metric the branch moves."""
    model, batch, base = flag_base
    tc_kw, model_kw, shows = PORTED_FLAGS[flag]
    out, _ = _flag_step(model, batch, tc_kw, model_kw)
    assert all(np.isfinite(v) for v in out.values())
    if isinstance(shows, str):
        assert shows not in base and out[shows] != 0.0, (shows, out)
    elif shows[1] == "differs":
        assert abs(out[shows[0]] - base[shows[0]]) > 1e-6 * max(1.0, abs(base[shows[0]])), (shows, out, base)
    else:
        assert out[shows[0]] == shows[1] != base[shows[0]], (shows, out, base)


@pytest.mark.parametrize("flag,value", [("ema_w_unet", True), ("finetune_unet", "attention")])
def test_ported_model_flags_run(flag_base, flag, value):
    """``ema_w_unet``: the teacher's passes run its own UNet (moved off the
    student's, the pseudo-labels change); ``finetune_unet='attention'``:
    the step moves the UNet's transformer blocks only."""
    model, batch, base = flag_base
    if flag == "ema_w_unet":
        m = MADM(dataclasses.replace(model.cfg, ema_w_unet=True), device="cpu", trainable=True)
        m.load_state_dict(model.state_dict(), strict=False)
        m.reset_ema_()
        out, _ = _flag_step(m, batch, {}, {}, prepare=_perturb_teacher_unet)
        assert abs(out["pseudo_val"] - base["pseudo_val"]) > 1e-6 or \
            abs(out["target_loss"] - base["target_loss"]) > 1e-6, (out, base)
        return
    out, stepped = _flag_step(model, batch, {}, {flag: value})
    assert all(np.isfinite(v) for v in out.values())
    moved = {n for n, p in stepped.unet.named_parameters()
             if not torch.equal(p, model.unet.get_parameter(n))}
    attention = {n for n, _ in model.unet.named_parameters() if ".attentions." in f".{n}"}
    assert moved <= attention and len(moved) > 0.9 * len(attention), sorted(attention - moved)


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
