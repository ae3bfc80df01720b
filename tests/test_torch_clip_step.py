"""The port's UDA step against the JAX package's with the CLIP image prefix
trained (``clip_state='learnable_clip'``, ``tests/torch_ablation_step.py``)
on the narrow tower of ``torch_port_toy.SMALL_CLIP``: the prompt and time
embedding lifted from the tower's image embedding on every pass, the
teacher's pass through the EMA tower (detached), the tower's gradient, its
AdamW update (decay on its weights and tables, none on its LayerNorms and
biases) and its EMA copy, at ``tests/test_torch_train.py``'s tolerances."""

import numpy as np
import pytest

from torch_ablation_step import check_ema_and_bn, check_frozen, check_gradients, check_metrics, check_updates
from torch_ablation_step import run_group
from torch_port_toy import SMALL_CLIP

PREFIXES = ["unet.", "prompt.", "feature_projections.", "sem_seg_head.", "clip_vision."]


def _live_time_lift(params):
    """alpha_cond_time drawn U[0, 1) (it starts at 0), so that the time
    embedding's lift gets a gradient and every trained tensor moves."""
    p = dict(params["prompt"]["clip_project_rgb"])
    p["alpha_cond_time"] = np.random.default_rng(6).uniform(size=p["alpha_cond_time"].shape).astype(np.float32)
    return dict(params, prompt=dict(params["prompt"], clip_project_rgb=p))


@pytest.fixture(scope="module")
def stepped():
    return run_group(dict(clip_state="learnable_clip", clip_vision=SMALL_CLIP), {}, prepare=_live_time_lift)


def test_clip_step_losses_and_grad_norm_match_jax(stepped):
    check_metrics(stepped, ())


@pytest.mark.parametrize("prefix", PREFIXES)
def test_clip_step_gradients_match_jax(stepped, prefix):
    check_gradients(stepped, prefix)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_clip_step_updates_match_jax(stepped, prefix):
    check_updates(stepped, prefix)


def test_clip_step_frozen_parameters_unchanged(stepped):
    check_frozen(stepped)


def test_clip_step_ema_tree_and_bn_state_match_jax(stepped):
    """The EMA tree holds the tower (step 0 copies the student's)."""
    check_ema_and_bn(stepped)
    ema = [k for k in stepped["new"] if k.startswith("ema.clip_vision.")]
    assert ema and len(ema) == len(stepped["model"].clip_vision.state_dict())


def test_clip_step_trains_the_prefix_lifts(stepped):
    """Both lifts and their weights train, and the tower's gradient reaches
    its patch embedding and class token (through the prompt's lift alone:
    the time embedding reads the prefix detached)."""
    grads = stepped["grads"]
    lifts = [f"prompt.clip_project_rgb.{lift}.{leaf}"
             for lift in ("prompt_embed_project", "time_embed_project")
             for leaf in ("linear.weight", "linear.bias", "positional_embedding")]
    tower = ["clip_vision.embeddings.patch_embedding.weight", "clip_vision.embeddings.class_embedding"]
    for name in lifts + ["prompt.clip_project_rgb.alpha_cond_time"] + tower:
        assert grads[name].abs().max() > 0, name
