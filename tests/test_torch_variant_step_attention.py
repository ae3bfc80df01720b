"""The port's UDA step against the JAX package's with attention capture and
its three consumers (``tests/torch_ablation_step.py``): cross-attention
maps at res 16 and 32 of the up blocks, the head's conv_seg concat of the
largest res's maps at 11 selected tokens (teacher, source and mixed
passes), ``fd_attention`` on the up-block maps against a frozen initial
UNet and prompt, and ``target_attention_loss`` (the student's maps on the
target against the teacher's)."""

import pytest

from torch_ablation_step import check_ema_and_bn, check_frozen, check_gradients, check_metrics, check_updates
from torch_ablation_step import run_group

SELECT = (3, 7, 12, 20, 26, 33, 41, 48, 55, 63, 76)  # 11 prompt tokens in 1..76
MODEL = dict(attention_features_res=(16, 32), attention_features_location=("up",),
             concat_attention_to_conv_seg=True, attention_select_index=SELECT)
BRANCHES = ("feature_distance_loss", "target_attention_loss")
PREFIXES = ["unet.", "prompt.", "feature_projections.", "sem_seg_head."]


@pytest.fixture(scope="module")
def stepped():
    return run_group(MODEL, dict(fd_attention=0.5, target_attention_loss=True), jax_init=False)


def test_attention_step_losses_and_grad_norm_match_jax(stepped):
    check_metrics(stepped, BRANCHES)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_attention_step_gradients_match_jax(stepped, prefix):
    check_gradients(stepped, prefix)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_attention_step_updates_match_jax(stepped, prefix):
    check_updates(stepped, prefix)


def test_attention_step_frozen_parameters_unchanged(stepped):
    check_frozen(stepped)


def test_attention_step_ema_tree_and_bn_state_match_jax(stepped):
    check_ema_and_bn(stepped)


def test_attention_step_conv_seg_reads_the_concat_slot(stepped):
    """conv_seg takes head channels + num_classes inputs, and the slot's
    columns trained (the maps reached the logits)."""
    seg = stepped["model"].sem_seg_head.conv_seg.weight
    assert seg.shape[1] == stepped["model"].cfg.head_channels + 11
    assert stepped["grads"]["sem_seg_head.conv_seg.weight"][:, -11:].abs().max() > 0
