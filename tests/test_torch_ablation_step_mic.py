"""The port's UDA step against the JAX package's with MIC and the decoder
and feature regularisers on (``tests/torch_ablation_step.py``): ``mic`` and
``mic_reg`` (the head's BN chain source -> mixed -> masked),
``denoise_supervise`` with ``denoise_interval``, ``fd`` against a frozen
initial UNet and prompt, ``noise_reg`` (its own teacher pass and palette
latent), ``pl_crop``, the 'discrete' regression palette, the 'batch'
pseudo-weight and ``merge_with_pl_data='linear_mix'``."""

import pytest

from torch_ablation_step import check_ema_and_bn, check_frozen, check_gradients, check_metrics, check_updates
from torch_ablation_step import run_group

BRANCHES = ("masked_prompt_consistency_loss", "mic_vae_decoder_loss", "denoise_consistency_loss",
            "feature_distance_loss", "noise_reg_loss")
PREFIXES = ["unet.", "prompt.", "feature_projections.", "sem_seg_head."]


@pytest.fixture(scope="module")
def stepped():
    return run_group(dict(reg_target_palette="discrete"),
                     dict(mic=True, mic_reg=1.0, denoise_supervise=1.0, denoise_interval=5, fd=0.5,
                          noise_reg=1.0, pl_crop=True, pseudo_weight_scope="batch",
                          merge_with_pl_data="linear_mix"))


def test_mic_step_losses_and_grad_norm_match_jax(stepped):
    check_metrics(stepped, BRANCHES)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_mic_step_gradients_match_jax(stepped, prefix):
    check_gradients(stepped, prefix)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_mic_step_updates_match_jax(stepped, prefix):
    check_updates(stepped, prefix)


def test_mic_step_frozen_parameters_unchanged(stepped):
    check_frozen(stepped)


def test_mic_step_ema_tree_and_bn_state_match_jax(stepped):
    check_ema_and_bn(stepped)


def test_fd_baseline_is_a_copy(stepped):
    """The step moved the student's UNet and prompt and left the baseline's
    copies as they were (JAX ``add_feature_distance_baseline`` copies)."""
    model, consts = stepped["model"], stepped["pstate"].consts
    for name, module in (("ori_unet", model.unet), ("ori_prompt", model.prompt)):
        base = consts[name].state_dict()
        assert all(v.data_ptr() != base[k].data_ptr() for k, v in module.state_dict().items())
        assert not all(v.requires_grad for v in consts[name].parameters())
    w = "conv_in.weight"
    assert not (consts["ori_unet"].state_dict()[w] == model.unet.state_dict()[w]).all()
