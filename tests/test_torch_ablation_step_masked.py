"""The port's UDA step against the JAX package's with the token-masked
prompt on (``tests/torch_ablation_step.py``): ``mask_prompt_ratio`` with
``detach_mask_prompt``, ``add_latent_noise`` on the mixed pass,
``norm_latent_noise`` and the rev-noise timestep undecayed.  The perturbed
prompt is ``tests/test_torch_ablation_step_perturbed.py``."""

import pytest

from torch_ablation_step import check_ema_and_bn, check_frozen, check_gradients, check_metrics, check_updates
from torch_ablation_step import run_group

PREFIXES = ["unet.", "prompt.", "feature_projections.", "sem_seg_head."]


@pytest.fixture(scope="module")
def stepped():
    return run_group(dict(mask_prompt_ratio=0.5, detach_mask_prompt=True, add_latent_noise=0.5,
                          norm_latent_noise=True),
                     dict(mask_prompt_ratio=0.5, detach_mask_prompt=True, rev_noise_gradually=False))


def test_prompt_step_losses_and_grad_norm_match_jax(stepped):
    check_metrics(stepped, ("masked_prompt_consistency_loss",))


@pytest.mark.parametrize("prefix", PREFIXES)
def test_prompt_step_gradients_match_jax(stepped, prefix):
    check_gradients(stepped, prefix)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_prompt_step_updates_match_jax(stepped, prefix):
    check_updates(stepped, prefix)


def test_prompt_step_frozen_parameters_unchanged(stepped):
    check_frozen(stepped)


def test_prompt_step_ema_tree_and_bn_state_match_jax(stepped):
    check_ema_and_bn(stepped)
