"""The port's UDA step against the JAX package's with the perturbed prompt
on (``tests/torch_ablation_step.py``): ``prompt_perturbation`` (the head
alone trains on that pass) at ``prompt_seq_len=40`` (the 77-token empty
prompt resized into it), the 'L2' decoder losses,
``finetune_unet='attention'``, the teacher at t = 0
(``rev_noise_sup=False``) and no ``reg_uncertain``.  The token-masked
prompt is ``tests/test_torch_ablation_step_masked.py``."""

import pytest

from torch_ablation_step import check_ema_and_bn, check_frozen, check_gradients, check_metrics, check_updates
from torch_ablation_step import run_group

PREFIXES = ["unet.", "prompt.", "feature_projections.", "sem_seg_head."]


@pytest.fixture(scope="module")
def stepped():
    return run_group(dict(prompt_perturbation=0.1, finetune_unet="attention", prompt_seq_len=40),
                     dict(prompt_perturbation=0.1, vae_decoder_loss_type="L2", rev_noise_sup=False,
                          reg_uncertain=False))


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
