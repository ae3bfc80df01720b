"""The port's UDA step against the JAX package's with the prompt ablations
on (``tests/torch_ablation_step.py``), in two steps: the token-masked prompt
(``mask_prompt_ratio``, ``detach_mask_prompt``) with ``add_latent_noise`` on
the mixed pass, ``norm_latent_noise`` and the rev-noise timestep undecayed;
and the perturbed prompt (``prompt_perturbation``: the head alone trains on
that pass) at ``prompt_seq_len=40`` (the 77-token empty prompt resized into
it), the 'L2' decoder losses, ``finetune_unet='attention'``, the teacher at
t = 0 (``rev_noise_sup=False``) and no ``reg_uncertain``."""

import pytest

from torch_ablation_step import check_ema_and_bn, check_frozen, check_gradients, check_metrics, check_updates
from torch_ablation_step import run_group

PREFIXES = ["unet.", "prompt.", "feature_projections.", "sem_seg_head."]
GROUPS = {
    "masked": (dict(mask_prompt_ratio=0.5, detach_mask_prompt=True, add_latent_noise=0.5,
                    norm_latent_noise=True),
               dict(mask_prompt_ratio=0.5, detach_mask_prompt=True, rev_noise_gradually=False)),
    "perturbed": (dict(prompt_perturbation=0.1, finetune_unet="attention", prompt_seq_len=40),
                  dict(prompt_perturbation=0.1, vae_decoder_loss_type="L2", rev_noise_sup=False,
                       reg_uncertain=False)),
}


@pytest.fixture(scope="module", params=list(GROUPS))
def stepped(request):
    return run_group(*GROUPS[request.param])


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
