"""The port's UDA step against the JAX package's with the texture and
confidence branches and the model and optimizer options on
(``tests/torch_ablation_step.py``): ``remove_texture`` (the MIC loss slot on
the dataset's edge map), ``prompt_confidence`` (a random-prompt teacher pass
through the eval-mode EMA head), ``enable_mixup=False``,
``finetune_unet='without cross-attention'``, ``ema_w_unet`` (the teacher's
UNet and adapters in the EMA tree) and ``unet_lr`` (the UNet's and the
adapters' AdamW update at 5x the rest's), with two LoRA adapters."""

import pytest

from test_torch_lora import LORA
from torch_ablation_step import check_ema_and_bn, check_frozen, check_gradients, check_metrics, check_updates
from torch_ablation_step import run_group
from torch_port_toy import jax_pass_step

PREFIXES = ["unet.", "lora.default.", "lora.Depth.", "prompt.", "feature_projections.", "sem_seg_head."]


@pytest.fixture(scope="module")
def stepped():
    # a flax init: on the port's seeded weights one pixel of the teacher's
    # confidence sits at the pseudo-label threshold, within fp32 noise, and
    # the two packages put it on either side (pseudo_val 1/8192 apart, the
    # target losses 7.9e-4 relative).  JAX's backbone passes compiled
    # whole: with its modules compiled alone the grad_norm moves 1.4e-4
    # relative from the whole step's, over the check's 1e-4
    return run_group(dict(finetune_unet="without cross-attention", ema_w_unet=True),
                     dict(remove_texture=True, prompt_confidence=0.5, enable_mixup=False),
                     lora=LORA, unet_lr=5e-3, flax_init=True, jax_step=jax_pass_step)


def test_texture_step_losses_and_grad_norm_match_jax(stepped):
    check_metrics(stepped, ("masked_prompt_consistency_loss",))


@pytest.mark.parametrize("prefix", PREFIXES)
def test_texture_step_gradients_match_jax(stepped, prefix):
    check_gradients(stepped, prefix)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_texture_step_updates_match_jax(stepped, prefix):
    check_updates(stepped, prefix)


def test_texture_step_frozen_parameters_unchanged(stepped):
    """The cross-attentions ('attn2') stay as they were, and train nowhere."""
    check_frozen(stepped)
    assert not any(".attn2." in k for k in stepped["grads"] if k.startswith("unet."))
    assert any(".attn1." in k for k in stepped["grads"])


def test_texture_step_ema_tree_and_bn_state_match_jax(stepped):
    check_ema_and_bn(stepped)
    assert any(k.startswith("ema.unet.") for k in stepped["new"])
    assert any(k.startswith("ema.lora.Depth.") for k in stepped["new"])
