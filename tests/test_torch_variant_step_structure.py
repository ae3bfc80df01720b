"""The port's UDA step against the JAX package's with the model's structure
variants together (``tests/torch_ablation_step.py``): the second head for
the mixed pass (``sem_seg_head_sec_modal``, BN chains source -> head,
mixed -> second head), mask_diff's constant conv_in channel
('rgb=0_Depth=1'; the mixed pass's from the DACS mask), the
pixel-unshuffle tower (``concat_pixel_shuffle``; conv_in takes 4 + 1 + 64
channels), per-layer prompts (``multi_layer_prompt``), the ISA fuse layer
and ``final_fuse_vae_decoder_feat``."""

import pytest

from torch_ablation_step import check_ema_and_bn, check_frozen, check_gradients, check_metrics, check_updates
from torch_ablation_step import run_group

MODEL = dict(sem_seg_head_sec_modal=True, mask_diff="rgb=0_Depth=1", input_channel_plus=1,
             concat_pixel_shuffle=True, multi_layer_prompt=True, head_fusion="isa",
             final_fuse_vae_decoder_feat=True)
PREFIXES = ["unet.", "prompt.", "feature_projections.", "sem_seg_head.", "sem_seg_head_sec_modal.",
            "pixel_unshuffle."]


@pytest.fixture(scope="module")
def stepped():
    return run_group(MODEL, {}, jax_init=False)


def test_structure_step_losses_and_grad_norm_match_jax(stepped):
    check_metrics(stepped, ())


@pytest.mark.parametrize("prefix", PREFIXES)
def test_structure_step_gradients_match_jax(stepped, prefix):
    check_gradients(stepped, prefix)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_structure_step_updates_match_jax(stepped, prefix):
    check_updates(stepped, prefix)


def test_structure_step_frozen_parameters_unchanged(stepped):
    check_frozen(stepped)


def test_structure_step_ema_tree_and_bn_state_match_jax(stepped):
    check_ema_and_bn(stepped)


def test_structure_step_shapes(stepped):
    """The variants' shapes: conv_in's 69 inputs, per-layer prompts, the
    second head's own trained weights, ISA's relations."""
    model = stepped["model"]
    assert model.unet.conv_in.weight.shape[1] == 4 + 1 + 64
    assert model.prompt["clip_project_rgb"].prompt_embed.shape == (16, 1, 77, 768)
    assert hasattr(model.sem_seg_head.fuse_layer, "global_relation")
    head, sec = model.sem_seg_head.state_dict(), model.sem_seg_head_sec_modal.state_dict()
    assert any(not (head[k] == sec[k]).all() for k in head if k.endswith("weight"))
