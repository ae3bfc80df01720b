"""The CLIP image prefix (``clip_state``, ``--with_clip``), the port against
the JAX package on CPU at toy width with the narrow tower of
``tests/test_fused_head.py`` (``torch_port_toy.SMALL_CLIP``): the prefix
prompts (``PositionalLinear`` lifts of the image embedding; the time
embedding reads it detached), the eval logits and ids under both clip
states against ``jax.jit(eval_forward)`` (1e-4 x max(1, max|logit|)), the
trainable split, the decay mask and the EMA tree against
``split_trainable`` / ``wd_mask`` / ``init_ema``, the checkpoint of the
tower and its EMA copy, and ``--with_clip`` building the model and
TrainConfig that the JAX launcher builds.  The whole 'learnable_clip'
step is ``tests/test_torch_clip_step.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.config import LazyConfig as JaxLazyConfig
from madm_tpu.models import prompt as jprompt
from madm_tpu.train.optimizer import split_trainable, wd_mask
from madm_torch import main as port_main
from madm_torch.checkpoint import Checkpointer
from madm_torch.checkpoint.from_jax import state_dict_from_jax
from madm_torch.config import LazyConfig
from madm_torch.models import prompt as pprompt
from madm_torch.models.clip_image import VisionConfig
from madm_torch.models.madm import MADM, MADMConfig, init_random_, trainable_parameters
from madm_torch.train.train_step import TrainConfig, make_train_state
from test_torch_cli import _assert_built_equal, _config, overrides
from torch_port_toy import SMALL_CLIP, TOY, assert_close, jax_madm, jax_variables, sure_pixels, toy_pair

STATES = ["no_learnable_clip", "learnable_clip"]
TOL = 1e-5


def _prefix_tree(alpha: bool):
    tree = jprompt.init_clip_feature_project(jax.random.PRNGKey(0), without_prompt_alpha=not alpha,
                                             input_prefix=True, in_features=48, time_embed_dim=128)
    # alpha_cond_time starts at 0: drawn here, so the time lift shows
    tree["alpha_cond_time"] = jax.random.uniform(jax.random.PRNGKey(1), (128,))
    return tree


def _port_prompt(tree, alpha: bool):
    p = pprompt.ClipFeatureProject(128, in_features=48, alpha=alpha)
    sd = state_dict_from_jax({"params": {"prompt": {"x": tree}}})
    p.load_state_dict({k[len("prompt.x."):]: v for k, v in sd.items()}, strict=True)
    return p


@pytest.mark.parametrize("alpha", [True, False], ids=["alpha", "without_prompt_alpha"])
def test_prefix_prompts_match_jax(alpha):
    """``cond_prompt`` / ``cond_time`` with a prefix [B, 48]: [B, 77, 768]
    and [B, 1, 128]."""
    tree = _prefix_tree(alpha)
    p = _port_prompt(tree, alpha)
    rng = np.random.default_rng(2)
    prefix = rng.standard_normal((2, 48)).astype(np.float32)
    uncond = rng.standard_normal((1, 77, 768)).astype(np.float32)
    ref_p = jprompt.cond_prompt(tree, jnp.asarray(uncond), jnp.asarray(prefix))
    ref_t = jprompt.cond_time(tree, jnp.asarray(prefix))
    out_p = pprompt.cond_prompt(p, torch.from_numpy(uncond), torch.from_numpy(prefix))
    out_t = pprompt.cond_time(p, torch.from_numpy(prefix))
    assert out_p.shape == (2, 77, 768) and out_t.shape == (2, 1, 128)
    assert_close(out_p.detach(), ref_p, TOL)
    assert_close(out_t.detach(), ref_t, TOL)
    cp, ct = pprompt.conditioning_of(p, torch.from_numpy(uncond), 2, prefix=torch.from_numpy(prefix))
    assert torch.equal(cp, out_p) and torch.equal(ct, out_t)


def test_prefix_time_embedding_reads_the_prefix_detached():
    """JAX ``cond_time`` stops the prefix's gradient; ``cond_prompt`` does not."""
    p = _port_prompt(_prefix_tree(True), True)
    prefix = torch.randn(2, 48, generator=torch.Generator().manual_seed(3), requires_grad=True)
    pprompt.cond_time(p, prefix).sum().backward()
    assert prefix.grad is None
    pprompt.cond_prompt(p, torch.zeros(1, 77, 768), prefix).sum().backward()
    assert prefix.grad is not None and prefix.grad.abs().max() > 0


def test_prefix_refusals_are_jax_s():
    """``multi_layer_prompt`` with a prefix, an unknown clip state, and a
    prefix prompt without its prefix raise, as they do in JAX."""
    with pytest.raises(AssertionError, match="multi_layer_prompt"):
        jprompt.init_clip_feature_project(0, input_prefix=True, multi_layer_prompt=True)
    with pytest.raises(ValueError, match="multi_layer_prompt"):
        MADM(MADMConfig(**TOY, clip_state="learnable_clip", clip_vision=SMALL_CLIP, multi_layer_prompt=True),
             device="cpu")
    with pytest.raises(AssertionError):
        jax_madm(**TOY, clip_state="frozen")
    with pytest.raises(ValueError, match="clip_state"):
        MADMConfig(**TOY, clip_state="frozen")
    with pytest.raises(ValueError, match="prefix"):
        pprompt.cond_prompt(_port_prompt(_prefix_tree(True), True), torch.zeros(1, 77, 768))


@pytest.fixture(scope="module", params=STATES)
def clip_pair(request):
    """A toy clip model with the time lift live (``alpha_cond_time`` drawn),
    its JAX twin's eval logits on two images, and the images."""
    port, jm, _ = toy_pair(clip_state=request.param, clip_vision=SMALL_CLIP)
    with torch.no_grad():
        t = port.prompt["clip_project_rgb"].alpha_cond_time
        t.copy_(torch.rand(t.shape, generator=torch.Generator().manual_seed(4)))
    images = np.random.default_rng(5).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.eval_forward)(jax_variables(port), images))
    return port, images, ref


def test_clip_eval_logits_match_jax(clip_pair):
    """Eval logits within 1e-4 x max(1, max|logit|); the prefix is live:
    the tower's projection zeroed moves them."""
    port, images, ref = clip_pair
    out = port.eval_forward(torch.from_numpy(images)).numpy()
    assert_close(out, ref, 1e-4)
    proj = port.clip_vision.visual_projection.weight
    saved = proj.clone()
    with torch.no_grad():
        proj.zero_()
        moved = port.eval_forward(torch.from_numpy(images)).numpy()
        proj.copy_(saved)
    assert np.abs(moved - ref).max() > 1e-3


@pytest.mark.parametrize("mode", ["aspp", "none"])
def test_clip_eval_ids_match_jax(clip_pair, mode):
    """The 'aspp' head (K2's twin) and the module head give JAX's argmax on
    every sure pixel."""
    port, images, ref = clip_pair
    ids = port.eval_forward_ids(torch.from_numpy(images), eval_head=mode).numpy()
    sure = sure_pixels(ref)
    assert sure.mean() > 0.9
    assert (ids[sure] == ref.argmax(-1)[sure]).all()


def _named_tree(tree) -> dict:
    """A JAX params tree's leaves under the port's names, each as the set of
    its values (a mask tree converts to one value a tensor)."""
    return {k: set(v.flatten().tolist()) for k, v in state_dict_from_jax({"params": tree}).items()}


@pytest.mark.parametrize("state", STATES)
def test_trainable_split_decay_and_ema_tree_match_jax(state):
    """The port's trainable parameters are JAX ``split_trainable``'s with
    ``learnable_clip`` (the tower only under 'learnable_clip'), its decayed
    ones JAX ``wd_mask``'s, and its EMA copies JAX ``init_ema``'s (the tower
    under 'learnable_clip')."""
    cfg = dict(TOY, compute_dtype=torch.float32, clip_state=state, clip_vision=SMALL_CLIP)
    port = MADM(MADMConfig(**cfg), device="cpu", trainable=True)
    jm = jax_madm(**dict(cfg, compute_dtype=jnp.float32))
    variables = jax_variables(init_random_(MADM(MADMConfig(**cfg), device="cpu"), torch.Generator()))
    variables["params"]["lora"] = {}
    trainable, frozen = split_trainable(variables, learnable_clip=state == "learnable_clip")
    names = {n for n, _ in trainable_parameters(port)}
    assert names == set(_named_tree(trainable))
    assert any(n.startswith("clip_vision.") for n in names) == (state == "learnable_clip")
    assert ("clip_vision" in frozen) == (state == "no_learnable_clip")
    mask = jax.tree.map(lambda x, m: np.full(x.shape, m, np.float32), trainable, wd_mask(trainable))
    decayed = {n for n, vals in _named_tree(mask).items() if vals == {1.0}}
    by_id = {id(p): n for n, p in port.named_parameters()}
    state_ = make_train_state(port, TrainConfig())
    port_decayed = {by_id[id(p)] for g in state_.optimizer.param_groups if g["weight_decay"] > 0
                    for p in g["params"]}
    assert port_decayed == decayed
    ema = set(state_dict_from_jax({"ema": jm.init_ema(variables["params"])}))
    assert ema == {n for n, _ in port.named_parameters() if n.startswith("ema.")}
    assert any(n.startswith("ema.clip_vision.") for n in ema) == (state == "learnable_clip")


def test_checkpoint_saves_the_tower_and_its_ema_copy(tmp_path):
    """A 'learnable_clip' train state's checkpoint restores the tower and the
    teacher's copy (after a step apart, so that the two differ)."""
    cfg = MADMConfig(**TOY, compute_dtype=torch.float32, clip_state="learnable_clip", clip_vision=SMALL_CLIP)
    src = make_train_state(init_random_(MADM(cfg, device="cpu", trainable=True), torch.Generator()),
                           TrainConfig())
    with torch.no_grad():
        for p in src.model.ema["clip_vision"].parameters():
            p.add_(0.5)
    Checkpointer(tmp_path).save("model_0000000", src)
    dst = make_train_state(MADM(cfg, device="cpu", trainable=True), TrainConfig())
    Checkpointer(tmp_path).load("model_0000000.pth", dst)
    own, back = src.model.state_dict(), dst.model.state_dict()
    keys = [k for k in own if k.startswith(("clip_vision.", "ema.clip_vision."))]
    assert len(keys) == 2 * len(src.model.clip_vision.state_dict())
    assert all(torch.equal(own[k], back[k]) for k in keys)
    (tmp_path / "model_0000000.pth").unlink()


@pytest.mark.parametrize("value", STATES)
def test_with_clip_builds_the_model_and_train_config_of_jax(value, tmp_path):
    """``--with_clip`` through each launcher's ``apply_cli_mutations``, then
    build_madm and build_train_config: the JAX package's MADMConfig fields
    and TrainConfig values, and the full ViT-L/14-336 tower in the model."""
    import main as jax_main

    argv = ["--config-file", "x", "--output", "out", "--with_clip", value]
    port = port_main.apply_cli_mutations(LazyConfig.load(_config("port", "depth_11")),
                                         port_main.build_parser().parse_args(argv))
    ref = jax_main.apply_cli_mutations(JaxLazyConfig.load(_config("jax", "depth_11")),
                                       jax_main.build_parser().parse_args(argv))
    port = LazyConfig.apply_overrides(port, overrides(tmp_path))
    ref = JaxLazyConfig.apply_overrides(ref, overrides(tmp_path))
    model = _assert_built_equal(port, ref)
    assert model.cfg.clip_state == value and model.clip_vision.cfg == VisionConfig()
    assert model.prompt["clip_project_rgb"].prompt_embed_project.linear.in_features == 768
