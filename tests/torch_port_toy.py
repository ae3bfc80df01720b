"""A toy-width model shared by the port's parity tests: the port's MADM on
seeded random weights and the same weights as the JAX package's variables,
through the JAX package's checkpoint converter (cheaper than a flax init).
Under ``clip_state`` the CLIP tower is the narrow one of the JAX package's
own test (``SMALL_CLIP``), set on both sides."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from madm_tpu.checkpoint.converter import (
    convert_clip_project,
    convert_clip_vision_state,
    convert_daformer_head,
    convert_projections,
    convert_unet_state,
    convert_vae_state,
)
from madm_tpu.models.clip_image import CLIPVisionTransformer as JaxCLIPVision
from madm_tpu.models.madm import MADM as JaxMADM
from madm_tpu.models.madm import MADMConfig as JaxMADMConfig
from madm_tpu.models.sd.lora import init_lora
from madm_tpu.train import make_train_step
from madm_torch.models.clip_image import VisionConfig
from madm_torch.models.madm import MADM, MADMConfig, init_random_

TOY = dict(num_classes=11, crop_size=(64, 64), unet_channels=(32, 64, 128, 128),
           vae_channels=(32, 32, 64, 64), feature_dims=(3, 32, 64, 128),
           projection_dim=(32, 32, 32, 32))
# tests/test_fused_head.py's tower: image 32, patch 8, width 64, 2 layers,
# 4 heads, MLP 128, out 48
SMALL_CLIP = VisionConfig(image_size=32, patch_size=8, width=64, layers=2, heads=4, mlp_dim=128, out_dim=48)


@pytest.fixture(autouse=True)
def remove_tmp_path(request):
    """Remove each test's ``tmp_path`` at its teardown: a whole tier-1 run
    otherwise leaves ~5 GB of checkpoints and datasets behind.  Active in
    the modules that import it."""
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


def jax_madm(**cfg) -> JaxMADM:
    """The JAX ``MADM`` of the port's ``MADMConfig`` fields ``cfg`` (its
    ``clip_vision`` becomes the JAX model's tower, as the JAX package's
    tests swap it in)."""
    vision = cfg.pop("clip_vision", None)
    jm = JaxMADM(JaxMADMConfig(**cfg))
    if vision is not None and jm.clip_adapter is not None:
        jm.clip_adapter.vision = JaxCLIPVision(**dataclasses.asdict(vision), dtype=jm.cfg.compute_dtype)
    return jm


def _prompt(sd, prefix: str) -> dict:
    """A ``ClipFeatureProject``'s tensors as the JAX prompt tree, a prefix
    lift's ``linear`` as a [in, out] kernel."""
    tree = convert_clip_project(sd, prefix)
    for lift in ("prompt_embed_project", "time_embed_project"):
        if f"{lift}.linear.weight" in tree:
            tree[lift] = {"kernel": tree.pop(f"{lift}.linear.weight").T,
                          "bias": tree.pop(f"{lift}.linear.bias"),
                          "positional_embedding": tree.pop(f"{lift}.positional_embedding")}
    return tree


def jax_variables(port: MADM) -> dict:
    """The port's weights as the JAX ``MADM``'s eval variables."""
    sd = {k: v.float().numpy() for k, v in port.state_dict().items()}

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    enc, dec = convert_vae_state(sub("vae."))
    head, head_bn = convert_daformer_head(sd, "sem_seg_head")
    variables = {
        "params": {"vae_encoder": enc, "vae_decoder": dec, "unet": convert_unet_state(sub("unet.")),
                   "prompt": {"clip_project_rgb": _prompt(sd, "prompt.clip_project_rgb")},
                   "projections": convert_projections(sd, "feature_projections"), "head": head},
        "state": {"head_bn": head_bn},
        "consts": {"uncond_inputs": sd["uncond_inputs"],
                   "shared_noise": sd["shared_noise"].transpose(0, 2, 3, 1)},
    }
    if "sem_seg_head_sec_modal.conv_seg.weight" in sd:  # the second head
        variables["params"]["head_sec"], variables["state"]["head_sec_bn"] = convert_daformer_head(
            sd, "sem_seg_head_sec_modal")
    if "clip_vision.visual_projection.weight" in sd:  # HF names, which the JAX converter reads
        variables["params"]["clip_vision"] = convert_clip_vision_state(sub("clip_vision."))
    tower = sub("pixel_unshuffle.")
    if tower:  # the pixel-unshuffle tower's JAX leaves: conv kernels HWIO
        variables["params"]["pixel_unshuffle"] = {
            k: ({"kernel": tower[f"{k}.weight"].transpose(2, 3, 1, 0), "bias": tower[f"{k}.bias"]}
                if k.startswith("conv") else tower[k])
            for k in ("conv1", "conv2", "bn1_scale", "bn1_bias", "bn2_scale", "bn2_bias")}
    return variables


def _compiled(fn):
    """``fn(first, *args, **kwargs)`` compiled once for each set of static
    keywords (bools, ints, strings, ``mutable`` lists) and shapes; the other
    arguments are traced."""
    fns = {}

    def call(first, *args, **kwargs):
        static = tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in kwargs.items()
                              if isinstance(v, (bool, int, str, list))))
        names = {k for k, _ in static}
        f = fns.get(static)
        if f is None:
            kw = {k: list(v) if isinstance(v, tuple) else v for k, v in static}
            f = fns[static] = jax.jit(lambda v, a, d: fn(v, *a, **d, **kw))
        return f(first, args, {k: v for k, v in kwargs.items() if k not in names})

    return call


class _CompiledApply:
    """A flax module whose ``apply`` is ``_compiled``; everything else of the
    module is the module's."""

    def __init__(self, module):
        self._module, self.apply = module, _compiled(module.apply)

    def __getattr__(self, name):
        return getattr(self._module, name)


def compiled_modules(jm: JaxMADM) -> JaxMADM:
    """``jm`` with each flax module's ``apply`` (the VAE, the UNet, the
    projections, the head, the towers) compiled alone, once for each set of
    shapes; a step of it run without ``jax.jit`` runs the rest op by op.
    The JAX functions and their inputs are the same; only how XLA runs them
    changes: XLA:CPU takes ~12 minutes to compile a whole toy step."""
    for name in ("vae_encoder", "vae_decoder", "unet", "unet_capture", "projections", "head", "pixel_tower"):
        if getattr(jm, name, None) is not None:
            setattr(jm, name, _CompiledApply(getattr(jm, name)))
    if jm.clip_adapter is not None:
        jm.clip_adapter.vision = _CompiledApply(jm.clip_adapter.vision)
    return jm


def jax_train_step(jm: JaxMADM, tc, tx):
    """``make_train_step(jm, tc, tx)``'s function on ``compiled_modules(jm)``,
    the optimizer's update compiled alone too."""
    return make_train_step(compiled_modules(jm), tc, optax.GradientTransformation(tx.init, jax.jit(tx.update)))


def jax_pass_step(jm: JaxMADM, tc, tx):
    """``jax_train_step`` with ``backbone_forward`` compiled whole, once for
    each set of static keywords (~1.3x the time).  Its fusion is the whole
    step's within a backbone pass, so its gradients follow the whole step's
    where the modules compiled alone part from them (the 'texture' group's
    grad_norm: 8e-8 relative against 1.4e-4)."""
    jm.backbone_forward = _compiled(jm.backbone_forward)
    return jax_train_step(jm, tc, tx)


def train_variables(jm: JaxMADM, seed: int = 0, **variant) -> dict:
    """The variables a JAX train state of ``jm`` starts from, on the port's
    seeded weights (``init_random_``) in place of a flax init, ~70 s less:
    ``jax_variables`` with the teacher's BN statistics copied from the
    student's and ``jm``'s LoRA adapters at JAX's init (``init_lora`` on
    the UNet); ``variant``: the port's MADMConfig fields.  The caller adds
    ``ema`` (``jm.init_ema``) after any change to the params."""
    port = init_random_(MADM(MADMConfig(**TOY, compute_dtype=torch.float32, **variant), device="cpu"),
                        torch.Generator().manual_seed(seed))
    variables = jax_variables(port)
    unet = variables["params"]["unet"]
    variables["params"]["lora"] = {name: init_lora(unet, spec["rank"], spec["alpha"], rng=i)
                                   for i, (name, spec) in enumerate(jm.lora_specs.items())}
    variables["state"]["ema_head_bn"] = variables["state"]["head_bn"]
    return variables


def toy_pair(seed: int = 0, **variant):
    """(port MADM fp32 on the CPU, JAX MADM, its variables) on the same
    weights; ``variant``: MADMConfig fields of both packages (and the
    port's ``clip_vision``, the JAX model's tower)."""
    port = init_random_(MADM(MADMConfig(**TOY, compute_dtype=torch.float32, **variant), device="cpu"),
                        torch.Generator().manual_seed(seed))
    jm = jax_madm(**TOY, compute_dtype=jnp.float32, **variant)
    return port, jm, jax_variables(port)


def sure_pixels(logits: np.ndarray, margin: float = 1e-4) -> np.ndarray:
    """Pixels whose top-2 logit margin (last axis) exceeds ``margin``: there
    an argmax is settled beyond fp32 summation-order noise."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > margin


def assert_close(out, ref, rtol_of_max: float) -> None:
    """|out - ref| <= rtol_of_max x max(1, max|ref|) everywhere, on equal
    shapes (tensors or arrays)."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = float(np.abs(out - ref).max())
    assert err <= rtol_of_max * max(1.0, float(np.abs(ref).max())), err
