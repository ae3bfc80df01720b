"""The PyTorch port's eval pass as a whole against the JAX package, on CPU.

One toy-width MADM (the verify recipe without LoRA: crop 64x64, fp32) is
initialised once by the JAX package; its variables go through
``state_dict_from_jax`` into the port.  On CPU the JAX model takes the module
head and the port takes kernel K2's twin, so the ids test also holds the twin
against the module head.  Also here: the weight round trip through the JAX
package's converter, device resolution, and the port's independence of JAX.
"""

import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.checkpoint.converter import (
    convert_clip_project,
    convert_daformer_head,
    convert_projections,
    convert_unet_state,
    convert_vae_state,
)
from madm_tpu.models.madm import MADM as JaxMADM
from madm_tpu.models.madm import MADMConfig as JaxMADMConfig
from madm_torch.checkpoint.from_jax import state_dict_from_jax
from madm_torch.device import resolve_device
from madm_torch.models.madm import MADM, MADMConfig
from madm_torch.ops.aspp import fits_kernel

REPO = pathlib.Path(__file__).resolve().parents[1]
TOY = dict(num_classes=11, crop_size=(64, 64), unet_channels=(32, 64, 128, 128),
           vae_channels=(32, 32, 64, 64), feature_dims=(3, 32, 64, 128),
           projection_dim=(32, 32, 32, 32))
# fp32 on both sides; summation order differs (XLA vs torch): measured ~1e-6
# on logits of magnitude ~0.25, so 1e-4 is the stated bound
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def toy():
    jm = JaxMADM(JaxMADMConfig(**TOY, compute_dtype=jnp.float32))
    variables = jm.init_params(jax.random.PRNGKey(0))
    port = MADM(MADMConfig(**TOY, compute_dtype=torch.float32), device="cpu")
    eval_vars = {k: v for k, v in variables.items() if k != "ema"}  # an eval model holds no teacher
    port.load_state_dict(state_dict_from_jax(eval_vars), strict=True)
    images = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    logits = np.asarray(jax.jit(jm.eval_forward)(variables, jnp.asarray(images)))
    return jm, variables, port, images, logits


def test_eval_forward_logits_match_jax(toy):
    _, _, port, images, ref = toy
    out = port.eval_forward(images)
    assert out.shape == (2, 64, 64, 11) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_ATOL, rtol=0)


def test_eval_forward_ids_match_jax(toy):
    jm, variables, port, images, logits = toy
    assert fits_kernel(port.sem_seg_head)  # the port's CPU ids go through K2's twin
    ref = np.asarray(jax.jit(jm.eval_forward_ids)(variables, jnp.asarray(images)))
    ids = port.eval_forward_ids(images).numpy()
    assert ids.shape == (2, 64, 64) and ids.dtype == np.int32
    top2 = np.sort(logits, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > LOGIT_ATOL
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(ids[sure], ref[sure])


def test_backbone_features_match_jax(toy):
    jm, variables, port, images, _ = toy
    ref = jax.jit(lambda v, x: jm.backbone_forward(v, x, input_modal="others")["output_features"])(
        variables, jnp.asarray(images))
    out = port.backbone_forward(images)["output_features"]
    assert list(out) == ["s0", "s3", "s4", "s5"]
    for name, feat in out.items():
        r = np.asarray(ref[name])
        err = np.abs(feat.permute(0, 2, 3, 1).numpy() - r).max()
        assert err <= 1e-5 * np.abs(r).max(), (name, err)


def test_state_dict_round_trips_through_the_jax_converter(toy):
    """JAX tree -> state_dict_from_jax -> converter.py -> the same JAX tree."""
    _, variables, _, _, _ = toy
    sd = {k: v.numpy() for k, v in state_dict_from_jax(variables).items() if not k.startswith("ema.")}
    params = variables["params"]

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    def same(a, b):
        flat_a = jax.tree_util.tree_leaves_with_path(a)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(b))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))

    enc, dec = convert_vae_state(sub("vae."))
    same(enc, params["vae_encoder"])
    same(dec, params["vae_decoder"])
    same(convert_unet_state(sub("unet.")), params["unet"])
    same(convert_projections(sd, "feature_projections"), params["projections"])
    head, head_bn = convert_daformer_head(sd, "sem_seg_head")
    same(head, params["head"])
    same(head_bn, variables["state"]["head_bn"])
    same(convert_clip_project(sd, "prompt.clip_project_rgb"),
         params["prompt"]["clip_project_rgb"])


def test_device_resolution_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        MADM(MADMConfig(**TOY, compute_dtype=torch.float32))  # default device is CUDA
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_no_jax():
    code = ("import madm_torch, madm_torch.models.madm, sys; "
            "assert not any(m.split('.')[0] in ('jax', 'flax', 'madm_tpu') for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)


def test_port_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|madm_tpu)\b", re.MULTILINE)
    files = sorted((REPO / "madm_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert offenders == []
