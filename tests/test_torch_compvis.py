"""The port's CompVis checkpoint loader (``madm_torch/checkpoint/converter.py``:
``convert_compvis_state``, ``load_compvis_checkpoint``, ``LdmCheckpointer``
and the writer ``save_compvis_checkpoint``) against the JAX package's
(``madm_tpu/checkpoint/converter.py``).

Every key of a full-width SD-v1 layout (the port's modules built on the
'meta' device, under their CompVis names from the writer) is renamed as
JAX's ``_compvis_unet_key`` / ``_compvis_vae_key`` rename it, back to the
port's key; a toy ``.ckpt`` written by the test loads in both packages to
the same weights."""

import pickle

import jax
import numpy as np
import pytest
import torch

from madm_tpu.checkpoint.converter import _compvis_unet_key as jax_unet_key
from madm_tpu.checkpoint.converter import _compvis_vae_key as jax_vae_key
from madm_tpu.checkpoint.converter import convert_clip_text_state
from madm_tpu.checkpoint.converter import load_compvis_checkpoint as jax_load_compvis
from madm_torch.checkpoint import (
    LdmCheckpointer,
    compvis_state_dict,
    convert_compvis_state,
    load_compvis_checkpoint,
    save_compvis_checkpoint,
    snapshot_state_dict,
)
from madm_torch.checkpoint.converter import _compvis_unet_key, _compvis_vae_key, _to_compvis_unet, _to_compvis_vae
from madm_torch.checkpoint.from_jax import state_dict_from_jax
from madm_torch.models.clip_text import CLIPTextTransformer
from madm_torch.models.ldm_extractor import LdmExtractor
from madm_torch.models.sd.unet import UNet2DCondition
from madm_torch.models.sd.vae import AutoencoderKL

UNET_CH, VAE_CH = (32, 64, 128, 128), (32, 32, 64, 64)


def test_full_width_layout_renamed_as_jax():
    """686 UNet and 248 VAE keys (sd-v1-*.ckpt's own counts; the text
    encoder's 196 keep their names): each key's CompVis name, as the writer
    names it, maps back to the port's key in both packages."""
    with torch.device("meta"):
        unet, vae, text = UNet2DCondition(), AutoencoderKL(), CLIPTextTransformer()
    sds = {"unet": unet.state_dict(), "vae": vae.state_dict(), "clip_text": text.state_dict()}
    assert [len(v) for v in sds.values()] == [686, 248, 196]
    names = {}
    for part, to_compvis, prefix, mine, theirs in (
            ("unet", _to_compvis_unet, "model.diffusion_model.", _compvis_unet_key, jax_unet_key),
            ("vae", _to_compvis_vae, "first_stage_model.", _compvis_vae_key, jax_vae_key)):
        for key in sds[part]:
            rel = to_compvis(key)
            assert mine(rel) == theirs(rel) == key, (part, key, rel)
            names[prefix + rel] = key
    assert len(names) == 686 + 248
    # names of the released file, as the JAX package's own test lists them
    for rel, key in (("input_blocks.3.0.op.weight", "down_blocks.0.downsamplers.0.conv.weight"),
                     ("output_blocks.2.1.conv.weight", "up_blocks.0.upsamplers.0.conv.weight"),
                     ("output_blocks.5.2.conv.weight", "up_blocks.1.upsamplers.0.conv.weight"),
                     ("middle_block.2.emb_layers.1.bias", "mid_block.resnets.1.time_emb_proj.bias")):
        assert f"model.diffusion_model.{rel}" in names and _compvis_unet_key(rel) == key
    for rel in ("decoder.up.3.block.0.norm1.weight", "decoder.up.1.upsample.conv.weight",
                "encoder.down.1.block.0.nin_shortcut.weight", "encoder.mid.attn_1.q.weight"):
        assert f"first_stage_model.{rel}" in names and _compvis_vae_key(rel) == jax_vae_key(rel)
    # parts neither package holds
    assert _compvis_unet_key("label_emb.0.0.weight") is None is jax_unet_key("label_emb.0.0.weight")
    assert _compvis_vae_key("loss.logvar") is None is jax_vae_key("loss.logvar")


def toy_parts(seed=0):
    """The toy UNet, VAE and a narrow text encoder on seeded weights."""
    gen = torch.Generator().manual_seed(seed)
    unet, vae = UNet2DCondition(UNET_CH), AutoencoderKL(VAE_CH)
    text = CLIPTextTransformer(vocab_size=100, width=64, layers=2, heads=2, mlp_dim=128, max_len=77)
    parts = {}
    for name, m in (("unet", unet), ("vae", vae), ("clip_text", text)):
        parts[name] = {k: (torch.randn(v.shape, generator=gen) * 0.1 if v.is_floating_point() else v)
                       for k, v in m.state_dict().items()}
    return parts


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_toy_ckpt_loads_equal_in_both_packages(dtype, tmp_path):
    """A written ``{'state_dict', 'global_step'}`` file (with the extras of
    a released one: ``model_ema.*``, the schedule buffers, ``position_ids``)
    loads in the port equal to the writer's tensors in fp32, and in JAX to
    the same weights (JAX's trees carried back by ``state_dict_from_jax``)."""
    parts = toy_parts()
    path = str(tmp_path / "sd-toy.ckpt")
    save_compvis_checkpoint(path, parts["unet"], parts["vae"], parts["clip_text"], dtype=dtype)
    ckpt = torch.load(path, weights_only=True)
    attn = [k for k in ckpt["state_dict"] if ".mid.attn_1." in k and k.endswith("weight") and ".norm." not in k]
    assert len(attn) == 8 and all(ckpt["state_dict"][k].shape[2:] == (1, 1) for k in attn)  # 1x1 convs
    assert ckpt["global_step"] == 0 and all(v.dtype == dtype for v in ckpt["state_dict"].values()
                                            if v.is_floating_point())
    ckpt["state_dict"].update({"model_ema.decay": torch.tensor(0.9999), "betas": torch.zeros(1000),
                               "cond_stage_model.transformer.text_model.embeddings.position_ids":
                                   torch.arange(77)[None]})
    torch.save(ckpt, path)
    got = load_compvis_checkpoint(path)
    assert set(got) == {"unet", "vae", "clip_text"}
    for part, sd in parts.items():
        assert got[part].keys() == sd.keys(), part
        for k, v in sd.items():
            assert got[part][k].dtype == torch.float32
            assert torch.equal(got[part][k], v.to(dtype).float()), (part, k)
    ref = jax_load_compvis(path)
    carried = state_dict_from_jax({"params": {k: ref[k] for k in ("unet", "vae_encoder", "vae_decoder")}})
    mine = snapshot_state_dict(got)
    assert carried.keys() == mine.keys()
    for k in mine:
        assert torch.equal(carried[k], mine[k]), k
    ref_text, my_text = ref["clip_text"], convert_clip_text_state({k: v.numpy() for k, v in got["clip_text"].items()})
    assert jax.tree.structure(ref_text) == jax.tree.structure(my_text)
    for a, b in zip(jax.tree.leaves(ref_text), jax.tree.leaves(my_text)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert convert_compvis_state(ckpt["state_dict"]).keys() == got.keys()


def test_ldm_checkpointer_loads_into_an_extractor(tmp_path):
    parts = toy_parts(1)
    path = str(tmp_path / "sd-toy.ckpt")
    save_compvis_checkpoint(path, parts["unet"], parts["vae"])
    ex = LdmExtractor(unet_channels=UNET_CH, vae_channels=VAE_CH, device="cpu")
    state = LdmCheckpointer(ex).load(path)
    assert set(state) == {"unet", "vae"}
    own = ex.state_dict()
    for part in ("unet", "vae"):
        for k, v in parts[part].items():
            assert torch.equal(own[f"{part}.{k}"], v), k


class _NotATensor:
    pass


def test_a_checkpoint_with_other_objects_raises(tmp_path):
    """``weights_only=True``: a Lightning file that pickles another object
    raises in the port, where the JAX package unpickles it (ROADMAP §C)."""
    parts = toy_parts(2)
    path = str(tmp_path / "lightning.ckpt")
    torch.save({"state_dict": compvis_state_dict(parts["unet"], parts["vae"]), "callbacks": _NotATensor()}, path)
    with pytest.raises(pickle.UnpicklingError):
        load_compvis_checkpoint(path)
    assert set(jax_load_compvis(path)) == {"unet", "vae_encoder", "vae_decoder"}
