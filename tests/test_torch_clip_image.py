"""The port's CLIP image tower against the JAX package's on CPU, at the
narrow width of the JAX package's own tower test (image 32, patch 8, width
64, 2 layers, 4 heads, MLP 128, out 48): the image embedding, the spatial
embeddings of a shrinking input, ``preprocess`` (``jax.image.resize``'s
antialiased bilinear where it shrinks), MaskCLIP's masked forward and its
synonym-ensembled logits, and the HF-key converter against
``convert_clip_vision_state``.  Weights are numpy draws in HF
``CLIPVisionModelWithProjection`` names, read by the port's converter and
by the JAX one; fp32, held to 1e-5 of max(1, max|reference|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.checkpoint.converter import convert_clip_vision_state as jax_convert
from madm_tpu.models import clip_image as jclip
from madm_torch.checkpoint.converter import convert_clip_vision_state, load_clip_vision
from madm_torch.checkpoint.from_jax import state_dict_from_jax
from madm_torch.models import clip_image as pclip
from torch_port_toy import assert_close

NARROW = dict(image_size=32, patch_size=8, width=64, layers=2, heads=4, mlp_dim=128, out_dim=48)
TOL = 1e-5


def hf_vision_state(image_size, patch_size, width, layers, mlp_dim, out_dim, seed=0,
                    pre_ln="pre_layrnorm"):
    """An HF ``CLIPVisionModelWithProjection`` state dict of numpy draws."""
    rng = np.random.default_rng(seed)

    def n(*shape, std=0.02):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    npos = (image_size // patch_size) ** 2 + 1
    v = "vision_model."
    sd = {v + "embeddings.class_embedding": n(width, std=0.5),
          v + "embeddings.patch_embedding.weight": n(width, 3, patch_size, patch_size,
                                                     std=(3 * patch_size ** 2) ** -0.5),
          v + "embeddings.position_embedding.weight": n(npos, width, std=0.1),
          v + "embeddings.position_ids": np.arange(npos, dtype=np.int64)[None],
          v + f"{pre_ln}.weight": 1 + n(width, std=0.1), v + f"{pre_ln}.bias": n(width),
          v + "post_layernorm.weight": 1 + n(width, std=0.1), v + "post_layernorm.bias": n(width),
          "visual_projection.weight": n(out_dim, width, std=width ** -0.5)}
    for i in range(layers):
        p = f"{v}encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[p + f"self_attn.{proj}.weight"] = n(width, width, std=width ** -0.5)
            sd[p + f"self_attn.{proj}.bias"] = n(width)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[p + f"{ln}.weight"] = 1 + n(width, std=0.1)
            sd[p + f"{ln}.bias"] = n(width)
        sd[p + "mlp.fc1.weight"] = n(mlp_dim, width, std=width ** -0.5)
        sd[p + "mlp.fc1.bias"] = n(mlp_dim)
        sd[p + "mlp.fc2.weight"] = n(width, mlp_dim, std=mlp_dim ** -0.5)
        sd[p + "mlp.fc2.bias"] = n(width)
    return sd


@pytest.fixture(scope="module")
def towers():
    """(port tower, JAX tower module, its params) on one HF state dict."""
    sd = hf_vision_state(**{k: v for k, v in NARROW.items() if k != "heads"})
    port = load_clip_vision({k: torch.from_numpy(v) for k, v in sd.items()}, device="cpu", heads=4).eval()
    jv = jclip.CLIPVisionTransformer(**NARROW)
    return port, jv, jax_convert(sd)


def _images(shape, seed=1):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _adapters(towers, cls=("ClipAdapter", "ClipAdapter")):
    port, jv, params = towers
    jadapter = getattr(jclip, cls[1])()
    jadapter.vision = jv
    return getattr(pclip, cls[0])(port), jadapter, params


@pytest.mark.parametrize("normalize", [False, True])
def test_tower_embedding_matches_jax(towers, normalize):
    """CLIP-normalised images straight into the tower: the projected class token."""
    port, jv, params = towers
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = jax.jit(lambda p, a: jv.apply({"params": p}, a, normalize=normalize))(params, jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x), normalize=normalize)
    assert_close(out, ref, TOL)


@pytest.mark.parametrize("hw", [(64, 64), (512, 512), (32, 32), (48, 80)])
def test_preprocess_matches_jax(hw):
    """Resize to the tower's 336 (or 32) and CLIP's channel normalisation:
    shrinking (512 -> 336, 64 -> 32 on the narrow tower) antialiases as
    ``jax.image.resize`` does, growing does not need to."""
    x = _images((2, *hw, 3))
    for size in (336, 32):
        jadapter = jclip.ClipAdapter()
        jadapter.vision = jclip.CLIPVisionTransformer(**dict(NARROW, image_size=size))
        ref = jadapter.preprocess(jnp.asarray(x))
        out = pclip.preprocess(torch.from_numpy(x), size)
        assert_close(out, ref, TOL)


def test_embed_image_and_spatial_match_jax(towers):
    """``embed_image`` and ``embed_image_spatial`` of 64x64 images in [0, 1]:
    shrunk to the tower's 32, the 4x4 grid of patch encodings resized to
    stride 16 of the image."""
    padapter, jadapter, params = _adapters(towers)
    x = _images((2, 64, 64, 3), seed=3)
    ref = jax.jit(jadapter.embed_image)(params, jnp.asarray(x))
    ref_emb, ref_enc = jax.jit(jadapter.embed_image_spatial)(params, jnp.asarray(x))
    with torch.no_grad():
        out = padapter.embed_image(torch.from_numpy(x))
        emb, enc = padapter.embed_image_spatial(torch.from_numpy(x))
    assert_close(out, ref, TOL)
    assert_close(emb, ref_emb, TOL)
    assert enc.shape == (2, 4, 4, 48)
    assert_close(enc, ref_enc, TOL)
    x = _images((1, 96, 128, 3), seed=4)  # a 6x8 stride-16 grid from the 4x4 patches
    _, ref_enc = jax.jit(jadapter.embed_image_spatial)(params, jnp.asarray(x))
    with torch.no_grad():
        _, enc = padapter.embed_image_spatial(torch.from_numpy(x))
    assert_close(enc, ref_enc, TOL)


def test_maskclip_matches_jax(towers):
    """MaskCLIP's mask embeddings (Q = 3 class-token copies under the
    additive mask over Q + g^2 + 1 tokens, one mask all but empty) and its
    cosine logits ensembled over synonyms."""
    padapter, jadapter, params = _adapters(towers, ("MaskCLIP", "MaskCLIP"))
    x = _images((2, 48, 48, 3), seed=5)
    masks = np.random.default_rng(6).standard_normal((2, 3, 24, 24)).astype(np.float32) * 4
    masks[:, 2] = -20.0  # an empty mask: its token sees the class token alone
    masks[0, 2, :3, :3] = 20.0
    text = np.random.default_rng(7).standard_normal((5, 48)).astype(np.float32)
    labels = [["road"], ["car", "vehicle"], ["sky", "cloud"]]
    ref = jadapter(params, jnp.asarray(x), jnp.asarray(masks), jnp.asarray(text), labels)
    with torch.no_grad():
        out = padapter(torch.from_numpy(x), torch.from_numpy(masks), torch.from_numpy(text), labels)
    assert_close(out["mask_embed"], ref["mask_embed"], TOL)
    assert out["mask_pred_open_logits"].shape == (2, 3, 3)
    assert_close(out["mask_pred_open_logits"], ref["mask_pred_open_logits"], TOL)


@pytest.mark.parametrize("method", ["max", "mean"])
def test_ensemble_logits_match_jax(method):
    logits = np.random.default_rng(8).standard_normal((2, 4, 6)).astype(np.float32)
    labels = [["a"], ["b", "c", "d"], ["e", "f"]]
    ref = jclip.ensemble_logits_with_labels(jnp.asarray(logits), labels, method)
    out = pclip.ensemble_logits_with_labels(torch.from_numpy(logits), labels, method)
    assert_close(out, ref, TOL)
    with pytest.raises(ValueError, match="synonyms"):
        pclip.ensemble_logits_with_labels(torch.from_numpy(logits), labels[:2], method)


@pytest.mark.parametrize("pre_ln", ["pre_layrnorm", "pre_layernorm"])
@pytest.mark.parametrize("prefix", ["vision_model.", ""])
def test_converter_matches_jax(pre_ln, prefix):
    """The port's HF-key converter gives, tensor for tensor, the JAX
    converter's tree in the port's names (through ``state_dict_from_jax``),
    with HF's ``pre_layrnorm`` or the corrected spelling, with or without
    the ``vision_model.`` prefix; ``position_ids`` is dropped."""
    sd = hf_vision_state(**{k: v for k, v in NARROW.items() if k != "heads"}, pre_ln=pre_ln)
    sd = {(k.replace("vision_model.", prefix)): v for k, v in sd.items()}
    out = convert_clip_vision_state({k: torch.from_numpy(v) for k, v in sd.items()})
    ref = state_dict_from_jax({"params": {"clip_vision": jax_convert(sd)}})
    ref = {k[len("clip_vision."):]: v for k, v in ref.items()}
    assert set(out) == set(ref)
    assert set(out) == set(pclip.CLIPVisionTransformer(pclip.VisionConfig(**NARROW)).state_dict())
    for k, v in ref.items():
        assert torch.equal(out[k].float(), v), k


def test_load_clip_vision_reads_the_shape():
    """The tower's shape from the tensors' (heads = width / 64): a 128-wide
    tower at patch 4 on 16x16 images."""
    sd = hf_vision_state(image_size=16, patch_size=4, width=128, layers=3, mlp_dim=256, out_dim=32)
    tower = load_clip_vision({k: torch.from_numpy(v) for k, v in sd.items()}, device="cpu")
    assert tower.cfg == pclip.VisionConfig(image_size=16, patch_size=4, width=128, layers=3, heads=2,
                                           mlp_dim=256, out_dim=32)
    assert tower.encoder.layers[0].self_attn.heads == 2


def test_tower_matches_transformers(towers):
    """The same state dict through transformers' ``CLIPVisionModelWithProjection``
    (the JAX package's own tower test, its 3e-5)."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPVisionConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                                        num_attention_heads=4, image_size=32, patch_size=8,
                                        projection_dim=48, hidden_act="quick_gelu")
    hf = transformers.CLIPVisionModelWithProjection(cfg).eval()
    sd = hf_vision_state(**{k: v for k, v in NARROW.items() if k != "heads"})
    missing, _ = hf.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    assert not missing
    port = towers[0]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        ref = hf(pixel_values=x.permute(0, 3, 1, 2)).image_embeds
        out = port(x)
    assert_close(out, ref, 3e-5)
