"""The port's CLIP text encoder against the JAX package's on CPU: the
transformer at a narrow width (64 wide, 2 layers, 4 heads, a vocabulary of
1000) on token ids and on embeddings, the final LayerNorm, the empty-prompt
ids, and ``compute_uncond_inputs`` at SD-v1.4's full width.  Weights are
numpy draws in HF ``CLIPTextModel`` names, read by the port's loader and by
the JAX converter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.checkpoint.converter import convert_clip_text_state
from madm_tpu.models import clip_text as jclip
from madm_torch.models import clip_text as pclip

NARROW = dict(vocab_size=1000, width=64, layers=2, heads=4, mlp_dim=128, max_len=77)
TOL = 1e-5


def hf_state(vocab_size, width, layers, mlp_dim, max_len, seed=0, prefix="text_model."):
    """An HF CLIPTextModel state dict of numpy draws (fp32)."""
    rng = np.random.default_rng(seed)

    def n(*shape, std=0.02):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    sd = {"embeddings.token_embedding.weight": n(vocab_size, width),
          "embeddings.position_embedding.weight": n(max_len, width, std=0.01),
          "embeddings.position_ids": np.arange(max_len, dtype=np.int64)[None],
          "final_layer_norm.weight": 1 + n(width, std=0.1), "final_layer_norm.bias": n(width)}
    for i in range(layers):
        p = f"encoder.layers.{i}."
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
    return {prefix + k: v for k, v in sd.items()}


def _close(port, ref, tol=TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


@pytest.fixture(scope="module")
def narrow():
    sd = hf_state(**{k: v for k, v in NARROW.items() if k != "heads"})
    port = pclip.CLIPTextTransformer(**NARROW)
    port.load_state_dict({k.removeprefix("text_model."): torch.from_numpy(v) for k, v in sd.items()
                          if "position_ids" not in k})
    return sd, port, jclip.CLIPTextTransformer(**NARROW), {"params": convert_clip_text_state(sd)}


@pytest.mark.parametrize("final_ln", [True, False])
def test_transformer_equals_jax(narrow, final_ln):
    _, port, jm, params = narrow
    ids = np.random.default_rng(1).integers(0, NARROW["vocab_size"], (2, 77))
    ref = jm.apply(params, jnp.asarray(ids, jnp.int32), final_ln=final_ln)
    out = port(torch.from_numpy(ids), final_ln=final_ln)
    _close(out.detach().numpy(), ref)


def test_inputs_embeds_and_short_sequences_equal_jax(narrow):
    """Embeddings in place of ids, 20 tokens (the positions and the causal
    mask cut to the sequence)."""
    _, port, jm, params = narrow
    emb = np.random.default_rng(2).standard_normal((2, 20, NARROW["width"])).astype(np.float32)
    dummy = jnp.zeros((2, 20), jnp.int32)
    ref = jm.apply(params, dummy, inputs_embeds=jnp.asarray(emb))
    _close(port(inputs_embeds=torch.from_numpy(emb)).detach().numpy(), ref)


def test_attention_is_causal(narrow):
    """A token's output does not depend on any later token."""
    port = narrow[1]
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, NARROW["vocab_size"], (1, 77)))
    changed = ids.clone()
    changed[0, 40:] = (changed[0, 40:] + 1) % NARROW["vocab_size"]
    a, b = port(ids), port(changed)
    assert torch.equal(a[0, :40], b[0, :40]) and not torch.equal(a[0, 40:], b[0, 40:])


def test_final_layer_norm_equals_jax(narrow):
    sd, port, _, params = narrow
    x = np.random.default_rng(4).standard_normal((2, 77, NARROW["width"])).astype(np.float32)
    ref = jclip.apply_final_layer_norm(params["params"], jnp.asarray(x))
    for src in (port, {k: torch.from_numpy(v) for k, v in sd.items()}):
        _close(pclip.apply_final_layer_norm(src, torch.from_numpy(x)).detach().numpy(), ref)


def test_empty_prompt_ids_equal_jax():
    assert np.array_equal(pclip.empty_prompt_ids().numpy(), jclip.empty_prompt_ids())
    assert np.array_equal(pclip.empty_prompt_ids(5).numpy(), jclip.empty_prompt_ids(5))


def test_load_clip_text_reads_the_fields_from_the_shapes():
    """``load_clip_text`` builds the narrow model from an HF state dict
    (prefix and ``position_ids`` as HF writes them), heads = width / 64."""
    sd = hf_state(**{k: v for k, v in NARROW.items() if k != "heads"}, prefix="")
    m = pclip.load_clip_text({k: torch.from_numpy(v) for k, v in sd.items()}, device="cpu")
    assert (m.vocab_size, m.width, m.layers, m.heads, m.mlp_dim, m.max_len) == (1000, 64, 2, 1, 128, 77)
    assert not any(p.requires_grad for p in m.parameters())


def test_compute_uncond_inputs_full_width_equals_jax():
    """SD-v1.4's text encoder at full width (49408 x 768, 12 layers, 12
    heads, MLP 3072): the port's ``compute_uncond_inputs`` on the HF state
    dict against the JAX package's, [1, 77, 768] fp32."""
    sd = hf_state(pclip.VOCAB_SIZE, pclip.WIDTH, pclip.LAYERS, pclip.MLP_DIM, pclip.MAX_LEN, seed=5)
    ref = jclip.compute_uncond_inputs(convert_clip_text_state(sd))
    out = pclip.compute_uncond_inputs({k: torch.from_numpy(v) for k, v in sd.items()}, device="cpu")
    assert out.shape == (1, 77, 768) and out.dtype == torch.float32
    _close(out.numpy(), ref)


def test_compute_uncond_inputs_of_a_module_equals_jax():
    """The narrow model's empty-prompt embedding: JAX's ``compute_uncond_inputs``
    body (the module applied to ``empty_prompt_ids``) at the narrow fields."""
    sd = hf_state(**{k: v for k, v in NARROW.items() if k not in ("heads", "vocab_size")},
                  vocab_size=pclip.VOCAB_SIZE, seed=6)
    fields = dict(NARROW, vocab_size=pclip.VOCAB_SIZE)
    jm = jclip.CLIPTextTransformer(**fields)
    ref = jax.jit(jm.apply)({"params": convert_clip_text_state(sd)}, jnp.asarray(jclip.empty_prompt_ids()))
    port = pclip.CLIPTextTransformer(**fields)
    port.load_state_dict({k.removeprefix("text_model."): torch.from_numpy(v) for k, v in sd.items()
                          if "position_ids" not in k})
    _close(pclip.compute_uncond_inputs(port).numpy(), ref)
