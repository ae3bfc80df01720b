"""The port's NeTI machinery against the JAX package's on CPU: the Fourier
encoding of (timestep, UNet layer), the anchor-initialised input layer, the
mapper (eval, truncation, nested dropout with one draw handed to both
sides, with and without the bypass half, ``norm_scale``), the mapper's
state converted both ways (the port's seeded weights through JAX's
``convert_neti_mapper_state``; a JAX init through a test-written reference
state dict and the port's converter), and ``encode_with_neti``'s plain and
bypassed states on a narrow text transformer (vocabulary 100, width 64, 2
layers, 4 heads, 16 positions).  fp32, held to 1e-5 of max(1,
max|reference|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.checkpoint.converter import convert_clip_text_state
from madm_tpu.models import clip_text as jclip
from madm_tpu.models import neti as jneti
from madm_torch.models import clip_text as pclip
from madm_torch.models import neti as pneti
from test_torch_clip_text import hf_state
from torch_port_toy import assert_close

TOL = 1e-5
SMALL = dict(output_dim=64, num_w=64)
TEXT = dict(vocab_size=100, width=64, layers=2, heads=4, mlp_dim=128, max_len=16)


def _port_mapper(seed=0, **kw):
    """The port's seeded mapper, its biases and LayerNorm affines then drawn
    too (the init zeroes them; the conversions carry them)."""
    gen = torch.Generator().manual_seed(seed)
    mapper = pneti.init_neti_mapper_(pneti.NeTIMapper(**kw), gen).eval()
    with torch.no_grad():
        for name, p in mapper.named_parameters():
            if name.endswith("bias") or ".2." in name or ".5." in name:
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return mapper


def _to_jax(mapper):
    """The port mapper's state dict through the JAX package's converter."""
    return jneti.convert_neti_mapper_state({k: v.numpy() for k, v in mapper.state_dict().items()})


def _ts(b=3):
    return (np.array([0.0, 120.0, 999.0][:b], np.float32), np.array([0.0, 7.0, 15.0][:b], np.float32))


def test_fourier_encode_matches_jax():
    w = np.random.default_rng(0).standard_normal((64, 2)).astype(np.float32) * np.array([0.03, 2.0],
                                                                                     np.float32)
    t, layer = _ts()
    ref = jneti.fourier_encode(jnp.asarray(w), jnp.asarray(t), jnp.asarray(layer))
    out = pneti.fourier_encode(torch.from_numpy(w), torch.from_numpy(t), torch.from_numpy(layer))
    assert out.shape == (3, 128)
    assert_close(out, ref, TOL)


@pytest.mark.parametrize("anchors,layers", [(10, 16), (5, 4)])
def test_anchor_init_matrix_matches_jax(anchors, layers):
    w = np.random.default_rng(1).standard_normal((32, 2)).astype(np.float32)
    ref = jneti.anchor_init_matrix(jnp.asarray(w), anchors, layers)
    out = pneti.anchor_init_matrix(torch.from_numpy(w), anchors, layers)
    assert out.shape == (anchors * layers, 64)
    assert_close(out, ref, TOL)


def test_init_puts_the_anchors_in_the_input_layer():
    m = pneti.init_neti_mapper_(pneti.NeTIMapper(**SMALL), torch.Generator().manual_seed(0))
    assert m.net[0] is m.input_layer and not m.input_layer.bias.any()
    assert torch.equal(m.input_layer.weight, pneti.anchor_init_matrix(m.encoder.w, 10, 16))
    assert not m.encoder.w.requires_grad
    assert m.encoder.w[:, 0].abs().max() < 0.2 < m.encoder.w[:, 1].abs().max()  # sigma_t, sigma_l


@pytest.mark.parametrize("kw", [{}, {"output_bypass": False}, {"norm_scale": 0.5}],
                         ids=["bypass", "no_bypass", "norm_scale"])
@pytest.mark.parametrize("truncation_idx", [None, 0, 37])
def test_mapper_matches_jax(kw, truncation_idx):
    """The port's seeded mapper and the same weights through JAX's converter,
    in eval, with and without a truncation index."""
    port = _port_mapper(**SMALL, **kw)
    jm = jneti.NeTIMapper(**SMALL, **kw)
    t, layer = _ts()
    ref = jm.apply({"params": _to_jax(port)}, jnp.asarray(t), jnp.asarray(layer),
                   truncation_idx=truncation_idx)
    with torch.no_grad():
        out = port(torch.from_numpy(t), torch.from_numpy(layer), truncation_idx=truncation_idx)
    assert out.shape == (3, 64 * (1 if kw.get("output_bypass") is False else 2))
    assert_close(out, ref, TOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_nested_dropout_matches_jax(seed):
    """Training with nested dropout: JAX's draw from its rng (the uniform
    against ``nested_dropout_prob`` and the per-sample truncation index)
    handed to the port; over these seeds the dropout both applies and does
    not."""
    port = _port_mapper(**SMALL)
    jm = jneti.NeTIMapper(**SMALL)
    t, layer = _ts()
    rng = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(rng)
    draw = (torch.tensor(float(jax.random.uniform(k1, ()))),
            torch.from_numpy(np.array(jax.random.randint(k2, (3,), 0, pneti.HIDDEN))))
    ref = jm.apply({"params": _to_jax(port)}, jnp.asarray(t), jnp.asarray(layer), train=True,
                   dropout_rng=rng)
    with torch.no_grad():
        out = port(torch.from_numpy(t), torch.from_numpy(layer), train=True, dropout=draw)
        plain = port(torch.from_numpy(t), torch.from_numpy(layer))
    assert_close(out, ref, TOL)
    assert torch.equal(out, plain) == bool(draw[0] >= 0.5)


def test_draw_nested_dropout_shapes():
    u, trunc = pneti.draw_nested_dropout(torch.Generator().manual_seed(0), 5)
    assert u.shape == () and 0 <= float(u) < 1
    assert trunc.shape == (5,) and int(trunc.min()) >= 0 and int(trunc.max()) < pneti.HIDDEN


def test_mapper_state_converts_from_a_jax_init():
    """A flax-initialised JAX mapper written as the reference's torch state
    dict (``net.0`` alone, no ``input_layer`` keys) and read by the port's
    converter: the port mapper computes JAX's function."""
    jm = jneti.NeTIMapper(**SMALL)
    t, layer = _ts()
    params = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(t), jnp.asarray(layer))["params"]
    sd = {"encoder.w": np.array(params["encoder_w"])}
    for name, key in (("input_layer", "net.0"), ("net_1", "net.1"), ("net_4", "net.4"),
                      ("output_layer_0", "output_layer.0")):
        sd[f"{key}.weight"] = np.array(params[name]["kernel"]).T
        sd[f"{key}.bias"] = np.array(params[name]["bias"])
    for name, key in (("net_2", "net.2"), ("net_5", "net.5")):
        sd[f"{key}.weight"] = np.array(params[name]["scale"])
        sd[f"{key}.bias"] = np.array(params[name]["bias"])
    port = pneti.NeTIMapper(**SMALL)
    port.load_state_dict(pneti.convert_neti_mapper_state({k: torch.from_numpy(v) for k, v in sd.items()}),
                         strict=True)
    ref = jm.apply({"params": params}, jnp.asarray(t), jnp.asarray(layer))
    with torch.no_grad():
        assert_close(port(torch.from_numpy(t), torch.from_numpy(layer)), ref, TOL)
    # and back: the port's state through JAX's converter gives the same tree
    back = _to_jax(port)
    for name, leaf in jax.tree_util.tree_leaves_with_path(params):
        keys = [k.key for k in name]
        node = back
        for k in keys:
            node = node[k]
        np.testing.assert_array_equal(node, np.asarray(leaf))


@pytest.fixture(scope="module")
def text():
    """(port NeTICLIPText, JAX NeTICLIPText, text params, mapper params) on
    the narrow transformer and a seeded mapper."""
    sd = hf_state(**{k: v for k, v in TEXT.items() if k != "heads"}, seed=2)
    transformer = pclip.CLIPTextTransformer(**TEXT)
    transformer.load_state_dict({k.removeprefix("text_model."): torch.from_numpy(v) for k, v in sd.items()
                                 if "position_ids" not in k})
    mapper = _port_mapper(seed=3, **SMALL)
    port = pneti.NeTICLIPText(transformer, mapper).eval()
    jm = jneti.NeTICLIPText(transformer=jclip.CLIPTextTransformer(**TEXT), mapper=jneti.NeTIMapper(**SMALL))
    return port, jm, convert_clip_text_state(sd), _to_jax(mapper)


PH = 50


def _ids():
    ids = np.random.default_rng(4).integers(0, 49, (2, 16))
    ids[0, 3] = PH
    ids[1, 7] = PH
    ids[1, 11] = PH  # a second placeholder: the first is the one overwritten
    return ids


@pytest.mark.parametrize("train", [False, True])
def test_encode_with_neti_matches_jax(text, train):
    """The placeholder overwritten by the mapper's word half, and the
    bypass added before the final LayerNorm; in training with JAX's nested
    dropout draw handed in."""
    port, jm, tparams, mparams = text
    t, layer = np.array([120.0, 640.0], np.float32), np.array([2.0, 11.0], np.float32)
    rng = jax.random.PRNGKey(1)
    k1, k2 = jax.random.split(rng)
    draw = (torch.tensor(float(jax.random.uniform(k1, ()))),
            torch.from_numpy(np.array(jax.random.randint(k2, (2,), 0, pneti.HIDDEN))))
    ref_plain, ref_bypass = jax.jit(lambda tp, mp, ids, t_, l_: jm.encode_with_neti(
        tp, mp, ids, t_, l_, placeholder_id=PH, train=train, dropout_rng=rng))(
        tparams, mparams, jnp.asarray(_ids(), jnp.int32), jnp.asarray(t), jnp.asarray(layer))
    with torch.no_grad():
        plain, bypass = port.encode_with_neti(torch.from_numpy(_ids()), torch.from_numpy(t),
                                              torch.from_numpy(layer), PH, train=train, dropout=draw)
    assert_close(plain, ref_plain, TOL)
    assert_close(bypass, ref_bypass, TOL)
    assert (bypass - plain).abs().max() > 1e-3


def test_encode_matches_jax(text):
    port, jm, tparams, _ = text
    ref = jm.encode(tparams, jnp.asarray(_ids(), jnp.int32))
    with torch.no_grad():
        assert_close(port.encode(torch.from_numpy(_ids())), ref, TOL)


def test_encode_with_neti_without_bypass_matches_jax(text):
    port, _, tparams, _ = text
    mapper = _port_mapper(seed=5, output_bypass=False, **SMALL)
    jm = jneti.NeTICLIPText(transformer=jclip.CLIPTextTransformer(**TEXT),
                            mapper=jneti.NeTIMapper(output_bypass=False, **SMALL))
    t, layer = np.array([5.0, 300.0], np.float32), np.array([0.0, 15.0], np.float32)
    ref_plain, _ = jax.jit(lambda tp, mp, ids, t_, l_: jm.encode_with_neti(tp, mp, ids, t_, l_, PH))(
        tparams, _to_jax(mapper), jnp.asarray(_ids(), jnp.int32), jnp.asarray(t), jnp.asarray(layer))
    with torch.no_grad():
        plain, same = pneti.NeTICLIPText(port.transformer, mapper).encode_with_neti(
            torch.from_numpy(_ids()), torch.from_numpy(t), torch.from_numpy(layer), PH)
    assert_close(plain, ref_plain, TOL)
    assert torch.equal(plain, same)
