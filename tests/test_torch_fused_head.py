"""The port's fused eval heads on CPU: kernel K6's twin (``dw_branches``) and
K7's twin (``matmul_argmax``) against the JAX Pallas kernels in interpret
mode, the 'full' and 'argmax' heads against the JAX ones, the choice of eval
head, and eval passes of a trainable model in every head mode.

The JAX depthwise kernel stages five 8-row blocks before its first output
block, so its inputs here are 48 rows high (a multiple of its argmax
kernel's 16 rows), not fewer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.models.daformer import DAFormerHead as JaxDAFormerHead
from madm_tpu.ops.aspp import dw_branches as jax_dw_branches
from madm_tpu.ops.aspp import fused_head_forward as jax_fused_head_forward
from madm_tpu.ops.aspp import matmul_argmax as jax_matmul_argmax
from madm_torch.checkpoint.from_jax import state_dict_from_jax
from madm_torch.models.daformer import DAFormerHead
from madm_torch.models.madm import MADM, MADMConfig, init_random_
from madm_torch.ops.aspp import (
    argmax_head_forward,
    dw_branches,
    fused_head_forward,
    matmul_argmax,
)
from torch_port_toy import TOY, sure_pixels

IN_KEYS = ("s0", "s3", "s4", "s5")
MODES = ("aspp", "argmax", "full", "none")
# fp32 on both sides, other summation orders: logits agree to ~1e-6, so an
# argmax is settled where the top-2 margin exceeds 1e-4
MARGIN = 1e-4


def _argmax_inputs(rng, tied=False):
    x = rng.normal(size=(1, 16, 64, 256)).astype(np.float32)
    w = rng.normal(size=(256, 11)).astype(np.float32)
    b = rng.normal(size=(11,)).astype(np.float32)
    if tied:  # classes 2, 5 and 9 have the same exact logit, the lowest index must win
        w[:, [2, 5, 9]] = 0.0
        b[[2, 5, 9]] = 22.0  # about the largest of the other 8 logits (N(0, 16) each)
    return x, w, b


@pytest.mark.parametrize("tied", [False, True])
def test_matmul_argmax_twin_matches_jax_kernel(tied):
    x, w, b = _argmax_inputs(np.random.default_rng(2), tied)
    ref = np.asarray(jax_matmul_argmax(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    before = matmul_argmax.launches
    ids = matmul_argmax(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    assert matmul_argmax.launches == before  # the CPU takes the twin
    assert ids.shape == (1, 16, 64) and ids.dtype == np.int32
    logits = x @ w + b
    sure = sure_pixels(logits, MARGIN)
    np.testing.assert_array_equal(ids[sure], ref[sure])
    if tied:
        top = logits.argmax(-1) == 2
        assert top.mean() > 0.3
        np.testing.assert_array_equal(ids[top], 2)
        np.testing.assert_array_equal(ref[top], 2)


@pytest.mark.parametrize("n_embeds, ec, dilations", [(4, 128, (6, 12, 18)), (1, 256, (6,))])
def test_dw_branches_twin_matches_jax_kernel(n_embeds, ec, dilations):
    rng = np.random.default_rng(n_embeds)
    c, nd = n_embeds * ec, len(dilations)
    embeds = [rng.normal(size=(1, 48, 64, ec)).astype(np.float32) for _ in range(n_embeds)]
    w = rng.normal(size=(nd, 3, 3, c)).astype(np.float32) * 0.3
    s = rng.uniform(0.5, 1.5, size=(nd, c)).astype(np.float32)
    b = rng.normal(size=(nd, c)).astype(np.float32) * 0.1
    ref = jax_dw_branches([jnp.asarray(e) for e in embeds], jnp.asarray(w), jnp.asarray(s),
                          jnp.asarray(b), dilations, interpret=True)
    before = dw_branches.launches
    outs = dw_branches([torch.from_numpy(e) for e in embeds], torch.from_numpy(w),
                       torch.from_numpy(s), torch.from_numpy(b), dilations)
    assert dw_branches.launches == before
    assert len(outs) == nd
    for out, r in zip(outs, ref):
        assert out.shape == (1, 48, 64, c) and out.dtype == torch.float32
        # 9-term fp32 sums of O(1) terms
        np.testing.assert_allclose(out.numpy(), np.asarray(r), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def head_pair():
    """A JAX DAFormer head with live ReLUs and distinct classes (BN
    statistics around (0, 1), conv_seg at O(1)), the port's head on its
    weights, and features for both."""
    rng = np.random.default_rng(4)
    shapes = {"s0": (1, 48, 64, 32), "s3": (1, 6, 8, 48), "s4": (1, 3, 4, 64), "s5": (1, 2, 2, 80)}
    feats = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    head = JaxDAFormerHead(in_keys=IN_KEYS, num_classes=11, dtype=jnp.float32)
    variables = head.init(jax.random.PRNGKey(0), jfeats)
    r = np.random.default_rng(1)
    bn = {}
    for path, x in jax.tree_util.tree_leaves_with_path(variables["batch_stats"]):
        lo, hi = (-0.1, 0.1) if path[-1].key == "mean" else (0.5, 1.5)
        node = bn
        for p in path[:-1]:
            node = node.setdefault(p.key, {})
        node[path[-1].key] = jnp.asarray(r.uniform(lo, hi, x.shape).astype(np.float32))
    params = dict(variables["params"])
    params["conv_seg"] = {"kernel": params["conv_seg"]["kernel"] * 100.0,
                          "bias": params["conv_seg"]["bias"]}
    logits = np.asarray(head.apply({"params": params, "batch_stats": bn}, jfeats, train=False))
    sd = state_dict_from_jax({"params": {"head": params}, "state": {"head_bn": bn}})
    port = DAFormerHead([s[-1] for s in shapes.values()], IN_KEYS, 11)
    port.load_state_dict({k.removeprefix("sem_seg_head."): v for k, v in sd.items()})
    tfeats = {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats.items()}
    return head, params, bn, jfeats, logits, port, tfeats


def _assert_ids_match(ids, ref_ids, logits):
    assert ids.shape == ref_ids.shape and ids.dtype == np.int32
    sure = sure_pixels(logits, MARGIN * np.abs(logits).max())
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(ids[sure], ref_ids[sure])
    assert (ids == ref_ids).mean() > 0.999


def test_full_head_matches_jax(head_pair, monkeypatch):
    """The 'full' head (K6 and K7 twins) against JAX ``fused_head_forward``
    on its Pallas depthwise route."""
    _, params, bn, jfeats, logits, port, tfeats = head_pair
    monkeypatch.setenv("MADM_DW_IMPL", "pallas")
    ref = np.asarray(jax_fused_head_forward(params, bn, jfeats, IN_KEYS, 11,
                                            compute_dtype=jnp.float32, interpret=True))
    with torch.no_grad():
        ids = fused_head_forward(port, tfeats).numpy()
    _assert_ids_match(ids, ref, logits)


def test_argmax_head_matches_jax(head_pair):
    """The 'argmax' head against JAX ``head_forward(return_pre_seg=True)``
    and ``matmul_argmax``."""
    head, params, bn, jfeats, logits, port, tfeats = head_pair
    pre = head.apply({"params": params, "batch_stats": bn}, jfeats, train=False, return_pre_seg=True)
    cs = params["conv_seg"]
    ref = np.asarray(jax_matmul_argmax(pre, cs["kernel"][0, 0], cs["bias"], interpret=True))
    with torch.no_grad():
        pre_port = port(tfeats, return_pre_seg=True)
        ids = argmax_head_forward(port, tfeats).numpy()
    np.testing.assert_allclose(pre_port.permute(0, 2, 3, 1).numpy(), np.asarray(pre), atol=1e-4, rtol=0)
    _assert_ids_match(ids, ref, logits)


def _toy(**kw):
    return MADM(MADMConfig(**{**TOY, **kw, "compute_dtype": torch.float32}), device="cpu")


def test_eval_head_mode_follows_the_head():
    model = _toy()
    assert model.eval_head_mode() == "aspp"  # 'auto' on a head that fits K2
    assert [model.eval_head_mode(m) for m in MODES] == list(MODES)
    assert _toy(eval_head="full").eval_head_mode() == "full"
    with pytest.raises(ValueError):
        MADMConfig(**TOY, eval_head="fused")
    with pytest.raises(ValueError):
        model.eval_head_mode("fused")


@pytest.mark.parametrize("mode", ["aspp", "argmax", "full"])
def test_eval_head_asked_for_by_name_that_does_not_fit_raises(mode):
    """A head whose first input is not s0 runs below image resolution:
    'auto' takes the module head, a kernel head asked for by name raises."""
    model = _toy(in_keys=("s3", "s0", "s4", "s5"))
    assert model.eval_head_mode() == "none"
    with pytest.raises(ValueError, match=mode):
        model.eval_head_mode(mode)
    with pytest.raises(ValueError):
        model.eval_forward_ids(torch.zeros(1, 64, 64, 3), eval_head=mode)


@pytest.mark.parametrize("name", ["dw_branches", "matmul_argmax"])
def test_wrappers_refuse_non_cpu_tensors(name):
    """A tensor on neither the CPU nor CUDA reaches the kernel launcher,
    which raises (it never falls back to the twin)."""
    if name == "dw_branches":
        e = torch.empty(1, 8, 8, 256, device="meta")
        w, s = torch.empty(1, 3, 3, 256), torch.empty(1, 256)
        with pytest.raises(ValueError, match="CUDA"):
            dw_branches([e], w, s, s, (6,))
    else:
        x = torch.empty(1, 8, 8, 256, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            matmul_argmax(x, torch.empty(256, 11), torch.empty(11))


@pytest.fixture(scope="module")
def trainable_models():
    """Trainable toys (fp32 masters, EMA teacher) in bf16 and in fp32
    compute, and an eval model, all on the same weights."""
    cfg = MADMConfig(**TOY, compute_dtype=torch.float32)
    m32 = init_random_(MADM(cfg, device="cpu", trainable=True), torch.Generator().manual_seed(0))
    m16 = MADM(dataclasses.replace(cfg, compute_dtype=torch.bfloat16), device="cpu", trainable=True)
    m16.load_state_dict(m32.state_dict())
    plain = MADM(cfg, device="cpu")
    plain.load_state_dict({k: v for k, v in m32.state_dict().items() if not k.startswith("ema.")})
    with torch.no_grad():  # a teacher that differs from the student: eval must not read it
        for p in m32.ema.parameters():
            p.add_(1.0)
    images = torch.from_numpy(np.random.default_rng(7).uniform(size=(2, 64, 64, 3)).astype(np.float32))
    return m16, m32, plain, images


@pytest.mark.parametrize("mode", MODES)
def test_trainable_bf16_model_evaluates_in_every_head_mode(trainable_models, mode):
    """Eval passes of a bf16 trainable model run through compute-dtype casts
    of the fp32 masters, BN in fp32."""
    m16, _, _, images = trainable_models
    ids = m16.eval_forward_ids(images, eval_head=mode)
    assert ids.shape == (2, 64, 64) and ids.dtype == torch.int32
    assert 0 <= int(ids.min()) and int(ids.max()) < TOY["num_classes"]
    assert all(p.dtype == torch.float32 for p in m16.sem_seg_head.parameters())  # masters untouched


def test_trainable_bf16_model_logits_are_finite(trainable_models):
    m16, _, _, images = trainable_models
    logits = m16.eval_forward(images)
    assert logits.shape == (2, 64, 64, 11) and torch.isfinite(logits).all()


@pytest.mark.parametrize("mode", MODES)
def test_trainable_fp32_model_ids_equal_eval_model(trainable_models, mode):
    _, m32, plain, images = trainable_models
    np.testing.assert_array_equal(m32.eval_forward_ids(images, eval_head=mode).numpy(),
                                  plain.eval_forward_ids(images, eval_head=mode).numpy())
