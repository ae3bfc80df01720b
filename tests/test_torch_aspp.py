"""Kernel K2's module in the PyTorch port: ``aspp_fused``'s CPU twin against
the JAX fused sep-ASPP kernel in Pallas interpret mode, and the port's
``aspp_head_forward`` against the JAX one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.models.daformer import DAFormerHead as JaxDAFormerHead
from madm_tpu.ops.aspp import aspp_fused as jax_aspp_fused
from madm_tpu.ops.aspp import aspp_head_forward as jax_aspp_head_forward
from madm_torch.checkpoint.from_jax import state_dict_from_jax
from madm_torch.models.daformer import DAFormerHead
from madm_torch.ops.aspp import aspp_fused, aspp_head_forward, fits_kernel

IN_KEYS = ("s0", "s3", "s4", "s5")


def test_twin_matches_jax_aspp_fused_kernel():
    """2 embeds x 128 channels, 16 x 32 pixels, 32 output channels per branch."""
    rng = np.random.default_rng(3)
    c, pc = 256, 32
    embeds = [rng.normal(size=(1, 16, 32, 128)).astype(np.float32) for _ in range(2)]

    def f(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    args = [f(3, 3, 3, c, scale=0.3), f(3, c), f(3, c), f(3, c, pc, scale=0.1), f(3, pc),
            f(3, pc), f(c, pc, scale=0.1), f(pc), f(pc)]
    ref = np.asarray(jax_aspp_fused([jnp.asarray(e) for e in embeds],
                                    *[jnp.asarray(a) for a in args], (6, 12, 18),
                                    interpret=True))
    before = aspp_fused.launches
    out = aspp_fused([torch.from_numpy(e) for e in embeds], *[torch.from_numpy(a) for a in args])
    assert out.shape == (1, 16, 32, 4 * pc)
    # fp32 both sides, sums of <= 2 * 256 terms of magnitude ~1: 1e-6 relative
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6 * np.abs(ref).max(), rtol=0)
    assert aspp_fused.launches == before


def test_wrapper_refuses_non_cpu_tensors():
    e = torch.empty(1, 8, 8, 256, device="meta")
    w = torch.empty(0)
    with pytest.raises(ValueError):
        aspp_fused([e] * 4, w, w, w, w, w, w, w, w, w)


def test_aspp_head_forward_matches_jax():
    """The eval head through ``aspp_fused`` (CPU twin) gives the JAX
    ``aspp_head_forward`` ids, at the shapes of the JAX package's own test."""
    rng = np.random.default_rng(4)
    shapes = {"s0": (1, 64, 128, 32), "s3": (1, 8, 16, 48), "s4": (1, 4, 8, 64),
              "s5": (1, 2, 4, 80)}
    feats = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    head = JaxDAFormerHead(in_keys=IN_KEYS, num_classes=11, dtype=jnp.float32)
    variables = head.init(jax.random.PRNGKey(0), jfeats)
    # live ReLUs and distinct classes: BN statistics around (0, 1), conv_seg at O(1)
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
    ref_ids = np.asarray(jax_aspp_head_forward(params, bn, jfeats, IN_KEYS, 11,
                                               compute_dtype=jnp.float32, interpret=True))

    sd = state_dict_from_jax({"params": {"head": params}, "state": {"head_bn": bn}})
    port = DAFormerHead([s[-1] for s in shapes.values()], IN_KEYS, 11)
    port.load_state_dict({k.removeprefix("sem_seg_head."): v for k, v in sd.items()})
    assert fits_kernel(port)
    with torch.no_grad():
        ids = aspp_head_forward(port, {k: torch.from_numpy(v).permute(0, 3, 1, 2)
                                       for k, v in feats.items()}).numpy()
    assert ids.shape == (1, 64, 128) and ids.dtype == np.int32
    top2 = np.sort(logits, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > 1e-4 * np.abs(logits).max()  # fp32 logit error ~1e-6 rel.
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(ids[sure], ref_ids[sure])
    assert (ids == ref_ids).mean() > 0.999
