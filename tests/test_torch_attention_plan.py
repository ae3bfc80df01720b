"""Launch plans of kernels K1 and K3 (flash-attention forward and backward
on Hopper) on the CPU: ``forward_plan`` and ``backward_plan`` are pure
functions of shape, strides and dtype that the wrappers go by and that
``chip_smoke.py`` holds to the C libraries' own choice on the card.  Here:
every plan at the main path's shapes fits the card, fills it where it says
so, computes each score once, refuses what TMA cannot address; and K3's
split dK/dV sum, in its fixed order, agrees with the plain backward."""

import numpy as np
import pytest
import torch

from chip_smoke import FLASH_SHAPES
from madm_torch.ops.flash_attention import (
    SM_COUNT,
    SMEM_LIMIT,
    attention_backward_reference,
    backward_plan,
    flash_attention_backward,
    forward_plan,
    split_dkdv_reference,
)

SHAPES = [pytest.param(b, *s[:4], id=f"B{b}-" + "x".join(map(str, s[:4])))
          for s in FLASH_SHAPES for b in (1, 2)]
BWD_SHAPES = [p for p in SHAPES if p.values[4] <= 160]


def contiguous(b, s, h, d, ptr=0):
    return (ptr, (s * h * d, h * d, d))


@pytest.mark.parametrize("b,sq,sk,h,d", SHAPES)
def test_forward_plan_fits_the_card(b, sq, sk, h, d):
    plan = forward_plan(b, sq, sk, h, d, torch.bfloat16,
                        [contiguous(b, s, h, d) for s in (sq, sk, sk)])
    assert plan.body == "tma_wgmma"
    (launch,) = plan.launches
    assert launch.smem <= SMEM_LIMIT
    assert launch.threads == 128 * plan.warpgroups + 32  # consumer warpgroups + producer warp
    assert plan.dn >= d and plan.dn % 16 == 0
    # every query row is one block's, once; the grid covers Sq, H and B
    assert launch.grid == (-(-sq // plan.bq), h, b)
    if plan.fills_card:
        assert launch.blocks >= SM_COUNT
    # 128-row tiles only where they still fill the card, else 64 rows for more blocks
    if not plan.split_d:
        assert (plan.bq == 128) == (-(-sq // 128) * h * b >= SM_COUNT)
    # the scores are computed once: the D=512 VAE attention splits D over the
    # two warpgroups of one block instead of recomputing QK^T per output chunk
    assert plan.score_copies == 1
    assert plan.split_d == (d == 512)
    if d == 512:
        assert plan.bq == 64 and plan.warpgroups == 2 and launch.grid[1] == h
    # a 77-key cross-attention is one 80-key tile, not two of 64
    if sk == 77:
        assert plan.bk == 80


@pytest.mark.parametrize("b,sq,sk,h,d", BWD_SHAPES)
def test_backward_plan_fits_the_card(b, sq, sk, h, d):
    plan = backward_plan(b, sq, sk, h, d, torch.bfloat16, [0] * 7)
    assert plan.body == "tma_wgmma"
    kinds = [l.kernel for l in plan.launches]
    assert kinds == ["bwd_prep", "dkdv_tma"] + (["dkdv_reduce"] if plan.nsplit > 1 else []) + ["dq_tma"]
    assert all(l.smem <= SMEM_LIMIT for l in plan.launches)
    dkdv = plan.launches[1]
    nqt, nkt = -(-sq // plan.bq), -(-sk // plan.bk)
    assert plan.bk == 64 * plan.warpgroups and dkdv.threads == 128 * plan.warpgroups + 32
    assert dkdv.grid == (nkt, h, b * plan.nsplit)
    # the split: only where the key tiles alone leave SMs idle, at least two q tiles a split
    if nkt * h * b >= SM_COUNT:
        assert plan.nsplit == 1
    else:
        assert 1 <= plan.nsplit <= max(1, nqt // 2)
        assert plan.nsplit == max(1, min(-(-SM_COUNT // (nkt * h * b)), nqt // 2))
    if plan.fills_card:
        assert all(l.blocks >= SM_COUNT for l in plan.launches if l.kernel.endswith("_tma"))
    # the workspace holds lse2 and delta [B*H, Sqp], the scaled q, and the partials
    assert plan.sqp % 128 == 0 and plan.sqp >= sq
    need = 8 * b * h * plan.sqp + 2 * b * sq * h * d
    if plan.nsplit > 1:
        need += 2 * plan.nsplit * 4 * b * sk * h * d
    assert plan.workspace_bytes >= need
    assert plan.score_copies == 1


def test_cross_attention_backward_fills_the_card():
    """The 77-key cross-attention at Sq=4096 (one key tile a head) splits its
    query loop until at least 132 blocks run at B=1."""
    plan = backward_plan(1, 4096, 77, 8, 40, torch.bfloat16, [0] * 7)
    assert plan.nsplit > 1 and plan.fills_card
    assert plan.launches[1].blocks >= SM_COUNT


@pytest.mark.parametrize("b,sq,sk,h,d", SHAPES[:4])
@pytest.mark.parametrize("fault", ["base", "seq_stride", "batch_stride", "head_stride"])
def test_forward_plan_refuses_what_tma_cannot_address(b, sq, sk, h, d, fault):
    good = [contiguous(b, s, h, d) for s in (sq, sk, sk)]
    forward_plan(b, sq, sk, h, d, torch.bfloat16, good)  # accepted as is
    ptr, (sb, ss, sh) = good[1]
    if fault == "base":
        bad = (ptr + 8, (sb, ss, sh))  # 8-byte aligned only
    elif fault == "seq_stride":
        bad = (ptr, (sb, ss + 4, sh))  # 8 bytes more a row
    elif fault == "batch_stride":
        bad = (ptr, (sb + 4, ss, sh))
        if b == 1:  # B=1 never steps the batch stride
            forward_plan(b, sq, sk, h, d, torch.bfloat16, [good[0], bad, good[2]])
            return
    else:
        bad = (ptr, (sb, ss, d + 4))  # heads not side by side, 2*(D+4) bytes apart
    with pytest.raises(ValueError, match="16"):
        forward_plan(b, sq, sk, h, d, torch.bfloat16, [good[0], bad, good[2]])


def test_plans_refuse_head_dims_off_the_tma_grid():
    with pytest.raises(ValueError, match="divisible by 8"):
        forward_plan(1, 64, 64, 2, 36, torch.bfloat16, [contiguous(1, 64, 2, 36)] * 3)
    with pytest.raises(ValueError, match="divisible by 8"):
        backward_plan(1, 64, 64, 2, 36, torch.bfloat16, [0] * 7)
    with pytest.raises(ValueError, match="aligned"):
        backward_plan(1, 64, 64, 2, 40, torch.bfloat16, [0, 0, 0, 4, 0, 0, 0])
    # float32 takes the SIMT bodies, whatever the alignment
    assert forward_plan(1, 64, 64, 2, 36, torch.float32).body == "simt"
    assert backward_plan(1, 64, 64, 2, 36, torch.float32).body == "simt"


@pytest.mark.parametrize("sq,sk,h,d", [(256, 77, 2, 40), (320, 64, 1, 80), (192, 130, 2, 16)])
@pytest.mark.parametrize("nsplit", [None, 1, 3])
def test_split_dkdv_sum_matches_the_plain_backward(sq, sk, h, d, nsplit):
    """K3's split dK/dV in fp32: each split's partial over its run of q tiles,
    added in split order, equals the unsplit gradient within fp32 rounding."""
    rng = np.random.default_rng(sq + sk + d)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(1, s, h, d)).astype(np.float32))
                  for s in (sq, sk, sk, sq))
    plan = backward_plan(1, sq, sk, h, d, torch.bfloat16, [0] * 7)
    n = plan.nsplit if nsplit is None else nsplit
    dk, dv = split_dkdv_reference(q, k, v, g, d ** -0.5, n, plan.bq)
    _, dk_ref, dv_ref = attention_backward_reference(q, k, v, g, d ** -0.5)
    np.testing.assert_allclose(dk.numpy(), dk_ref.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(dv.numpy(), dv_ref.numpy(), atol=1e-5, rtol=0)


def test_split_runs_cover_every_q_tile_once():
    """The kernel's split s takes q tiles [s*nqt//n, (s+1)*nqt//n): every
    tile once, none empty, for every split count the plans choose."""
    for b, sq, sk, h, d in (p.values for p in BWD_SHAPES):
        plan = backward_plan(b, sq, sk, h, d, torch.bfloat16, [0] * 7)
        nqt, n = -(-sq // plan.bq), plan.nsplit
        runs = [(s * nqt // n, (s + 1) * nqt // n) for s in range(n)]
        assert all(t1 > t0 for t0, t1 in runs)
        assert [t for t0, t1 in runs for t in range(t0, t1)] == list(range(nqt))


def test_backward_wrapper_checks_alignment_before_the_card():
    """The wrapper raises for input its kernels do not take before any launch
    (here a meta tensor, which is not a CUDA tensor)."""
    q = torch.empty(1, 64, 2, 40, device="meta", dtype=torch.bfloat16)
    lse = torch.empty(1, 2, 64, device="meta")
    before = flash_attention_backward.launches
    with pytest.raises(ValueError):
        flash_attention_backward(q, q, q, q, q, lse, 40 ** -0.5)
    assert flash_attention_backward.launches == before
