"""Launch plans of kernels K4 and K5 (the packed-head attention forward and
backward on Hopper) on the CPU: ``packed_forward_plan`` and
``packed_backward_plan`` are pure functions of shape, strides and dtype that
the wrappers go by and that ``chip_smoke.py`` holds to the C libraries'
own choice on the card (``madm_packed_attention_fwd_plan``,
``madm_packed_attention_bwd_plan``).  Here: the bf16 plans are K1's TMA body
in its two-pass mode and K3's kernels at Sq == Sk; every plan at the packed
shapes fits the card, fills it at the UNet's [1|2, 4096, 8, 40], launches a
producer warp beside its consumer warpgroups, and refuses what TMA cannot
address or the packing rule does not pack."""

import dataclasses

import pytest
import torch

from chip_smoke import PACKED_SHAPES
from madm_torch.ops.flash_attention import (
    SM_COUNT,
    SMEM_LIMIT,
    backward_plan,
    forward_plan,
    pack_group,
    packed_attention_backward,
    packed_attention_forward,
    packed_backward_plan,
    packed_forward_plan,
)

SM_SMEM = 233_472  # shared memory of an H100 SM, for K4's two blocks

# (B, S, H, D): the UNet's packed self-attention (S=4096, D=40) at B=1 and 2,
# its S=1024 level at a 256x256 crop, the toy widths' D=4/8 heads, D=64
# (the widest that packs, padded to 80)
SHAPES = [pytest.param(*s, id="x".join(map(str, s))) for s in
          (*PACKED_SHAPES, (1, 1024, 8, 40), (2, 1024, 8, 8), (1, 1024, 8, 4), (2, 2048, 4, 64))]


def contiguous(b, s, h, d, ptr=0):
    return (ptr, (s * h * d, h * d, d))


def bf16_shapes():
    return [p for p in SHAPES if p.values[3] % 8 == 0]


@pytest.mark.parametrize("b,s,h,d", bf16_shapes())
def test_forward_plan_is_k1s_body_in_two_passes(b, s, h, d):
    plan = packed_forward_plan(b, s, h, d, torch.bfloat16, [contiguous(b, s, h, d)] * 3,
                               g=pack_group(s, s, d, True))
    k1 = forward_plan(b, s, s, h, d, torch.bfloat16)
    assert plan.kernel == "K4" and plan.body == "tma_wgmma_two_pass"
    # K1's rows, warpgroups, D padding and ring at 64-key tiles
    assert dataclasses.replace(plan, kernel="K1", body="tma_wgmma", bk=k1.bk, launches=k1.launches) == k1
    assert plan.bk == 64
    (launch,) = plan.launches
    assert launch.kernel == "packed_fwd_tma"
    assert dataclasses.replace(launch, kernel=k1.launches[0].kernel, smem=k1.launches[0].smem) == k1.launches[0]
    # one head a block's warpgroups whatever G: the grid is K1's, one score copy
    assert launch.grid == (-(-s // plan.bq), h, b) and plan.score_copies == 1
    assert not plan.split_d and plan.dn == (48 if d <= 48 else 80)
    # two blocks an SM: their shared memory (and 1 KB each the card reserves) fits
    assert 2 * (launch.smem + 1024) <= SM_SMEM


@pytest.mark.parametrize("b,s,h,d", bf16_shapes())
def test_backward_plan_is_k3s_kernels(b, s, h, d):
    plan = packed_backward_plan(b, s, h, d, torch.bfloat16, [0] * 7)
    assert plan.kernel == "K5" and plan.body == "tma_wgmma"
    assert dataclasses.replace(plan, kernel="K3") == backward_plan(b, s, s, h, d, torch.bfloat16)
    names = [l.kernel for l in plan.launches]
    assert names == ["bwd_prep", "dkdv_tma"] + (["dkdv_reduce"] if plan.nsplit > 1 else []) + ["dq_tma"]
    assert plan.workspace_bytes > 0


@pytest.mark.parametrize("b,s,h,d", bf16_shapes())
def test_bf16_plans_fit_the_card(b, s, h, d):
    for plan in (packed_forward_plan(b, s, h, d, torch.bfloat16), packed_backward_plan(b, s, h, d, torch.bfloat16)):
        for launch in plan.launches:
            assert launch.smem <= SMEM_LIMIT, (plan.kernel, launch)
            if launch.kernel.endswith("_tma"):  # consumer warpgroups and one producer warp
                assert launch.threads % 128 == 32 and 1 <= launch.threads // 128 <= 2
        assert plan.dn >= d and plan.dn % 16 == 0


@pytest.mark.parametrize("b,s,h,d", PACKED_SHAPES)
def test_plans_fill_the_card_at_the_unet_shape(b, s, h, d):
    fwd = packed_forward_plan(b, s, h, d, torch.bfloat16)
    bwd = packed_backward_plan(b, s, h, d, torch.bfloat16)
    assert fwd.fills_card and fwd.launches[0].blocks >= SM_COUNT
    assert bwd.fills_card and bwd.nsplit == 1
    # 128-row tiles (two consumer warpgroups, 288 threads) still give >= 132 blocks
    assert fwd.bq == 128 and fwd.warpgroups == 2 and fwd.launches[0].threads == 288
    assert fwd.bk == 64 and fwd.stages == 2


@pytest.mark.parametrize("b,s,h,d", SHAPES)
def test_fp32_plans_are_the_simt_bodies(b, s, h, d):
    g = pack_group(s, s, d, True)
    fwd = packed_forward_plan(b, s, h, d, torch.float32, g=g)
    bwd = packed_backward_plan(b, s, h, d, torch.float32, g=g)
    assert fwd.body == bwd.body == "simt"
    # one thread a (row, head), G heads a block, the last group ragged
    grid = (s // 64, -(-h // g), b)
    assert [l.grid for l in fwd.launches + bwd.launches] == [grid] * 3
    assert all(l.threads == 64 * g and l.smem <= SMEM_LIMIT for l in fwd.launches + bwd.launches)
    assert bwd.workspace_bytes == 2 * 4 * b * h * s  # base-2 lse and delta, fp32 [B, H, S]


@pytest.mark.parametrize("fault", ["base", "seq_stride", "batch_stride"])
def test_forward_plan_refuses_what_tma_cannot_address(fault):
    b, s, h, d = 2, 1024, 8, 40
    ptr, (sb, ss, sh) = contiguous(b, s, h, d)
    if fault == "base":
        ptr = 8
    elif fault == "seq_stride":
        ss += 4
    else:
        sb += 4
    with pytest.raises(ValueError, match="bf16"):
        packed_forward_plan(b, s, h, d, torch.bfloat16, [contiguous(b, s, h, d), (ptr, (sb, ss, sh))])
    # the fp32 body takes what it is given
    packed_forward_plan(b, s, h, d, torch.float32, [(ptr, (sb, ss, sh))])


def test_backward_plan_refuses_a_misaligned_tensor():
    with pytest.raises(ValueError, match="16-byte"):
        packed_backward_plan(1, 1024, 8, 40, torch.bfloat16, [0, 0, 0, 24, 0, 0, 0])


@pytest.mark.parametrize("s,h,d,g", [(1024, 8, 80, 1), (1024, 8, 40, 4), (1000, 8, 40, 3), (1024, 8, 12, 4)])
def test_plans_refuse_what_does_not_pack(s, h, d, g):
    """D > 64, more heads a block than 128 // D, S not a multiple of 64, and
    (bf16) a head dim off the TMA grid."""
    with pytest.raises(ValueError):
        packed_forward_plan(1, s, h, d, torch.bfloat16, g=g)
    with pytest.raises(ValueError):
        packed_backward_plan(1, s, h, d, torch.bfloat16, g=g)


def test_wrappers_refuse_cpu_tensors_and_check_before_the_card():
    """The kernel wrappers take CUDA tensors only; the CPU backward is the
    twin, whatever saved o and lse it is handed."""
    q = torch.zeros(1, 1024, 8, 40, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        packed_attention_forward(q, q, q, 40 ** -0.5, 3, with_lse=True)
    dq, dk, dv = packed_attention_backward(q, q, q, q, 40 ** -0.5, 3, o=q, lse=None)
    assert dq.dtype == torch.bfloat16 and not dq.any() and not dk.any() and not dv.any()
