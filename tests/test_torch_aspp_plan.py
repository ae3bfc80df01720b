"""Launch plan of kernel K2 (the fused sep-ASPP layer on Hopper) on the CPU:
``aspp_plan`` is a pure function of shape, dilations and dtype that the
wrapper goes by and that ``chip_smoke.py`` holds to the C library's own
choice on the card.  Here: every plan fits the card and the TMA rules, its
blocks cover each (image, pixel, branch) once with the four branches of a
tile side by side in launch order, a tile's row-to-pixel map is a
permutation whose lanes read distinct banks, what the body does not take
is refused; and an emulation of one tile's depthwise, from TMA boxes with
zeros outside the image and the kernel's swizzled addressing, equals the
plain twin's at the image borders."""

import numpy as np
import pytest
import torch

from madm_torch.ops.aspp import (
    TMA_STAGES,
    aspp_fused_reference,
    aspp_plan,
    depthwise_reference,
    tma_maps,
)
from madm_torch.ops.flash_attention import SMEM_LIMIT

DILS = (6, 12, 18)
# (B, H, W, EC, n_embeds, dilations): the eval crop at B=1 and 2, the slide
# head's stitched width, and ragged toy shapes
SHAPES = [
    pytest.param(1, 512, 512, 256, 4, DILS, id="1x512x512"),
    pytest.param(2, 512, 512, 256, 4, DILS, id="2x512x512"),
    pytest.param(1, 512, 1024, 256, 4, DILS, id="1x512x1024"),
    pytest.param(1, 7, 100, 64, 2, (24, 5, 2), id="1x7x100-d24"),
    pytest.param(3, 37, 65, 128, 1, (1, 2, 3), id="3x37x65-d1"),
    pytest.param(1, 1, 1, 64, 4, (24, 24, 24), id="1x1x1-d24"),
    pytest.param(2, 50, 200, 192, 3, (7, 13, 19), id="2x50x200"),
]
SMALL = [p for p in SHAPES if p.values[1] * p.values[2] <= 64 * 256]


def plan_of(b, h, w, ec, n, dils):
    return aspp_plan(b, h, w, ec, n, dils, torch.bfloat16)


@pytest.mark.parametrize("b,h,w,ec,n,dils", SHAPES)
def test_plan_fits_the_card_and_tma(b, h, w, ec, n, dils):
    plan = plan_of(b, h, w, ec, n, dils)
    assert plan.body == "tma_wgmma" and plan.threads == 256 and plan.stages == TMA_STAGES
    assert plan.smem <= SMEM_LIMIT
    assert plan.grid == (4 * max(plan.row_pairs) * plan.strips, b, 1) and plan.grid[0] < 2 ** 31
    assert plan.strips == -(-w // plan.tile_cols) and 1 <= plan.group <= max(1, plan.strips)
    assert len(plan.c_plan()) == 15
    for name, dims, strides, box in tma_maps(b, h, w, ec, n, dils):
        assert all(s % 16 == 0 and s < 2 ** 40 for s in strides), (name, strides)
        assert all(1 <= x <= 256 for x in box), (name, box)
        assert box[0] * 2 == 128, name  # a box row is one 128-byte swizzle span
    for br in range(4):
        for _, _, _, width in plan.halo_boxes(br, 0, 0):
            assert width <= 256


@pytest.mark.parametrize("b,h,w,ec,n,dils", SHAPES)
def test_blocks_cover_each_pixel_once_branches_adjacent(b, h, w, ec, n, dils):
    plan = plan_of(b, h, w, ec, n, dils)
    blocks = list(plan.blocks())
    assert len(blocks) == plan.grid[0]
    # the four branches of a tile are adjacent in launch order
    for i in range(0, len(blocks), 4):
        quad = blocks[i:i + 4]
        assert len({(blk[1], blk[2]) for blk in quad if blk is not None}) <= 1
        assert all(blk is None or blk[0] == j for j, blk in enumerate(quad))
    # every (pixel, branch) of an image exactly once; grid y is the image
    count = torch.zeros(4, h, w, dtype=torch.int32)
    by_branch = {br: [] for br in range(4)}
    for blk in blocks:
        if blk is not None:
            by_branch[blk[0]].append(blk)
    for br, tiles in by_branch.items():
        assert len(tiles) == plan.row_pairs[br] * plan.strips
        px = torch.cat([plan.tile_pixels(*t) for t in tiles])
        inside = (px[:, 0] < h) & (px[:, 1] < w)
        assert (px >= 0).all()
        flat = px[inside, 0] * w + px[inside, 1]
        count[br].view(-1).index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    assert (count == 1).all()


@pytest.mark.parametrize("b,h,w,ec,n,dils", SHAPES)
def test_tile_rows_are_a_permutation_with_distinct_banks(b, h, w, ec, n, dils):
    plan = plan_of(b, h, w, ec, n, dils)
    for br in range(4):
        for k, strip in ((0, 0), (plan.row_pairs[br] - 1, plan.strips - 1)):
            px = plan.tile_pixels(br, k, strip)
            assert len({tuple(p) for p in px.tolist()}) == 128  # a permutation of the tile
            y, x0 = plan.tile_row(br, k), strip * plan.tile_cols
            assert set(px[:, 0].tolist()) == {y, y + plan.pairs[br]}
            assert set(px[:, 1].tolist()) == set(range(x0, x0 + 64))
            rows = px.view(2, 4, 2, 8, 2)  # [warpgroup][warp][g or g+8][g][row, column]
            if br > 0:  # a thread's two rows: (y, x) and (y + d, x), sharing halo rows
                assert (rows[:, :, 1, :, 0] - rows[:, :, 0, :, 0] == plan.pairs[br]).all()
                assert (rows[:, :, 1, :, 1] == rows[:, :, 0, :, 1]).all()
            # lanes g = 0..7 read 8 columns distinct mod 8: 8 distinct swizzled units
            assert (torch.sort(rows[..., 1] % 8, dim=-1).values == torch.arange(8)).all()


@pytest.mark.parametrize("kw,match", [
    (dict(ec=32), "multiple of 64"),
    (dict(n=5), "1-4 embeds"),
    (dict(dils=(6, 12, 25)), "dilations"),
    (dict(dils=(0, 12, 18)), "dilations"),
    (dict(dils=(6, 12)), "3 dilations"),
    (dict(b=65536), "batch"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
])
def test_plan_refuses_what_the_body_does_not_take(kw, match):
    args = dict(b=1, h=8, w=8, ec=64, n=4, dils=DILS, dtype=torch.bfloat16) | kw
    with pytest.raises(ValueError, match=match):
        aspp_plan(args["b"], args["h"], args["w"], args["ec"], args["n"], args["dils"], args["dtype"])


def test_float32_plan_keeps_32_channel_embeds():
    plan = aspp_plan(2, 9, 70, 32, 3, DILS, torch.float32)
    assert plan.body == "simt" and plan.grid == (9 * 2, 4, 2) and plan.chunk == 32
    assert plan.c_plan() == [64, 1, 32, 1, 256, 0, 18, 4, 2, 2, 0, 9, 9, 9, 9]


def test_profile_ablations_apply_to_the_kernel():
    """``python -m madm_torch.profile_aspp --ablate`` edits csrc/aspp_fused.cu
    by its lines: each ablated build it times must still find them."""
    from madm_torch import kernels
    from madm_torch.profile_aspp import ABLATE_RUNS, ablated_source

    src = (kernels.CSRC / "aspp_fused.cu").read_text()
    outs = {run: ablated_source(src, run.split("+")) for run in ABLATE_RUNS}
    assert all(out != src for out in outs.values()) and len(set(outs.values())) == len(outs)


def test_block_order_keeps_the_live_rows_in_l2():
    """The eval crop and the slide head's width walk column strips in
    groups narrower than the image, so that ~3d rows of a group stay in L2."""
    for w in (512, 1024):
        plan = plan_of(1, 512, w, 256, 4, DILS)
        assert 1 < plan.group < plan.strips
        seen = [blk[2] for blk in plan.blocks() if blk is not None][: 4 * plan.group * 64]
        assert max(seen) < plan.group  # the first 64 row pairs stay in the first group


# ---------------------------------------------------- emulation of one tile
def swizzled_box(x, row, col0, width, b, ch0):
    """A TMA box of embed x [B, H, W, C] as the kernel's shared memory holds
    it: [width pixels][64 channels] of image row ``row`` from column col0,
    zeros outside the image, each pixel's 16-byte units (8 channels) placed
    by the 128-byte swizzle (unit u of box row j at u ^ (j & 7))."""
    _, h, w, _ = x.shape
    box = torch.zeros(width, 64)
    cols = torch.arange(col0, col0 + width)
    ok = (cols >= 0) & (cols < w)
    if 0 <= row < h:
        box[ok] = x[b, row, cols[ok], ch0:ch0 + 64]
    units = box.view(width, 8, 8)
    out = torch.empty_like(units)
    for j in range(width):
        out[j, torch.arange(8) ^ (j & 7)] = units[j]
    return out.view(width, 64)


def emulate_tile_depthwise(plan, x, taps, bias, br, k, strip, b, ch0):
    """The depthwise outputs that a dilated tile's threads put into their A
    fragments for the 64-channel chunk from concat channel ch0, before the
    bf16 rounding: [128 accumulator rows][64 channels] fp32.  Read from the
    swizzled boxes with the kernel's offsets: thread (warpgroup, warp, lane
    = 4g + tg) reads slot ky (row g, pixel (y, x)) or ky + 1 (row g + 8,
    pixel (y + d, x)), box row col + kx*d with col = 32 wg + 8 warp + g, unit
    (2ks + half) ^ (box row & 7), channels 2tg and 2tg + 1 of the unit."""
    d = plan.pairs[br]
    slots = torch.stack([swizzled_box(x, row, c0, width, b, ch0)
                         for _, row, c0, width in plan.halo_boxes(br, k, strip)])
    t = torch.arange(256)
    wg, warp, lane = t // 128, t % 128 // 32, t % 32
    g, tg = lane // 4, lane % 4
    col = 32 * wg + 8 * warp + g
    out = torch.full((128, 64), float("nan"))
    for ks in range(4):
        for half in range(2):
            for i in range(2):
                ch = 16 * ks + 8 * half + 2 * tg + i
                for rr in range(2):
                    acc = torch.zeros(256)
                    for ky in range(3):
                        for kx in range(3):
                            j = col + kx * d
                            unit = (2 * ks + half) ^ (j & 7)
                            acc += taps[ky, kx, ch0 + ch] * slots[ky + rr, j, 8 * unit + 2 * tg + i]
                    out[64 * wg + 16 * warp + g + 8 * rr, ch] = torch.relu(acc + bias[ch0 + ch])
    return out


@pytest.mark.parametrize("b,h,w,ec,n,dils", SMALL)
def test_tile_emulation_equals_twin_depthwise_at_borders(b, h, w, ec, n, dils):
    """The first and the last tile of each dilated branch (the image's top
    left and bottom right corners), first and last chunk, against
    ``depthwise_reference`` (the twin's depthwise, before rounding)."""
    rng = np.random.default_rng(7)
    c = n * ec
    x = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32)).bfloat16().float()
    plan = plan_of(b, h, w, ec, n, dils)
    for br in (1, 2, 3):
        taps = torch.from_numpy(rng.normal(size=(3, 3, c)).astype(np.float32))
        bias = torch.from_numpy(rng.normal(size=c).astype(np.float32))
        ref = depthwise_reference(x, taps, bias, plan.pairs[br], torch.float32)
        for k, strip, ch0 in ((0, 0, 0), (1, 0, 0), (plan.row_pairs[br] - 1, plan.strips - 1, c - 64)):
            px = plan.tile_pixels(br, k, strip)
            inside = (px[:, 0] < h) & (px[:, 1] < w)
            got = emulate_tile_depthwise(plan, x, taps, bias, br, k, strip, b - 1, ch0)
            want = ref[b - 1, px[inside, 0], px[inside, 1], ch0:ch0 + 64]
            torch.testing.assert_close(got[inside], want, atol=1e-5, rtol=1e-5)


def test_tile_emulation_reaches_the_twin_output():
    """One tile of each branch through the emulated A operand, its bf16
    rounding and the pointwise product: the twin's branch output there."""
    rng = np.random.default_rng(8)
    b, h, w, ec, n, dils = 1, 9, 70, 64, 2, (3, 5, 7)
    c, pc = n * ec, 256
    embeds = [torch.from_numpy(rng.normal(size=(b, h, w, ec)).astype(np.float32)).bfloat16()
              for _ in range(n)]
    x = torch.cat([e.float() for e in embeds], dim=-1)

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))

    dw_w, dw_s, dw_b = f(3, 3, 3, c, scale=0.3), f(3, c).abs() + 0.5, f(3, c, scale=0.1)
    pw_w, pw_s, pw_b = f(3, c, pc, scale=0.05).bfloat16(), f(3, pc).abs() + 0.5, f(3, pc)
    a0_w, a0_s, a0_b = f(c, pc, scale=0.05).bfloat16(), f(pc).abs() + 0.5, f(pc)
    ref = aspp_fused_reference(embeds, dw_w, dw_s, dw_b, pw_w, pw_s, pw_b, a0_w, a0_s, a0_b, dils).float()
    plan = plan_of(b, h, w, ec, n, dils)
    taps = dw_w * dw_s[:, None, None, :]
    k, strip = plan.row_pairs[0] - 1, plan.strips - 1
    for br in range(4):
        kb = min(k, plan.row_pairs[br] - 1)
        px = plan.tile_pixels(br, kb, strip)
        inside = (px[:, 0] < h) & (px[:, 1] < w)
        if br == 0:  # A: the embed rows as TMA put them
            a = torch.zeros(128, c)
            a[inside] = x[0, px[inside, 0], px[inside, 1]]
            wmat, s, sh = a0_w, a0_s, a0_b
        else:
            a = torch.cat([emulate_tile_depthwise(plan, x, taps[br - 1], dw_b[br - 1], br, kb, strip, 0, c0)
                           for c0 in range(0, c, 64)], dim=1).bfloat16()
            wmat, s, sh = pw_w[br - 1], pw_s[br - 1], pw_b[br - 1]
        out = torch.relu(a.float() @ wmat.float() * s + sh)
        want = ref[0, px[inside, 0], px[inside, 1], br * pc:(br + 1) * pc]
        # the twin rounds its output to bf16; the emulation's depthwise sums
        # in another order, so a rounding of A may differ by one bf16 ulp
        torch.testing.assert_close(out[inside], want, atol=2 ** -6 * max(1.0, want.abs().max().item()),
                                   rtol=0)
