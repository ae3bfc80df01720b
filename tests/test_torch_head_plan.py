"""Launch plans and arithmetic of the 'full' head's kernels on the CPU: K6
(``dw_branches``, dilated depthwise) and K7 (``matmul_argmax``, conv_seg +
argmax), whose bf16 bodies run only on the card.

``dw_plan`` and ``argmax_plan`` are pure functions of shape and dtype that
the wrappers go by and that ``chip_smoke.py`` holds to the C libraries' own
choices on the card.  Here: every plan fits the card and TMA's rules, K6's
units and chain segments cover each output exactly once and load each input
element at most the stated number of times, K7's persistent blocks cover
every tile once, what the bodies do not take is refused by name; an
emulation of K6's chain walk (ring slots, boxes with zeros outside the
image, the rotating three-row accumulators, the kernel's thread-to-column
map) equals the plain twin, and an emulation of K7's split product and quad
argmax equals JAX ``_argmax_kernel`` in interpret mode on sure pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.ops.aspp import matmul_argmax as jax_matmul_argmax
from madm_torch.ops.aspp import (
    ARGMAX_TILE,
    DW_SLOT_BYTES,
    DW_SLOTS,
    SM_COUNT,
    argmax_plan,
    dw_branches_reference,
    dw_maps,
    dw_plan,
)
from madm_torch.ops.flash_attention import SMEM_LIMIT
from torch_port_toy import sure_pixels

# (B, H, W, EC, n_embeds, dilations): the 'full' head's calls (one dilation
# over the 1024-channel concat) at B=1 and 2 and the slide head's W=1024;
# three dilations in one call; ragged shapes (H not a multiple of d, W not a
# multiple of the strip, d > H, d = 1 with its chains cut into segments)
DW_SHAPES = [
    pytest.param(1, 512, 512, 1024, 1, (6,), id="full-d6"),
    pytest.param(1, 512, 512, 1024, 1, (12,), id="full-d12"),
    pytest.param(1, 512, 512, 1024, 1, (18,), id="full-d18"),
    pytest.param(2, 512, 512, 1024, 1, (6,), id="full-b2-d6"),
    pytest.param(1, 512, 1024, 1024, 1, (18,), id="slide-d18"),
    pytest.param(1, 512, 512, 256, 4, (6, 12, 18), id="4embeds-3dils"),
    pytest.param(1, 512, 512, 1024, 1, (1,), id="full-d1-segments"),
    pytest.param(1, 7, 100, 64, 2, (18, 5, 2), id="1x7x100-d18"),
    pytest.param(2, 37, 65, 128, 1, (1, 2, 3), id="2x37x65-d1"),
    pytest.param(1, 1, 1, 64, 4, (18, 18, 18), id="1x1x1"),
    pytest.param(3, 50, 200, 192, 3, (7, 13), id="3x50x200"),
]
# small enough to emulate: each border case of the chain walk
DW_EMULATED = [
    pytest.param(1, 13, 150, 64, 2, (5,), id="h13-d5-w150"),
    pytest.param(2, 7, 40, 64, 1, (9, 1), id="d9-over-h7-and-d1"),
    pytest.param(1, 40, 130, 64, 4, (1, 3, 18), id="4embeds-d1-segments"),
    pytest.param(1, 1, 1, 64, 3, (18,), id="1x1x1"),
    pytest.param(1, 19, 128, 64, 1, (6,), id="w128-h19"),
]


@pytest.mark.parametrize("b,h,w,ec,n,dils", DW_SHAPES)
def test_dw_plan_fits_the_card_and_tma(b, h, w, ec, n, dils):
    c = n * ec
    plan = dw_plan(b, h, w, c, dils, torch.bfloat16, n)
    assert plan.body == "chains_tma" and plan.threads == 256 and plan.slots == DW_SLOTS
    assert plan.smem <= SMEM_LIMIT and plan.grid[1:] == (1, 1) and plan.grid[0] < 2 ** 31
    assert plan.grid[0] == sum(plan.units) and len(plan.c_plan()) == 19
    assert plan.strips == -(-w // plan.tpx) and plan.slices == c // 64
    assert all(r == min(d, h) for r, d in zip(plan.res, dils))
    for name, dims, strides, box in dw_maps(b, h, w, ec, n, dils):
        assert all(s % 16 == 0 and s < 2 ** 40 for s in strides), (name, strides)
        assert all(1 <= x <= 256 for x in box), (name, box)  # TMA's box limit
        assert box[0] * 2 == 128, name  # a pixel's 64 channels: one 128-byte row of a slot
        assert box[1] * 128 <= DW_SLOT_BYTES and DW_SLOT_BYTES % 128 == 0  # a box fills at most a slot
    for i, d in enumerate(dils):  # segments: at least 8 rows, and no more than the card needs
        length = -(-h // d)
        assert plan.nseg[i] * plan.seg_rows[i] >= length > (plan.nseg[i] - 1) * plan.seg_rows[i]
        assert plan.nseg[i] == 1 or plan.seg_rows[i] >= 8


@pytest.mark.parametrize("b,h,w,ec,n,dils", DW_SHAPES)
def test_dw_units_cover_each_output_once(b, h, w, ec, n, dils):
    """Every (dilation, image, slice, strip, row) exactly once: the strips cut
    the columns, so each (b, y, x, channel, dilation) is written once."""
    plan = dw_plan(b, h, w, n * ec, dils, torch.bfloat16, n)
    blocks = list(plan.blocks())
    assert len(blocks) == plan.grid[0]
    count = torch.zeros(len(dils), b, plan.slices, plan.strips, h, dtype=torch.int32)
    for i, strip, r, seg, sl, img in blocks:
        ch = plan.chain(i, r, seg)
        if ch is None:
            continue
        k0, k1, j0, n_rows = ch
        d = dils[i]
        assert j0 <= k0 and j0 + n_rows - 1 >= k1 - 1  # it reads every row its outputs need
        count[i, img, sl, strip, r + d * torch.arange(k0, k1)] += 1
    assert (count == 1).all()
    cols = torch.zeros(w, dtype=torch.int32)
    for strip in range(plan.strips):
        cols[strip * plan.tpx:(strip + 1) * plan.tpx] += 1
    assert (cols == 1).all()


@pytest.mark.parametrize("b,h,w,ec,n,dils", DW_SHAPES)
def test_dw_input_crosses_into_an_sm_at_most_the_stated_times(b, h, w, ec, n, dils):
    """Counted from the boxes the units load (one image and slice: the others
    repeat it): no element more than ``max_loads`` times a dilation, and on
    average ``loads_per_input`` (which also counts the zeros TMA writes for
    columns outside the image)."""
    plan = dw_plan(b, h, w, n * ec, dils, torch.bfloat16, n)
    loads = torch.zeros(len(dils), h, w, dtype=torch.int32)
    box_cols = 0
    for i, strip, r, seg, sl, img in plan.blocks():
        ch = plan.chain(i, r, seg)
        if sl or img or ch is None:
            continue
        _, _, j0, n_rows = ch
        for j in range(j0, j0 + n_rows):
            y, x0, width = plan.box(i, r, j, strip)
            assert 0 <= y < h and width <= 256
            loads[i, y, max(x0, 0):min(x0 + width, w)] += 1
            box_cols += width
    assert int(loads.max()) <= plan.max_loads
    assert (loads >= 1).all()  # every input row reaches the SMs (each is some output's centre tap)
    assert box_cols / (len(dils) * h * w) == pytest.approx(plan.loads_per_input())
    if h == 512 and len(dils) == 1 and dils[0] > 1:  # the 'full' head: each row once, plus halo columns
        assert plan.nseg == (1,) and plan.max_loads == 2
        assert plan.loads_per_input() == pytest.approx((plan.tpx + 2 * dils[0]) / plan.tpx)


def test_dw_plan_keeps_the_full_head_unsegmented_and_fills_the_card():
    """At the 'full' head's calls the chains alone give >= 2 units an SM; at
    d = 1 they are cut into segments until they do."""
    for d in (6, 12, 18):
        plan = dw_plan(1, 512, 512, 1024, (d,), torch.bfloat16)
        assert plan.nseg == (1,) and plan.grid[0] == 16 * 4 * d >= 2 * SM_COUNT
    plan = dw_plan(1, 512, 512, 1024, (1,), torch.bfloat16)
    assert plan.nseg[0] > 1 and plan.grid[0] >= 2 * SM_COUNT


@pytest.mark.parametrize("kw,match", [
    (dict(ec=32), "multiple of 64"),
    (dict(n=5, ec=64), "1-4 embeds"),
    (dict(dils=(6, 19)), "dilations"),
    (dict(dils=(0,)), "dilations"),
    (dict(dils=(1, 2, 3, 4)), "1-3 dilations"),
    (dict(dils=()), "1-3 dilations"),
    (dict(b=65536), "batch"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
])
def test_dw_plan_refuses_what_the_body_does_not_take(kw, match):
    args = dict(b=1, h=8, w=8, ec=64, n=1, dils=(6,), dtype=torch.bfloat16) | kw
    with pytest.raises(ValueError, match=match):
        dw_plan(args["b"], args["h"], args["w"], args["n"] * args["ec"], args["dils"], args["dtype"],
                args["n"])


def test_dw_plan_of_an_empty_image_has_no_units():
    for h, w in ((0, 16), (16, 0)):
        plan = dw_plan(1, h, w, 64, (6, 1), torch.bfloat16)
        assert plan.grid[0] == 0 and list(plan.blocks()) == []


def test_dw_float32_plan_keeps_the_simt_body():
    plan = dw_plan(2, 9, 70, 96, (6, 12), torch.float32, 3)
    assert plan.body == "simt" and plan.grid == (9 * 2, 2 * 3, 2)
    assert plan.c_plan() == [0, 64, 256, 0, 0, 18, 6, 2, 2, 3] + [0] * 9


# ------------------------------------------------- emulation of K6's chains
def thread_columns(plan):
    """[256 threads][4 columns] strip column and [256] channel vector of each
    thread (tid = 8 c + u: columns c, c + 32, c + 64, c + 96, channels 8u ..
    8u + 7)."""
    tid = torch.arange(plan.threads)
    cc, uu = tid // 8, tid % 8
    return cc[:, None] + 32 * torch.arange(plan.tpx // 32), uu


def emulate_dw(plan, embeds, taps, scale, bias):
    """K6's bf16 body on fp32 data, block by block: ring slots filled with
    TMA boxes (zeros outside the image), the rotating accumulators of chain
    rows j - 1, j, j + 1, BN + ReLU as a row completes, columns past W not
    stored.  Returns the outputs [n_dil][B, H, W, C] (nan where unwritten)."""
    b, h, w, ec = embeds[0].shape
    c = len(embeds) * ec
    outs = [torch.full((b, h, w, c), float("nan")) for _ in plan.dilations]
    cols, uu = thread_columns(plan)
    # every (column, channel) of a strip row belongs to exactly one thread
    owned = torch.zeros(plan.tpx, 64, dtype=torch.int32)
    for t in range(plan.threads):
        for col in cols[t]:
            owned[col, 8 * uu[t]:8 * uu[t] + 8] += 1
    assert (owned == 1).all()
    chans = 8 * uu[:, None] + torch.arange(8)  # [256][8]
    for i, strip, r, seg, sl, img in plan.blocks():
        ch = plan.chain(i, r, seg)
        if ch is None:
            continue
        k0, k1, j0, n_rows = ch
        d = plan.dilations[i]
        e, ce = sl * 64 // ec, sl * 64 % ec
        tw = taps[i][..., sl * 64:(sl + 1) * 64]  # [3, 3, 64]
        ring = [None] * plan.slots

        def load(jj):
            y, x0, width = plan.box(i, r, jj, strip)
            box = torch.zeros(width, 64)
            xs = torch.arange(x0, x0 + width)
            ok = (xs >= 0) & (xs < w)
            box[ok] = embeds[e][img, y, xs[ok], ce:ce + 64]
            ring[(jj - j0) % plan.slots] = box

        for jj in range(j0, min(j0 + plan.slots, j0 + n_rows)):
            load(jj)
        acc = torch.zeros(3, plan.threads, cols.shape[1], 8)

        def finish(q, k):
            y = r + k * d
            ci = sl * 64 + chans[:, None, :].expand(-1, cols.shape[1], -1)  # [256][4][8]
            v = torch.relu(acc[q] * scale[i][ci] + bias[i][ci])
            xi = (strip * plan.tpx + cols)[:, :, None].expand_as(ci)
            ok = xi < w
            outs[i][img, y, xi[ok], ci[ok]] = v[ok]

        for step in range(n_rows):
            jj = j0 + step
            if step > 0 and step - 1 + plan.slots < n_rows:  # the slot row jj - 1 freed
                load(j0 + step - 1 + plan.slots)
            box = ring[step % plan.slots]
            p, a, nx = step % 3, (step + 2) % 3, (step + 1) % 3
            for kx in range(3):
                xv = box[cols + kx * d][:, :, :].gather(
                    2, chans[:, None, :].expand(-1, cols.shape[1], -1))  # [256][4][8]
                acc[a] += tw[2, kx][chans][:, None] * xv
                acc[p] += tw[1, kx][chans][:, None] * xv
                acc[nx] += tw[0, kx][chans][:, None] * xv
            if jj - 1 >= k0:
                finish(a, jj - 1)
            acc[a] = 0
            if step == n_rows - 1 and jj < k1:
                finish(p, jj)
    return outs


@pytest.mark.parametrize("b,h,w,ec,n,dils", DW_EMULATED)
def test_dw_chain_emulation_equals_twin(b, h, w, ec, n, dils):
    rng = np.random.default_rng(11)
    c = n * ec
    embeds = [torch.from_numpy(rng.normal(size=(b, h, w, ec)).astype(np.float32)).bfloat16().float()
              for _ in range(n)]
    taps = torch.from_numpy(rng.normal(size=(len(dils), 3, 3, c)).astype(np.float32)) / 3
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, size=(len(dils), c)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(len(dils), c)).astype(np.float32)) * 0.1
    plan = dw_plan(b, h, w, c, dils, torch.bfloat16, n)
    got = emulate_dw(plan, embeds, taps, scale, bias)
    want = dw_branches_reference(embeds, taps, scale, bias, dils)
    for g, r in zip(got, want):
        assert not torch.isnan(g).any()  # every output written
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


def test_dw_emulation_cuts_chains_into_segments():
    """The emulated d = 1 case runs segmented chains (edge rows re-staged)."""
    plan = dw_plan(1, 40, 130, 256, (1, 3, 18), torch.bfloat16, 4)
    assert plan.nseg[0] > 1 and plan.max_loads == 4


# ---------------------------------------------------------------- K7
@pytest.mark.parametrize("pixels,c,nc", [
    (512 * 512, 256, 11), (2 * 512 * 512, 256, 11), (512 * 1024, 256, 11), (512 * 512, 256, 19),
    (37 * 65, 256, 11), (1, 64, 1), (100, 576, 32), (5000, 640, 16),
])
def test_argmax_plan_fits_the_card(pixels, c, nc):
    plan = argmax_plan(pixels, c, nc, torch.bfloat16)
    assert plan.body == "tma_wgmma" and plan.threads == 160
    assert plan.ncp == (16 if nc <= 16 else 32) and 2 * plan.ncp in (32, 64)  # wgmma m64n32 / m64n64
    assert 2 <= plan.stages <= 4 and plan.smem <= SMEM_LIMIT
    # 1024-byte alignment, the [2 NCP][C] bf16 weights, the stages, two mbarriers a stage
    assert plan.smem == 1024 + 2 * plan.ncp * c * 2 + plan.stages * ARGMAX_TILE * c * 2 + 16 * plan.stages
    assert plan.tiles == -(-pixels // ARGMAX_TILE) and plan.grid == min(plan.tiles, SM_COUNT)
    assert len(plan.c_plan()) == 7
    # the persistent blocks walk every tile once (block i: tiles i, i + grid, ...)
    seen = torch.zeros(plan.tiles, dtype=torch.int32)
    for blk in range(plan.grid):
        seen[blk::plan.grid] += 1
    assert (seen == 1).all()
    if (pixels, c, nc) == (512 * 512, 256, 11):
        assert plan.stages == 4 and plan.grid == SM_COUNT


@pytest.mark.parametrize("args,match", [
    ((100, 32, 11, torch.bfloat16), "multiple of 64"),
    ((100, 200, 11, torch.bfloat16), "multiple of 64"),
    ((100, 640, 32, torch.bfloat16), "two"),
    ((100, 256, 33, torch.bfloat16), "1-32 classes"),
    ((100, 256, 0, torch.float32), "1-32 classes"),
    ((2 ** 31, 256, 11, torch.bfloat16), "2\\^31"),
    ((100, 256, 11, torch.float16), "float32 or bfloat16"),
    ((100, 6, 11, torch.float32), "multiple of 4"),
])
def test_argmax_plan_refuses_what_the_body_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        argmax_plan(*args)


def test_argmax_float32_plan_keeps_the_simt_body():
    plan = argmax_plan(512 * 512, 256, 11, torch.float32)
    assert plan.body == "simt" and plan.ncp == 16 and plan.stages == 0
    assert plan.c_plan() == [0, 16, 256, 0, 256 * 20 * 4, 2 * SM_COUNT, 0]
    assert argmax_plan(10, 8, 20, torch.float32).grid == 1  # 64 / 32 = 2 pixels a warp


def split_weights(w: torch.Tensor):
    """conv_seg's fp32 weights as K7's bf16 body splits them in its prologue:
    w_hi = bf16(w), w_lo = bf16(w - w_hi)."""
    hi = w.float().to(torch.bfloat16)
    return hi, (w.float() - hi.float()).to(torch.bfloat16)


def test_split_weights_carry_w_to_2_pow_minus_16():
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(256, 19)).astype(np.float32))
    hi, lo = split_weights(w)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert ((hi.float() + lo.float()) - w).abs().max() <= 2.0 ** -16 * w.abs().max()


def emulate_argmax(x, w, b):
    """K7's bf16 body: per 64-pixel tile, the wgmma product against [w_hi |
    w_lo] in fp32, each thread's classes 8j + 2tg + e (j < NCP/8) of pixel
    rows g and g + 8 scanned in ascending order, then the quad merges over
    tg (xor 1, then xor 2), lowest class on ties; padded classes never
    compete."""
    pixels, c = x.shape
    nc = w.shape[1]
    plan = argmax_plan(pixels, c, nc, torch.bfloat16)
    ncp = plan.ncp
    hi, lo = split_weights(torch.from_numpy(w))
    wpad = torch.zeros(c, 2 * ncp)
    wpad[:, :nc], wpad[:, ncp:ncp + nc] = hi.float(), lo.float()
    acc = torch.from_numpy(x) @ wpad  # the fp32 accumulators of every tile row, [P][2 NCP]
    logits = acc[:, :ncp] + acc[:, ncp:] + torch.from_numpy(np.pad(b, (0, ncp - nc)))
    best = torch.full((pixels, 4), float("-inf"))
    idx = torch.full((pixels, 4), 2 ** 31 - 1, dtype=torch.int64)
    for tg in range(4):
        for j in range(ncp // 8):
            for e in range(2):
                cls = 8 * j + 2 * tg + e
                if cls >= nc:
                    continue
                v = logits[:, cls]
                take = (v > best[:, tg]) | ((v == best[:, tg]) & (cls < idx[:, tg]))
                best[:, tg] = torch.where(take, v, best[:, tg])
                idx[:, tg] = torch.where(take, torch.full_like(idx[:, tg], cls), idx[:, tg])
    for m in (1, 2):
        ob, oi = best[:, [t ^ m for t in range(4)]], idx[:, [t ^ m for t in range(4)]]
        take = (ob > best) | ((ob == best) & (oi < idx))
        best, idx = torch.where(take, ob, best), torch.where(take, oi, idx)
    assert (idx == idx[:, :1]).all()  # the four lanes of a quad agree
    return idx[:, 0].to(torch.int32).numpy(), logits[:, :nc].numpy()


@pytest.mark.parametrize("nc", [11, 19])
@pytest.mark.parametrize("tied", [False, True])
def test_argmax_emulation_matches_jax_kernel(nc, tied):
    rng = np.random.default_rng(2 + nc)
    x = torch.from_numpy(rng.normal(size=(1, 16, 64, 256)).astype(np.float32)).bfloat16().float().numpy()
    w = rng.normal(size=(256, nc)).astype(np.float32)
    b = rng.normal(size=(nc,)).astype(np.float32)
    if tied:  # classes 2, 5 and 9 have the same exact logit, the lowest index must win
        w[:, [2, 5, 9]] = 0.0
        b[[2, 5, 9]] = 22.0
    ref = np.asarray(jax_matmul_argmax(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    ids, logits = emulate_argmax(x.reshape(-1, 256), w, b)
    ids = ids.reshape(ref.shape)
    exact = x @ w + b
    # w_hi + w_lo carry w to ~2^-17 relative: the logits are fp32's to ~1e-4 here
    np.testing.assert_allclose(logits.reshape(exact.shape), exact, atol=2e-4, rtol=0)
    sure = sure_pixels(exact, 1e-3 * max(1.0, np.abs(exact).max()))
    assert sure.mean() > (0.4 if tied else 0.95)  # tied pixels have no margin: checked below
    np.testing.assert_array_equal(ids[sure], ref[sure])
    assert (ids == ref).mean() >= 0.999
    if tied:
        top = exact.argmax(-1) == 2
        assert top.mean() > 0.1  # hundreds of three-way ties
        np.testing.assert_array_equal(ids[top], 2)
        np.testing.assert_array_equal(ref[top], 2)



@pytest.mark.parametrize("kernel", ["dw", "aspp"])
def test_profile_ablations_apply_to_the_kernel(kernel):
    """``python -m madm_torch.profile_aspp --ablate`` edits the kernel's
    source by its lines: each ablated build it times must still find them."""
    from madm_torch import kernels
    from madm_torch.profile_aspp import SOURCES, ablated_source

    name, table, runs = SOURCES[kernel]
    src = (kernels.CSRC / f"{name}.cu").read_text()
    outs = {run: ablated_source(src, run.split("+"), table) for run in runs}
    assert all(out != src for out in outs.values()) and len(set(outs.values())) == len(outs)
