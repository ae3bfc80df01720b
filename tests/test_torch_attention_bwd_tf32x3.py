"""K3's fp32 body on the CPU: ``attention_backward_tf32x3_reference`` (the
body's arithmetic in plain torch: the tf32 hi/lo split, three tf32 products
for each fp32 one, query tiles summed in fp32, the split dK/dV partials
added in split order, key tiles of dQ) against the JAX flash-attention
backward kernel in Pallas interpret mode; both fp32 twins against fp64
autograd; the fp32 ``backward_plan`` at the train step's shapes; the
transposed tiles as the prep kernel writes them and as the tf32 wgmma reads
them; and the pure-Python part of the toy checks' yardstick
(``chip_smoke.nudge``, ``hold``).  The CUDA body itself is held to the twin
and to this reference on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import FLASH_SHAPES
from madm_torch.kernels import CSRC
from madm_tpu.ops.flash_attention import _flash_attention_bwd_impl
from madm_torch.ops.flash_attention import (
    MAX_BWD_HEAD_DIM,
    SM_COUNT,
    SMEM_LIMIT,
    attention_backward_reference,
    attention_backward_tf32x3_reference,
    attention_tf32x3_reference,
    backward_plan,
    tf32,
)

TOL = 1e-5  # of max(1, max|ref|): fp32 both sides, as the card holds the body to this reference
BWD_SHAPES = [pytest.param(b, *s[:4], id=f"B{b}-" + "x".join(map(str, s[:4])))
              for s in FLASH_SHAPES if s[3] <= MAX_BWD_HEAD_DIM for b in (1, 2)]


def inputs(seed, b, sq, sk, h, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32)) for s in (sq, sk, sk, sq)]


def of_max(got, ref):
    ref = torch.as_tensor(np.array(ref)).double()
    return (got.double() - ref).abs().max().item() / max(1.0, ref.abs().max().item())


@pytest.mark.parametrize(
    "sq,sk,h,d",
    [
        (64, 64, 2, 40),     # the largest self-attention's head width
        (96, 77, 2, 40),     # cross-attention: ragged 77 keys, three 32-query tiles
        (64, 77, 2, 80),
        (64, 64, 1, 160),    # the widest head that trains
    ],
)
def test_backward_tf32x3_reference_matches_jax_kernel(sq, sk, h, d):
    q, k, v, g = inputs(sq + sk + d, 1, sq, sk, h, d)
    ref = _flash_attention_bwd_impl(*(jnp.asarray(t.numpy()) for t in (q, k, v, g)), scale=d ** -0.5,
                                    interpret=True)
    plan = backward_plan(1, sq, sk, h, d, torch.float32)
    assert plan.body == "tma_tf32x3"
    o, lse = attention_tf32x3_reference(q, k, v, d ** -0.5)
    got = attention_backward_tf32x3_reference(q, k, v, o, g, lse, d ** -0.5, plan.bq, plan.bk_dq, plan.nsplit)
    for x, r in zip(got, ref):
        assert x.shape == tuple(r.shape) and x.dtype == torch.float32
        assert of_max(x, r) <= TOL


@pytest.mark.parametrize("sq,sk,h,d,bq,nsplit", [(96, 77, 2, 40, 32, 3), (128, 128, 2, 80, 32, 2),
                                                 (64, 77, 1, 160, 32, 1)])
def test_backward_twins_against_fp64_autograd(sq, sk, h, d, bq, nsplit):
    """The plain twin (the CPU path) and the body's twin (tiles, splits) both
    within fp32 rounding of fp64 autograd of softmax(q k^T scale) v."""
    q, k, v, g = inputs(7 * d, 2, sq, sk, h, d)
    scale = d ** -0.5
    q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
    o64 = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q64, k64) * scale, -1), v64)
    ref = torch.autograd.grad(o64, (q64, k64, v64), g.double())
    o, lse = attention_tf32x3_reference(q, k, v, scale)
    for got in (attention_backward_reference(q, k, v, g, scale),
                attention_backward_tf32x3_reference(q, k, v, o, g, lse, scale, bq, 32, nsplit)):
        for x, r in zip(got, ref):
            assert of_max(x, r.detach()) <= TOL


def test_split_and_tiles_only_reorder_fp32_sums():
    """One query tile and no split against 32-query tiles in 3 splits and
    16-key dQ tiles: the same gradients within fp32 reordering."""
    q, k, v, g = inputs(3, 1, 200, 77, 2, 40)
    o, lse = attention_tf32x3_reference(q, k, v)
    one = attention_backward_tf32x3_reference(q, k, v, o, g, lse, None, 256, 256, 1)
    cut = attention_backward_tf32x3_reference(q, k, v, o, g, lse, None, 32, 16, 3)
    for x, r in zip(cut, one):
        assert of_max(x, r) <= 1e-6


@pytest.mark.parametrize("b,sq,sk,h,d", BWD_SHAPES)
def test_fp32_backward_plan_fits_the_card(b, sq, sk, h, d):
    """At every shape of the train step: the TMA body; its kernels' shared
    memory within the card's, two to four ring stages; the dK/dV grid split
    only where the key blocks leave SMs idle, every query tile in one run;
    the workspace the arrays' bytes (within a few hundred MB)."""
    plan = backward_plan(b, sq, sk, h, d, torch.float32, [0] * 8)
    assert plan.body == "tma_tf32x3" and plan.dn >= d and plan.dn % 8 == 0
    names = [l.kernel for l in plan.launches]
    assert names == ["bwd_tf32_prep", "dkdv_tf32"] + (["dkdv_tf32_reduce"] if plan.nsplit > 1 else []) + ["dq_tf32"]
    launches = {l.kernel: l for l in plan.launches}
    for name in ("dkdv_tf32", "dq_tf32"):
        assert launches[name].threads == 128 and 0 < launches[name].smem <= SMEM_LIMIT
    assert 2 <= plan.stages <= 4
    assert launches["dkdv_tf32"].grid == (-(-sk // 64), h, b * plan.nsplit)
    assert launches["dq_tf32"].grid == (-(-sq // 64), h, b)
    assert plan.bq == plan.bk_dq == (64 if plan.dn == 40 else 32)
    nqt, blocks = -(-sq // plan.bq), -(-sk // 64) * h * b
    assert (plan.nsplit > 1) == (blocks < SM_COUNT and nqt >= 4)
    runs = [(s * nqt // plan.nsplit, (s + 1) * nqt // plan.nsplit) for s in range(plan.nsplit)]
    assert all(t1 > t0 for t0, t1 in runs) and [t for r in runs for t in range(*r)] == list(range(nqt))
    sqs = -(-sq // 64) * 64
    arrays = 4 * 2 * b * h * sqs + 8 * b * h * d * (2 * sq + 2 * sk + 2 * -(-sq // 8) * 8 + -(-sk // 8) * 8)
    parts = 2 * 4 * plan.nsplit * b * sk * h * d if plan.nsplit > 1 else 0
    assert arrays + parts <= plan.workspace_bytes <= arrays + parts + 256 * 10
    assert plan.workspace_bytes < 2 ** 28


def test_fp32_backward_plan_takes_simt_only_where_tma_cannot_address():
    aligned = [0, 64, 1024, 4096, 16, 32, 48, 512]
    assert backward_plan(2, 64, 64, 2, 40, torch.float32, aligned).body == "tma_tf32x3"
    for i in range(8):  # any one of q, k, v, o, g, dq, dk, dv off the 16-byte grid
        bad = list(aligned)
        bad[i] += 4
        plan = backward_plan(2, 64, 64, 2, 40, torch.float32, bad)
        assert plan.body == "simt" and plan.workspace_bytes == 4 * 2 * 2 * 64, i
    for d in (4, 12, 36, 40, 80, 124, 160):
        assert backward_plan(1, 64, 64, 2, d, torch.float32).body == "tma_tf32x3", d
    for d in (1, 6, 34, 158):
        assert backward_plan(1, 64, 64, 2, d, torch.float32).body == "simt", d


def swizzled(row, col):
    """Word index of (row, 32-bit column) in a 128-byte-swizzled tile of
    128-byte rows, as TMA writes a [rows][32] fp32 box and as a K-major
    wgmma descriptor reads it."""
    return row * 32 + (((col // 4) ^ (row % 8)) * 4) + col % 4


def prep_transposed(x, s8):
    """The prep kernel's transposed copy of one (b, h) of ``x`` [S, D], as
    its threads write it: a block of 32 rows in shared memory, then (d,
    position pp) from row pp - u + perm(u), u = pp % 8, perm = (0, 2, 4, 6,
    1, 3, 5, 7); positions past S zero."""
    s, d = x.shape
    out = np.full((d, s8), np.nan)
    for s0 in range(0, s, 32):
        tile = np.zeros((32, d))
        rows = min(32, s - s0)
        tile[:rows] = x[s0:s0 + rows]
        for e in range(d * 32):
            dd, pp = e // 32, e % 32
            if s0 + pp >= s8:
                continue
            u = pp % 8
            out[dd, s0 + pp] = tile[pp - u + (2 * u if u < 4 else 2 * u - 7), dd]
    return out


@pytest.mark.parametrize("s,d,bt,dn", [(77, 40, 64, 40), (96, 80, 32, 80), (64, 160, 32, 160), (40, 36, 32, 40)])
def test_transposed_tiles_as_the_kernel_writes_and_reads_them(s, d, bt, dn):
    """X^T Y formed as the product items form it: the prep kernel's
    transposed Y (``prep_transposed``), loaded by TMA as [DN][32] boxes
    (rows past D and positions past S8 TMA's zeros), read K-major at the
    descriptor's k-step offsets (box kk // 4, 32 bytes a step), against A
    fragments straight from the accumulator layout of X^T (columns 2tg and
    2tg + 1 as A's k = tg and tg + 4).  Equal to X^T Y in fp64, every tile."""
    rng = np.random.default_rng(s + d)
    y = rng.normal(size=(s, d))
    xt = rng.normal(size=(64, s))  # the 64 A-side rows' scores over S positions
    s8 = -(-s // 8) * 8
    yt = prep_transposed(y, s8)
    assert not np.isnan(yt).any()
    out = np.zeros((64, dn))
    for j in range(-(-s // bt)):
        boxes = []
        for box in range(bt // 32):  # TMA: rows dd < dn, positions j*bt + 32*box + c
            words = np.zeros(dn * 32)
            for dd in range(dn):
                for c in range(32):
                    pos = j * bt + 32 * box + c
                    words[swizzled(dd, c)] = yt[dd, pos] if dd < d and pos < s8 else 0.0
            boxes.append(words)
        for kk in range(bt // 8):
            b_op = np.array([[boxes[kk // 4][swizzled(n, (kk % 4) * 8 + c)] for n in range(dn)] for c in range(8)])
            a_op = np.zeros((64, 8))
            for row in range(64):
                for tg in range(4):
                    for half, c in ((0, 2 * tg), (1, 2 * tg + 1)):
                        col = j * bt + 8 * kk + c
                        a_op[row, tg + 4 * half] = xt[row, col] if col < s else 0.0
            out += a_op @ b_op
    np.testing.assert_allclose(out[:, :d], xt @ y, rtol=1e-12, atol=1e-12)
    assert not out[:, d:].any()


def test_nudge_moves_each_non_integral_element_one_ulp():
    gen = torch.Generator().manual_seed(0)
    x = torch.tensor([0.0, 1.0, -3.0, 0.1, -2.5e-3, 1e30, 7.25, 1e-40])
    y = chip_smoke.nudge({"a": [x], "n": torch.arange(3), "f": 2.5}, gen)
    got = y["a"][0]
    assert torch.equal(y["n"], torch.arange(3)) and y["f"] == 2.5
    integral = x == x.round()
    assert torch.equal(got[integral], x[integral])
    moved = ~integral
    assert (got[moved] != x[moved]).all()
    assert ((torch.nextafter(x, got) == got) & (torch.nextafter(got, x) == x))[moved].all()  # one ulp apart
    again = chip_smoke.nudge(x, torch.Generator().manual_seed(0))
    assert torch.equal(again, got)
    ups = [(chip_smoke.nudge(x, torch.Generator().manual_seed(s)) > x)[moved] for s in range(40)]
    share = torch.stack(ups).double().mean().item()
    assert 0.3 < share < 0.7  # both ways, a coin each


def test_nudge_model_moves_weights_and_float_buffers_in_place():
    m = torch.nn.BatchNorm1d(4)
    with torch.no_grad():
        m.weight.copy_(torch.tensor([0.5, 1.5, -0.25, 3.3]))
        m.running_mean.copy_(torch.tensor([0.1, 0.2, 0.3, 0.4]))
    before = {k: v.clone() for k, v in m.state_dict().items()}
    chip_smoke.nudge_model_(m, torch.Generator().manual_seed(1))
    after = m.state_dict()
    assert torch.equal(after["num_batches_tracked"], before["num_batches_tracked"])
    assert (after["running_mean"] != before["running_mean"]).all()
    assert (after["weight"] != before["weight"]).all()
    assert torch.equal(after["bias"], before["bias"])  # zeros are integral


def test_hold_takes_the_larger_spread_and_records_the_reading():
    chip_smoke.TOY_READINGS.clear()
    k, floor = chip_smoke.YARD_K, chip_smoke.YARD_FLOOR
    spreads = [dict(loss=1e-5, grad=2e-4, modules={"unet": 3e-5}), dict(loss=2e-5, grad=1e-4, modules={"unet": 1e-5})]
    got = dict(loss=1e-4, grad=1e-3, modules={"unet": 2e-4})
    ok, text = chip_smoke.hold("x", got, spreads)
    limits = dict(loss=k * 2e-5 + floor["loss"], grad=k * 2e-4 + floor["grad"], unet=k * 3e-5 + floor["module"])
    assert ok == (1e-4 <= limits["loss"] and 1e-3 <= limits["grad"] and 2e-4 <= limits["unet"])
    row = chip_smoke.TOY_READINGS[-1]
    assert row["limits"]["loss"] == pytest.approx(limits["loss"])
    assert row["limits"]["grad"] == pytest.approx(limits["grad"])
    assert row["limits"]["modules"]["unet"] == pytest.approx(limits["unet"])
    assert row["passed"] == ok and f"{limits['loss']:.3e}" in text
    for key in ("loss", "grad"):  # each reading alone over its limit fails the check
        bad = dict(got, **{key: 10 * limits[key]})
        assert not chip_smoke.hold("y", bad, spreads)[0]
    assert not chip_smoke.hold("z", dict(got, modules={"unet": 10 * limits["unet"]}), spreads)[0]


@pytest.mark.parametrize("spread, limit", [(1e-4, 8 * 1e-4 + 1e-5), (5e-4, 2e-3), (3e-3, 8 * 3e-3 + 1e-5)])
def test_gradient_limit_keeps_its_ceiling_under_the_cpu_noise(spread, limit):
    """The gradients of the largest entry: the yardstick, but no more than
    GRAD_TOL (2e-3) unless the CPU's own nudged spread exceeds it; the losses
    and modules on the yardstick alone."""
    assert chip_smoke.YARD_K == 8.0 and chip_smoke.GRAD_TOL == 2e-3 and chip_smoke.YARD_FLOOR["grad"] == 1e-5
    spreads = [dict(loss=1e-3, grad=spread / 2, modules={"unet": 1e-3}),
               dict(loss=1e-3, grad=spread, modules={"unet": 1e-3})]
    lim = chip_smoke.limits_of(spreads, ["unet"])
    assert lim["grad"] == pytest.approx(limit)
    assert lim["loss"] == pytest.approx(8e-3 + 1e-5) and lim["modules"]["unet"] == pytest.approx(8e-3 + 1e-5)
    got = dict(loss=0.0, grad=limit * 1.01, modules={"unet": 0.0})
    assert not chip_smoke.within(got, lim) and chip_smoke.within(dict(got, grad=limit * 0.99), lim)


def test_reread_holds_recorded_readings_to_the_limits():
    """``tf32_variants.reread`` without seeds: each check's largest ratio of
    a reading to its limit from the spreads the run recorded, and whether
    the check raised; ``check_spreads`` names the CPU sides' spreads as
    ``hold`` names the readings."""
    from madm_torch import tf32_variants

    spreads = [dict(loss=1e-5, grad=1e-4, modules={"unet": 1e-4})] * 2
    got = dict(loss=4.5e-5, grad=4e-4, modules={"unet": 1e-4})
    run = {"toy": {"kept": {"6 unet": {"readings": [dict(check="6 unet", got=got, spreads=spreads)],
                                       "error": None}}}}
    out = tf32_variants.reread(chip_smoke, run, 0)
    assert out["builds"]["kept"]["6 unet"] == dict(recorded=pytest.approx(0.5), raised=None)
    halves = [{"steps": [{"spreads": [f"s0h{i}"]}, {"spreads": [f"s1h{i}"]}]} for i in range(2)]
    names = tf32_variants.check_spreads(chip_smoke, {("train", repr(chip_smoke.TOY), 2, 1): halves[1],
                                                     ("train", repr(chip_smoke.TOY), 2, 0): halves[0],
                                                     ("unet",): {"spreads": ["u"]},
                                                     ("group", "11", "mic"): {"spreads": ["g"]},
                                                     ("reducer spreads",): ["r"]})
    assert names["6 toy (64, 64) flash_pack=False clip=no step 1"] == ["s1h0", "s1h1"]  # the halves in order
    assert names["6 unet"] == ["u"] and names["11 mic"] == ["g"]
    assert all(names[f"12 {n}"] == ["r"] for n in chip_smoke.REDUCERS)


def test_prefetch_cpu_sides_hands_each_part_to_cpu_side(tmp_path, monkeypatch):
    """``prefetch_cpu_sides`` end to end: the work computed by a pool of
    spawned processes, read by ``cpu_side`` the first time a check needs a
    side (equal to the side computed here), its files removed; work that
    fails in its process makes ``cpu_side`` raise."""
    monkeypatch.setattr(chip_smoke, "_CPU_SIDES", {})
    monkeypatch.setattr(chip_smoke, "_PREFETCH", [])
    r, g = {"w": torch.tensor([1.0, -4.0])}, {"w": torch.tensor([1.0, -3.0])}
    work = [(("unet", 8), chip_smoke.toy_unet_cpu, (8,)),
            (("readings",), chip_smoke.readings, ({"l": 1.0}, {"l": 1.0}, r, g))]
    chip_smoke.prefetch_cpu_sides(str(tmp_path / "sides.pt"), work)

    def never():
        raise AssertionError("computed again")

    got = chip_smoke.cpu_side(("unet", 8), never)
    assert chip_smoke.cpu_side(("readings",), never)["grad"] == pytest.approx(0.25) and not chip_smoke._PREFETCH
    assert not list(tmp_path.iterdir())
    threads = torch.get_num_threads()
    torch.set_num_threads(chip_smoke.CPU_SIDE_THREADS)  # as the process computed it
    try:
        here = chip_smoke.toy_unet_cpu(8)
    finally:
        torch.set_num_threads(threads)
    torch.testing.assert_close(got["grads"], here["grads"])
    assert got["metrics"] == pytest.approx(here["metrics"]) and len(got["spreads"]) == len(chip_smoke.NUDGE_SEEDS)

    monkeypatch.setattr(chip_smoke, "_CPU_SIDES", {})
    chip_smoke.prefetch_cpu_sides(str(tmp_path / "bad.pt"), [(("bad",), chip_smoke.nudge, ())])
    with pytest.raises(AssertionError, match="failed in their processes"):
        chip_smoke.cpu_side(("bad",), never)


def test_readings_by_module():
    ref = {"unet.a": torch.tensor([3.0, 4.0]), "unet.b": torch.tensor([0.0]), "head.w": torch.tensor([1.0]),
           "prompt.p": torch.zeros(2)}
    got = {"unet.a": torch.tensor([3.0, 4.0]), "unet.b": torch.tensor([0.5]), "head.w": torch.tensor([1.0]),
           "prompt.p": torch.ones(2)}
    mods = chip_smoke.by_module(ref, got)
    assert mods == {"unet": pytest.approx(0.1), "head": 0.0}  # a module whose norm is 0 is left out
    r = chip_smoke.readings({"l": 1.0}, {"l": 1.0}, ref, ref)
    assert r == dict(loss=0.0, grad=0.0, modules={"unet": 0.0, "head": 0.0})


def test_loss_and_gradient_readings():
    ref = {"a": 2.0, "b": 0.0, "c": -4.0}
    got = {"a": 2.0002, "b": 5e-8, "c": -4.0}  # b: 5e-8 over the 1e-3 floor
    assert chip_smoke.loss_rel(ref, got) == pytest.approx(1e-4)
    r = {"w": torch.tensor([1.0, -4.0]), "v": torch.tensor([0.5])}
    g = {"w": torch.tensor([1.0, -4.0 + 2e-3]), "v": torch.tensor([0.5 - 1e-3])}
    assert chip_smoke.grad_of_max(r, g) == pytest.approx(2e-3 / 4.0, rel=1e-3)  # fp32 subtraction


def test_tf32_helper_is_shared():
    """K1's and K3's bodies round to tf32 with hopper.cuh's one ``tf32_rn``,
    which ``tf32`` states."""
    assert (CSRC / "hopper.cuh").read_text().count("float tf32_rn(float x)") == 1
    for header in ("flash_fwd_tf32.cuh", "flash_bwd_tf32.cuh"):
        assert "float tf32_rn(" not in (CSRC / header).read_text()
    assert tf32(torch.tensor([1.0 + 2.0 ** -11])).item() == 1.0 + 2.0 ** -10


@pytest.fixture(scope="module")
def toy_unet_side():
    return chip_smoke.toy_unet_cpu(16)


@pytest.mark.parametrize("product, passes", [("tf32x3", True), ("one", False)])
def test_toy_unet_check_tells_a_one_product_k3(monkeypatch, toy_unet_side, product, passes):
    """``chip_smoke.check_toy_unet``'s readings on the CPU, with the twin of
    K3's 3xTF32 body (``attention_backward_tf32x3_reference``) in the toy
    UNet's backward: within the yardstick of its nudged runs; with every
    product from one tf32 piece each (what the ``k3_x1`` build does): out
    of it."""
    from madm_torch.ops import flash_attention as fa

    ref = toy_unet_side

    def one_product(eq, x, y, x3=False, y3=False):
        return torch.einsum(eq, tf32(x.float()), tf32(y.float()))

    def twin(q, k, v, o, g, lse, scale=None):
        o3, lse3 = attention_tf32x3_reference(q, k, v, scale)
        return attention_backward_tf32x3_reference(q, k, v, o3, g, lse3, scale)

    if product == "one":
        monkeypatch.setattr(fa, "_tf32_product", one_product)
    monkeypatch.setattr(fa, "flash_attention_backward", twin)
    unet = chip_smoke.MADM(chip_smoke.TOY, device="cpu", trainable=True).unet
    unet.load_state_dict(ref["start"])
    unet.requires_grad_(True)
    metrics, grads = chip_smoke.unet_loss_grads(unet, ref["x"])
    got = chip_smoke.readings(ref["metrics"], metrics, ref["grads"], grads)
    assert set(got["modules"]) == {"attentions", "other"}
    assert chip_smoke.hold("unet", got, ref["spreads"])[0] == passes
