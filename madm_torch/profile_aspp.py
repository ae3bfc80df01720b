"""Time kernel K2 (``aspp_fused``) on the card, against another tree's K2
or against ablated builds of itself.

    python -m madm_torch.profile_aspp [--parent DIR] [--rounds 3] [--ablate] [--out PATH]

On the same seeded bf16 inputs at the eval crop (B=1 and B=2, 512x512) and
the slide head's stitched width (B=1, 512x1024), with the model's shapes
(4 embeds x 256 channels, dilations 6/12/18): this tree's K2 and, with
``--parent``, the K2 of the ``madm_torch`` package in DIR (another checkout,
loaded under another name; its kernel builds in its own ``build/``), in
turns within one process (parent, this, this, parent, ...), ``--rounds``
turns a side.  A turn is the mean device time of ``REPS`` back-to-back
calls between CUDA events, after warm-up.  Also the largest difference
between the two trees' outputs.

``--ablate`` times, at B=1 512x512, builds of ``csrc/aspp_fused.cu`` with
parts of the bf16 body taken out (``ABLATIONS``: a branch kind, the
depthwise, the products, the weight or halo loads), each against the
whole kernel in turns (whole, ablated, ablated, whole).  An ablated build
computes wrong outputs: its time says what the part costs.

Prints one JSON object (with the card's name and power limit) and writes
it to ``--out``.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from . import kernels
from .device import card_line
from .ops import aspp

SHAPES = ((1, 512, 512), (2, 512, 512), (1, 512, 1024))
REPS = 20

# Parts of the bf16 body an ablated build leaves out, as (first line, last
# line, replacement) edits of csrc/aspp_fused.cu: the lines from the first
# to the last (inclusive) give way to the replacement.
_EXPECT = "    mbar_expect_tx(full + s, xbytes + W_BYTES + (br ? TAP_BYTES : 0));"
ABLATIONS = {
    # the dilated branches' depthwise: constant A fragments (bf16 1.0)
    "no_depthwise": [("        float2 wlo[9], whi[9];",
                      "        f[3] = pack_bf16(fmaxf(s1[2] + bhi.x, 0.f), fmaxf(s1[3] + bhi.y, 0.f));",
                      "        uint32_t* f = af[ks & 1];\n        f[0] = f[1] = f[2] = f[3] = 0x3f803f80u;\n"
                      "        (void)taps; (void)xoff; (void)xswz;")],
    # the dilated branches' products (the fragment stays live)
    "no_dilated_products": [("        wgmma_rs<PC>(acc, af[ks & 1], desc(wb + ks * 2048, 8192), c | ks);", None,
                             "        if (af[ks & 1][0] == 0x12345678u) acc[0] += 1.f;")],
    "no_weight_loads": [(_EXPECT, None, "    (void)W_BYTES; mbar_expect_tx(full + s, xbytes + (br ? TAP_BYTES : 0));"),
                        ("    for (int j = 0; j < PC / 64; ++j) tma_load(st + X_BYTES + j * 8192, wm, full + s, "
                         "64 * j, row0, 0, 0, false);", None, "    (void)wm; (void)row0;")],
    "no_halo_loads": [(_EXPECT, None, "    (void)xbytes; mbar_expect_tx(full + s, W_BYTES + (br ? TAP_BYTES : 0));"),
                      ("      for (int r = 0; r < 2; ++r) tma_load(st + (1 + r) * SLOT_BYTES, xm, full + s, ce, x0, "
                       "y + r, b, true);", None, "      (void)xm;"),
                      ("      for (int r = 0; r < 4; ++r)",
                       "        tma_load(st + r * SLOT_BYTES, xm, full + s, ce, x0 - d, y + (r - 1) * d, b, true);",
                       "")],
    "only_aspp0": [("  if (!tma_tile(a, br, k, strip)) return;", None,
                    "  if (!tma_tile(a, br, k, strip) || br != 0) return;")],
    "only_dilated": [("  if (!tma_tile(a, br, k, strip)) return;", None,
                      "  if (!tma_tile(a, br, k, strip) || br == 0) return;")],
}
# the ablated builds --ablate times ('+' joins ablations)
ABLATE_RUNS = ("only_aspp0", "only_dilated", "only_dilated+no_depthwise",
               "only_dilated+no_dilated_products", "only_dilated+no_depthwise+no_weight_loads",
               "only_dilated+no_depthwise+no_halo_loads",
               "only_dilated+no_dilated_products+no_weight_loads+no_halo_loads",
               "no_weight_loads", "no_halo_loads")


def ablated_source(src: str, names) -> str:
    """csrc/aspp_fused.cu's text with the ablations ``names`` applied; raises
    if an edit's lines are not in it (the kernel changed under them)."""
    edits = []
    for name in names:
        edits += ABLATIONS[name]
    if "no_weight_loads" in names and "no_halo_loads" in names:  # both edit the expect line
        edits = [e for e in edits if e[0] != _EXPECT]
        edits.append((_EXPECT, None, "    (void)xbytes; (void)W_BYTES; mbar_expect_tx(full + s, br ? TAP_BYTES : 0);"))
    for first, last, repl in edits:
        i = src.find(first)
        if i < 0:
            raise ValueError(f"ablation line not in the kernel: {first.strip()}")
        j = i + len(first)
        if last is not None:
            j = src.find(last, i)
            if j < 0:
                raise ValueError(f"ablation line not in the kernel: {last.strip()}")
            j += len(last)
        src = src[:i] + repl + src[j:]
    return src


def build_ablated(runs) -> dict:
    """{run: its library}, each run's source built under build/madm_torch/ablate/,
    one nvcc a run, all started together."""
    src = (kernels.CSRC / "aspp_fused.cu").read_text()
    jobs = {}
    for run in runs:
        d = kernels.BUILD_DIR / "ablate" / run.replace("+", "-")
        d.mkdir(parents=True, exist_ok=True)
        (d / "aspp_fused.cu").write_text(ablated_source(src, run.split("+")))
        for header in kernels.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        jobs[run] = (d, subprocess.Popen([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", str(d / "lib.so"),
                                          str(d / "aspp_fused.cu")],
                                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for run, (d, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for ablation {run}:\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.madm_error_string.argtypes = [ctypes.c_int]
        lib.madm_error_string.restype = ctypes.c_char_p
        libs[run] = lib
    return libs


def ablate(gen: torch.Generator) -> list:
    """The whole kernel and each ablated build at B=1 512x512, in turns."""
    embeds, a = inputs(gen, 1, 512, 512)
    whole = kernels.load("aspp_fused")
    libs = build_ablated(ABLATE_RUNS)
    rows = []
    try:
        for run, lib in libs.items():
            times = {"whole": [], "ablated": []}
            for name in ("whole", "ablated", "ablated", "whole"):
                kernels._loaded["aspp_fused"] = whole if name == "whole" else lib
                times[name].append(turn_ms(lambda: aspp.aspp_fused(embeds, *a)))
            row = {"ablation": run, "ms": times,
                   "median_ms": {k: statistics.median(v) for k, v in times.items()}}
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        kernels._loaded["aspp_fused"] = whole
    return rows


def load_tree_aspp(root: Path):
    """The ``ops.aspp`` module of the madm_torch package under ``root``,
    imported as the package ``madm_parent``."""
    pkg = root / "madm_torch"
    spec = importlib.util.spec_from_file_location("madm_parent", pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["madm_parent"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("madm_parent.ops.aspp")


def inputs(gen: torch.Generator, b: int, h: int, w: int):
    def f(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    embeds = [f(b, h, w, 256).bfloat16() for _ in range(4)]
    args = (f(3, 3, 3, 1024, scale=0.1), f(3, 1024).abs() + 0.5, f(3, 1024, scale=0.1),
            f(3, 1024, 256, scale=0.03).bfloat16(), f(3, 256).abs() + 0.5, f(3, 256),
            f(1024, 256, scale=0.03).bfloat16(), f(256).abs() + 0.5, f(256))
    return embeds, args


def turn_ms(fn) -> float:
    """Mean device ms of one call over REPS back-to-back calls."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="root of another checkout to time against")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--ablate", action="store_true", help="also time ablated builds of this tree's K2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/profile_aspp.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_aspp needs a GPU")
    impls = {"this": aspp.aspp_fused}
    if args.parent:
        impls["parent"] = load_tree_aspp(Path(args.parent).resolve()).aspp_fused
    order = (["parent", "this", "this", "parent"] * args.rounds)[: 2 * args.rounds] \
        if args.parent else ["this"] * args.rounds
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for b, h, w in SHAPES:
        embeds, a = inputs(gen, b, h, w)
        outs = {name: fn(embeds, *a) for name, fn in impls.items()}
        torch.cuda.synchronize()
        times = {name: [] for name in impls}
        for name in order:
            times[name].append(turn_ms(lambda: impls[name](embeds, *a)))
        row = {"shape": [b, h, w, 1024], "ms": times,
               "median_ms": {k: statistics.median(v) for k, v in times.items()}}
        if "parent" in outs:
            row["max_abs_diff_vs_parent"] = (outs["this"].float() - outs["parent"].float()).abs().max().item()
        rows.append(row)
        print(json.dumps(row), flush=True)
        del embeds, a, outs
        torch.cuda.empty_cache()
    result = {"card": card_line(), "torch": torch.__version__, "order": order, "reps": REPS,
              "shapes": rows}
    if args.ablate:
        result["ablations"] = ablate(gen)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
