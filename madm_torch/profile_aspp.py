"""Time the eval head's kernels on the card, K2 (``aspp_fused``, the
default), K6 (``dw_branches``) or K7 (``matmul_argmax``), against another
tree's or against ablated builds of this tree's.

    python -m madm_torch.profile_aspp [--kernel aspp|dw|argmax] [--parent DIR] [--rounds 3]
                                      [--ablate] [--out PATH]

On the same seeded bf16 inputs at the eval crop (B=1 and B=2, 512x512) and
the slide head's stitched width (B=1, 512x1024), with the model's shapes
(K2: 4 embeds x 256 channels, dilations 6/12/18; K6: the 'full' head's one
call a dilation, 6, 12 and 18, over the 1024-channel concat; K7: conv_seg
256 -> 11 classes): this tree's kernel and, with ``--parent``, the kernel
of the ``madm_torch`` package in DIR (another checkout, loaded under
another name; its kernels build in its own ``build/``), in turns within one
process (parent, this, this, parent, ...), ``--rounds`` turns a side.  A
turn is the mean device time of ``REPS`` back-to-back calls between CUDA
events, after warm-up.  Also the largest difference between the two trees'
outputs (K7: the ids that differ, and the largest gap between the fp32
logits at the two trees' ids).

``--ablate`` times, at B=1 512x512, builds of the kernel's source with
parts of its bf16 body taken out, each against the whole kernel in turns
(whole, ablated, ablated, whole): for K2 (``ABLATIONS``) a branch kind, the
depthwise, the products, the weight or halo loads; for K6
(``DW_ABLATIONS``, at d = 6 and 18) the stores, the taps' arithmetic, or
both (the ring of TMA loads alone).  An ablated build computes wrong
outputs: its time says what the part costs.

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
from .profile_packed import turn_ms

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
# K6's bf16 body (csrc/dw_branches.cu), edited the same way
DW_ABLATIONS = {
    # the 16-byte stores of finished rows (the values are still formed)
    "no_stores": [("      if (x < a.W) *reinterpret_cast<uint4*>(o + (size_t)x * a.C) = raw;", None,
                   "      if (x < a.W && raw.x == 0x7fc17fc1u && raw.y == 0x7fc27fc2u)\n"
                   "        *reinterpret_cast<uint4*>(o + (size_t)x * a.C) = raw;")],
    # the 27 taps' FMAs: each staged value is added once instead
    "no_taps": [("          acc[A][ci][k] = fmaf(tw[6 + kx][k], xv, acc[A][ci][k]);",
                 "          acc[N][ci][k] = fmaf(tw[kx][k], xv, acc[N][ci][k]);",
                 "          acc[P][ci][k] += xv;")],
}
DW_ABLATE_RUNS = ("no_stores", "no_taps", "no_taps+no_stores")
SOURCES = {"aspp": ("aspp_fused", ABLATIONS, ABLATE_RUNS), "dw": ("dw_branches", DW_ABLATIONS, DW_ABLATE_RUNS)}


def ablated_source(src: str, names, table=ABLATIONS) -> str:
    """A kernel source's text with the ablations ``names`` of ``table``
    (csrc/aspp_fused.cu's by default) applied; raises if an edit's lines are
    not in it (the kernel changed under them)."""
    edits = []
    for name in names:
        edits += table[name]
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


def build_ablated(runs, kernel: str = "aspp") -> dict:
    """{run: its library}, each run's source built under
    build/madm_torch/ablate/, one nvcc a run, all started together."""
    name, table, _ = SOURCES[kernel]
    src = (kernels.CSRC / f"{name}.cu").read_text()
    jobs = {}
    for run in runs:
        d = kernels.BUILD_DIR / "ablate" / f"{name}-{run.replace('+', '-')}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{name}.cu").write_text(ablated_source(src, run.split("+"), table))
        for header in kernels.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        jobs[run] = (d, subprocess.Popen([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", str(d / "lib.so"),
                                          str(d / f"{name}.cu")],
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


def ablate(gen: torch.Generator, kernel: str = "aspp") -> list:
    """The whole kernel and each ablated build at B=1 512x512, in turns (K6
    at d = 6 and 18)."""
    name, _, runs = SOURCES[kernel]
    if kernel == "aspp":
        embeds, a = inputs(gen, 1, 512, 512)
        cases = {"": lambda: aspp.aspp_fused(embeds, *a)}
    else:
        x, taps, scale, bias = dw_inputs(gen, 1, 512, 512)
        cases = {f"d={d}": (lambda d=d: aspp.dw_branches([x], taps, scale, bias, (d,))) for d in (6, 18)}
    whole = kernels.load(name)
    libs = build_ablated(runs, kernel)
    rows = []
    try:
        for run, lib in libs.items():
            for case, fn in cases.items():
                times = {"whole": [], "ablated": []}
                for turn in ("whole", "ablated", "ablated", "whole"):
                    kernels._loaded[name] = whole if turn == "whole" else lib
                    times[turn].append(turn_ms(fn, REPS)[0])
                row = {"ablation": run, "case": case, "ms": times,
                       "median_ms": {k: statistics.median(v) for k, v in times.items()}}
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        kernels._loaded[name] = whole
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


def dw_inputs(gen: torch.Generator, b: int, h: int, w: int):
    """K6's inputs at the 'full' head: the 1024-channel concat, one dilation's
    taps and BN."""
    x = torch.randn(b, h, w, 1024, device="cuda", generator=gen).bfloat16()
    taps = torch.randn(1, 3, 3, 1024, device="cuda", generator=gen) / 3
    scale = torch.rand(1, 1024, device="cuda", generator=gen) + 0.5
    bias = torch.randn(1, 1024, device="cuda", generator=gen) * 0.1
    return x, taps, scale, bias


def cases(kernel: str, gen: torch.Generator, mods: dict):
    """(label, {tree: call}, compare) of each timed case: ``compare`` gives
    the difference between two trees' outputs."""
    for b, h, w in SHAPES:
        if kernel == "aspp":
            embeds, a = inputs(gen, b, h, w)
            yield ([b, h, w, 1024], {t: (lambda m=m: m.aspp_fused(embeds, *a)) for t, m in mods.items()},
                   lambda o, p: {"max_abs_diff_vs_parent": (o.float() - p.float()).abs().max().item()})
        elif kernel == "dw":
            x, taps, scale, bias = dw_inputs(gen, b, h, w)
            for d in (6, 12, 18):
                yield ([b, h, w, 1024, d],
                       {t: (lambda m=m, d=d: m.dw_branches([x], taps, scale, bias, (d,))[0])
                        for t, m in mods.items()},
                       lambda o, p: {"max_abs_diff_vs_parent": (o.float() - p.float()).abs().max().item()})
        else:
            x = torch.randn(b, h, w, 256, device="cuda", generator=gen).bfloat16()
            wt = torch.randn(256, 11, device="cuda", generator=gen) / 16
            bias = torch.randn(11, device="cuda", generator=gen) * 0.1
            logits = x.float() @ wt + bias

            def compare(o, p, logits=logits):
                gap = logits.gather(-1, o.long()[..., None]) - logits.gather(-1, p.long()[..., None])
                return {"ids_differing_from_parent": int((o != p).sum()),
                        "max_logit_gap_vs_parent": gap.abs().max().item()}
            yield ([b, h, w, 256, 11], {t: (lambda m=m: m.matmul_argmax(x, wt, bias)) for t, m in mods.items()},
                   compare)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="aspp", choices=("aspp", "dw", "argmax"),
                    help="K2 (aspp_fused), K6 (dw_branches) or K7 (matmul_argmax)")
    ap.add_argument("--parent", default=None, help="root of another checkout to time against")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--ablate", action="store_true", help="also time ablated builds of this tree's kernel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/profile_aspp.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_aspp needs a GPU")
    if args.ablate and args.kernel == "argmax":
        raise SystemExit("profile_aspp: --ablate takes --kernel aspp or dw")
    mods = {"this": aspp}
    if args.parent:
        mods["parent"] = load_tree_aspp(Path(args.parent).resolve())
    order = (["parent", "this", "this", "parent"] * args.rounds)[: 2 * args.rounds] \
        if args.parent else ["this"] * args.rounds
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for shape, fns, compare in cases(args.kernel, gen, mods):
        outs = {name: fn() for name, fn in fns.items()}
        torch.cuda.synchronize()
        times = {name: [] for name in fns}
        for name in order:
            times[name].append(turn_ms(fns[name], REPS)[0])
        row = {"shape": shape, "ms": times, "median_ms": {k: statistics.median(v) for k, v in times.items()}}
        if "parent" in outs:
            row.update(compare(outs["this"], outs["parent"]))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del outs
        torch.cuda.empty_cache()
    result = {"card": card_line(), "torch": torch.__version__, "kernel": args.kernel, "order": order,
              "reps": REPS, "shapes": rows}
    if args.ablate:
        result["ablations"] = ablate(gen, args.kernel)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
