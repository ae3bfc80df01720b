"""Time kernels K4 and K5 (the packed-head attention forward and backward)
on the card against another tree's K4 and K5.

    python -m madm_torch.profile_packed [--parent DIR] [--rounds 3] [--out PATH]

On the same seeded bf16 inputs at the UNet's packed self-attention,
[B, 4096, 8, 40] with G=3 for B=1 and 2: this tree's K4 (eval form, no lse)
and K5 (on K4's o and lse, as the train step calls it) and, with
``--parent``, the K4 and K5 of the ``madm_torch`` package in DIR (another
checkout, loaded under another name; its kernels build in its own
``build/``), in turns within one process (parent, this, this, parent, ...),
``--rounds`` turns a side.  A turn is the mean device time of ``REPS``
back-to-back calls between CUDA events, after warm-up, and the host time
to enqueue them (no synchronize until the last).  Also each tree's
forward and backward of one attention as the train step runs them (K4
writing lse where it does, then K5), and the largest differences between
the two trees' outputs.

Prints one JSON object (with the card's name and power limit) and writes it
to ``--out``.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import os
import statistics
import sys
import time
from pathlib import Path

import torch

from .device import card_line
from .ops import flash_attention as fa

SHAPES = ((1, 4096, 8, 40), (2, 4096, 8, 40))
REPS = 20


def load_tree_attention(root: Path):
    """The ``ops.flash_attention`` module of the madm_torch package under
    ``root``, imported as the package ``madm_parent``."""
    pkg = root / "madm_torch"
    spec = importlib.util.spec_from_file_location("madm_parent", pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["madm_parent"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("madm_parent.ops.flash_attention")


def calls(mod, q, k, v, do, scale, g):
    """{name: call} of a tree's K4 and K5 as the model calls them: K4 in an
    eval pass, K5 in the train step's backward (this tree's on K4's saved o
    and lse), and a forward and backward of one attention in a train step."""
    forward = mod.packed_attention_forward
    if "with_lse" in inspect.signature(forward).parameters:  # K4 writes what K5 starts from
        o, lse = forward(q, k, v, scale, g, with_lse=True)
        return {"K4": lambda: forward(q, k, v, scale, g),
                "K5": lambda: mod.packed_attention_backward(q, k, v, do, scale, g, o, lse),
                "K4+K5": lambda: mod.packed_attention_backward(
                    q, k, v, do, scale, g, *forward(q, k, v, scale, g, with_lse=True))}
    return {"K4": lambda: forward(q, k, v, scale, g),
            "K5": lambda: mod.packed_attention_backward(q, k, v, do, scale, g),
            "K4+K5": lambda: (forward(q, k, v, scale, g), mod.packed_attention_backward(q, k, v, do, scale, g))}


def turn_ms(fn, reps: int = REPS, warmup: int = 2):
    """(mean device ms, mean host us to enqueue) of one call over ``reps``
    back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = (time.perf_counter() - t0) / reps * 1e6
    end.synchronize()
    return start.elapsed_time(end) / reps, host


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="root of another checkout to time against")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/profile_packed.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_packed needs a GPU")
    trees = {"this": fa}
    if args.parent:
        trees["parent"] = load_tree_attention(Path(args.parent).resolve())
    order = (["parent", "this", "this", "parent"] * args.rounds)[: 2 * args.rounds] \
        if args.parent else ["this"] * args.rounds
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for b, s, h, d in SHAPES:
        g, scale = fa.pack_group(s, s, d, True), d ** -0.5
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen).bfloat16() for _ in range(4))
        fns = {name: calls(mod, q, k, v, do, scale, g) for name, mod in trees.items()}
        row = {"shape": [b, s, h, d], "g": g}
        for kernel in ("K4", "K5", "K4+K5"):
            times, host = {name: [] for name in trees}, {name: [] for name in trees}
            for name in order:
                ms, us = turn_ms(fns[name][kernel])
                times[name].append(ms)
                host[name].append(us)
            row[kernel] = {"ms": times, "median_ms": {n: statistics.median(t) for n, t in times.items()},
                           "host_us": host}
        if "parent" in trees:
            outs = {name: (f["K4"](), f["K5"]()) for name, f in fns.items()}
            o_this, o_par = (outs[n][0][0] if isinstance(outs[n][0], tuple) else outs[n][0] for n in ("this", "parent"))
            row["max_abs_diff_vs_parent"] = {
                "o": (o_this.float() - o_par.float()).abs().max().item(),
                **{n: (x.float() - y.float()).abs().max().item()
                   for n, x, y in zip(("dq", "dk", "dv"), outs["this"][1], outs["parent"][1])}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, do, fns
        torch.cuda.empty_cache()
    result = {"card": card_line(), "torch": torch.__version__, "order": order, "reps": REPS, "shapes": rows}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
