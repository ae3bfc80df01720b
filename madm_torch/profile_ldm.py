"""Time an ``LdmExtractor`` pass (ODISE's taps, seeded weights) on the card,
against another tree's extractor on the same weights.

    python -m madm_torch.profile_ldm [--parent DIR] [--rounds 3] [--out PATH]

At [B, 512, 512, 3] for B=1 and 2, steps (0,): this tree's extractor and,
with ``--parent``, the extractor of the ``madm_torch`` package in DIR
(another checkout, loaded under another name; its kernels build in its own
``build/``), in turns within one process (parent, this, this, parent, ...),
``--rounds`` turns a side.  A turn is the mean device time of ``REPS``
passes between CUDA events, after a warm-up pass.  Then one pass of each
tree under ``torch.profiler``: the device time of K1's kernels (names
holding ``flash_fwd``) and of all kernels, and the idle share of the
device over the pass.

Prints one JSON object (with the card's name and power limit) and writes it
to ``--out``.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import time
from pathlib import Path

import torch

from .device import card_line
from .models import ldm_extractor as lx
from .profile_packed import load_tree_attention, turn_ms

BATCHES = (1, 2)
REPS = 3
TAPS = dict(encoder_block_indices=(5, 7), unet_block_indices=(2, 5, 8, 11), decoder_block_indices=(2, 5))


def profiled(fn):
    """(K1 device ms, all-kernel device ms, wall ms) of one pass under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    k1 = total = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:  # host ops carry their kernels' time too
            continue
        dev = getattr(ev, "self_device_time_total", None)
        dev = (ev.self_cuda_time_total if dev is None else dev) / 1e3
        total += dev
        if "flash_fwd" in ev.key:
            k1 += dev
    return k1, total, wall


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="root of another checkout to time against")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/profile_ldm.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_ldm needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    this = lx.init_random_(lx.LdmExtractor(device="cuda", compute_dtype=torch.float32, **TAPS), gen)
    trees = {"this": this}
    if args.parent:
        load_tree_attention(Path(args.parent).resolve())  # imports the parent package as madm_parent
        parent = importlib.import_module("madm_parent.models.ldm_extractor")
        trees["parent"] = parent.LdmExtractor(device="cuda", compute_dtype=torch.float32, **TAPS)
        trees["parent"].load_state_dict(this.state_dict())
    order = (["parent", "this", "this", "parent"] * args.rounds)[: 2 * args.rounds] \
        if args.parent else ["this"] * args.rounds
    rows = []
    with torch.no_grad():
        for b in BATCHES:
            x = torch.rand(b, 512, 512, 3, device="cuda", generator=gen)
            fns = {name: (lambda ex=ex: ex(x)) for name, ex in trees.items()}
            times = {name: [] for name in trees}
            for name in order:
                times[name].append(turn_ms(fns[name], REPS, warmup=1)[0])
            row = {"batch": b, "ms": times, "median_ms": {n: statistics.median(t) for n, t in times.items()}}
            for name, fn in fns.items():
                k1, total, wall = profiled(fn)
                row[name] = {"k1_ms": k1, "kernel_ms": total, "wall_ms": wall,
                             "idle_share": max(0.0, 1.0 - total / wall)}
            if "parent" in trees:
                outs = {name: fn() for name, fn in fns.items()}
                row["max_rel_diff_vs_parent"] = max(
                    ((a.float() - p.float()).abs().max() / p.float().abs().max().clamp(min=1.0)).item()
                    for a, p in zip(outs["this"], outs["parent"]))
            rows.append(row)
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    result = {"card": card_line(), "torch": torch.__version__, "order": order, "reps": REPS,
              "batches": rows}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
