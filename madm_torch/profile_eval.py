"""Where one eval pass spends its time on the card.

    python -m madm_torch.profile_eval [--batch 1] [--out chiprun_out/profile_eval.json]

Runs the flagship config (full SD-v1.4, 512x512, bf16) on seeded random
weights and reports, for one ``eval_forward_ids`` pass after warm-up:
- the host-clock pass time (ends in a synchronize);
- device time per stage (CUDA events from forward hooks on the VAE encoder,
  UNet, VAE decoder and projections; the head is the rest of the pass);
- device time per kernel and per kernel family from ``torch.profiler``, and
  the device's idle share (1 - kernel time / pass time).
Needs a GPU; prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import torch

from .device import card_line
from .models.madm import MADM, MADMConfig, init_random_

FAMILIES = (  # first match wins; lower-case substrings of kernel names
    ("flash_attention (K1)", ("flash_fwd",)),
    ("aspp_fused (K2)", ("aspp_fused",)),
    ("convolution", ("fprop", "conv", "implicit", "winograd", "dgrad")),
    ("matmul", ("gemm", "cutlass", "cublas", "xmma")),
    ("norm/reduce", ("reduce", "norm", "welford")),
    ("elementwise/copy", ("elementwise", "vectorized", "copy", "cat", "fill", "unrolled")),
    ("resize", ("upsample", "interp")),
)


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def _stage_timer(model: MADM):
    """Forward hooks recording CUDA events around the backbone's stages."""
    events = defaultdict(list)
    stages = {"vae.encoder": model.vae.encoder, "unet": model.unet,
              "vae.decoder": model.vae.decoder, "projections": model.feature_projections}
    for name, mod in stages.items():
        def pre(_m, _a, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name].append(ev)

        def post(_m, _a, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name].append(ev)

        mod.register_forward_pre_hook(pre)
        mod.register_forward_hook(post)
    return events


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/profile_eval.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval needs a GPU")

    model = init_random_(MADM(MADMConfig(), device="cuda"),
                         torch.Generator(device="cuda").manual_seed(args.seed))
    images = torch.rand(args.batch, 512, 512, 3, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(args.seed + 1))
    for _ in range(2):
        model.eval_forward_ids(images)
    torch.cuda.synchronize()

    events = _stage_timer(model)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    model.eval_forward_ids(images)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    pass_ms = start.elapsed_time(end)
    stages = {name: evs[0].elapsed_time(evs[1]) for name, evs in events.items()}
    stages["head (embeds, K2, bottleneck, conv_seg, argmax) and the rest"] = pass_ms - sum(stages.values())

    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        model.eval_forward_ids(images)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernels[e.key] = (kernels.get(e.key, (0.0, 0))[0] + us / 1e3,
                              kernels.get(e.key, (0.0, 0))[1] + e.count)
    fam = defaultdict(float)
    for name, (ms, _) in kernels.items():
        fam[_family(name)] += ms
    kernel_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    result = {
        "card": card_line(),
        "batch": args.batch,
        "pass_ms_host": host_ms,
        "pass_ms_device_events": pass_ms,
        "stages_ms": stages,
        "profiled_kernel_ms": kernel_ms,
        "device_idle_share": (1.0 - kernel_ms / pass_ms) if kernels else None,
        "families_ms": dict(sorted(fam.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms": ms, "calls": c} for n, (ms, c) in top],
    }
    text = json.dumps(result, indent=1)
    print(text)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)


if __name__ == "__main__":
    main()
