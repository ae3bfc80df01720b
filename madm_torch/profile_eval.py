"""Where one eval pass spends its time on the card.

    python -m madm_torch.profile_eval [--batch 1] [--eval-head full] [--slide-form batch] [--out PATH]

Runs the flagship config (full SD-v1.4, bf16) on seeded random weights, a
512x512 crop through ``eval_forward_ids`` in the given eval head (the
config's, 'auto', by default), or with ``--slide-form`` a 512x1024 image
through the sliding window in that form, and reports, after warm-up:
- the mean device time of ``PASSES`` back-to-back passes (CUDA events
  around the run), as ``chip_smoke.py`` times them;
and for one more pass:
- the host-clock pass time (ends in a synchronize);
- device time per stage (CUDA events from forward hooks on the VAE encoder,
  UNet, VAE decoder and projections, summed over their calls; the head and
  the stitching are the rest of the pass);
- device time per kernel and per kernel family from ``torch.profiler``, and
  the device's idle share (1 - kernel time / pass time);
and over ``PASSES`` more passes, the host ms a pass: to enqueue it (no
synchronize between passes) and inside the attention calls
(``ops.attention.flash_attention``, K1 and its wrapper).
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
from .evaluation import make_slide_eval_fn
from .models.madm import MADM, MADMConfig, init_random_

PASSES = 20  # timed back to back for the mean pass time
FAMILIES = (  # first match wins; lower-case substrings of kernel names
    ("flash_attention (K1)", ("flash_fwd",)),
    ("flash_attention_backward (K3)", ("dkdv_", "dq_tma", "dq_simt", "delta_kernel", "bwd_prep")),
    ("aspp_fused (K2)", ("aspp_fused",)),
    ("dw_branches (K6)", ("dw_branches",)),
    ("matmul_argmax (K7)", ("matmul_argmax",)),
    ("optimizer (multi-tensor)", ("multi_tensor", "adam")),
    ("convolution", ("fprop", "conv", "implicit", "winograd", "dgrad", "wgrad")),
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
    ap.add_argument("--eval-head", default="auto", help="auto, aspp, argmax, full or none")
    ap.add_argument("--slide-form", default=None, choices=("window", "batch"),
                    help="a 512x1024 sliding-window pass in this form")
    ap.add_argument("--out", default="chiprun_out/profile_eval.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval needs a GPU")

    model = init_random_(MADM(MADMConfig(eval_head=args.eval_head), device="cuda"),
                         torch.Generator(device="cuda").manual_seed(args.seed))
    width = 1024 if args.slide_form else 512
    images = torch.rand(args.batch, 512, width, 3, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(args.seed + 1))
    if args.slide_form:
        slide = make_slide_eval_fn(model, form=args.slide_form)

        def run():
            return slide(images)
    else:
        def run():
            return model.eval_forward_ids(images)
    for _ in range(2):
        run()
    torch.cuda.synchronize()

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(PASSES):
        run()
    end.record()
    end.synchronize()
    mean_ms = start.elapsed_time(end) / PASSES

    events = _stage_timer(model)
    t0 = time.perf_counter()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    pass_ms = start.elapsed_time(end)
    stages = {name: sum(evs[i].elapsed_time(evs[i + 1]) for i in range(0, len(evs), 2))
              for name, evs in events.items()}
    stages["head, stitching and the rest"] = pass_ms - sum(stages.values())

    kernel_ms, fam, top = kernel_breakdown(run)
    enqueue_ms, attention_ms = host_breakdown(run)
    result = {
        "card": card_line(),
        "batch": args.batch,
        "eval_head": model.eval_head_mode(),
        "slide_form": args.slide_form,
        "mean_pass_ms": mean_ms,
        "passes": PASSES,
        "pass_ms_host": host_ms,
        "pass_ms_device_events": pass_ms,
        "stages_ms": stages,
        "profiled_kernel_ms": kernel_ms,
        "device_idle_share": (1.0 - kernel_ms / pass_ms) if kernel_ms else None,
        "host_enqueue_ms": enqueue_ms,
        "host_attention_ms": attention_ms,
        "families_ms": fam,
        "top_kernels": top,
    }
    write_json(result, args.out)


def host_breakdown(fn):
    """Host ms a pass over ``PASSES`` passes of ``fn``, enqueued back to back:
    in all, and inside ``ops.attention.flash_attention``."""
    from .ops import attention

    inner, spent = attention.flash_attention, [0.0]

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        spent[0] += time.perf_counter() - t0
        return out

    attention.flash_attention = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PASSES):
            fn()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        attention.flash_attention = inner
    return enqueue * 1e3 / PASSES, spent[0] * 1e3 / PASSES


def kernel_breakdown(fn, n_top: int = 25):
    """Run ``fn`` once under ``torch.profiler``: (device kernel ms in all,
    {family: ms}, the ``n_top`` kernels by time)."""
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        fn()
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
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:n_top]
    return (sum(ms for ms, _ in kernels.values()),
            dict(sorted(fam.items(), key=lambda kv: -kv[1])),
            [{"name": n[:120], "ms": ms, "calls": c} for n, (ms, c) in top])


def write_json(result, out: str) -> None:
    """Print ``result`` as JSON and write it to ``out``."""
    text = json.dumps(result, indent=1)
    print(text)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write(text)


if __name__ == "__main__":
    main()
