#!/usr/bin/env python3
"""Smoke test of the madm_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits nonzero):
1. card: name and power limit;
2. build: the two CUDA kernels from madm_torch/csrc, one nvcc each, in parallel;
3. kernels against their plain twins in bf16 at the eval pass's shapes: max
   abs error with its tolerance, kernel ms, twin ms, library ms where one
   PyTorch call computes the same function, and the least time the card
   could take (bytes at 3.35 TB/s, operations at 989 TFLOP/s bf16);
4. the toy-width model in fp32 (TF32 off): the port on CUDA with kernels
   against the port on CPU with twins, logits and ids;
5. the flagship config (full SD-v1.4, 512x512, bf16) on seeded random
   weights: eval_forward_ids on [1,512,512,3] and [2,512,512,3] with the
   kernel launch counts of each pass, ms/crop and peak memory.
The second-to-last stdout line is the kernels JSON, the last the contract line.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time

import torch
import torch.nn.functional as F

from madm_torch import kernels
from madm_torch.device import card_line
from madm_torch.models.daformer import argmax_classes
from madm_torch.models.madm import MADM, MADMConfig, init_random_
from madm_torch.ops.aspp import aspp_fused, aspp_fused_reference
from madm_torch.ops.flash_attention import attention_reference, flash_attention

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12   # dense tensor-core bf16
SEED = 0

# (Sq, Sk, H, D, launches per 512x512 pass): 16 self + 16 cross attentions
# in the UNet's transformer blocks, 2 single-head VAE mid-block attentions
FLASH_SHAPES = (
    (4096, 4096, 8, 40, 5), (4096, 77, 8, 40, 5),
    (1024, 1024, 8, 80, 5), (1024, 77, 8, 80, 5),
    (256, 256, 8, 160, 5), (256, 77, 8, 160, 5),
    (64, 64, 8, 160, 1), (64, 77, 8, 160, 1),
    (4096, 4096, 1, 512, 2),
)
ASPP_SHAPES = ((1, 512, 512), (1, 512, 1024))  # eval crop; sliding-window stitched width


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=None, warmup=2):
    """Mean device ms per call over a run of calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if reps is None:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        reps = max(3, min(200, int(0.1 / max(time.perf_counter() - t0, 1e-6))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, flops):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def check_flash(gen):
    rows = []
    for sq, sk, h, d, per_pass in FLASH_SHAPES:
        q, k, v = (torch.randn(1, s, h, d, device="cuda", generator=gen).bfloat16() for s in (sq, sk, sk))
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attention_reference(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        tol = 2.0 ** -7 * max(1.0, ref.abs().max().item())  # bf16 output rounding
        ms = cuda_ms(lambda: flash_attention(q, k, v))
        plain = cuda_ms(lambda: attention_reference(q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        bnd, by = bound_ms(nbytes, 4 * h * sq * sk * d)
        row = dict(shape=[1, sq, sk, h, d], per_pass=per_pass, max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by)
        log(f"K1 flash_attention [B,Sq,Sk,H,D]=[1,{sq},{sk},{h},{d}] x{per_pass}/pass: "
            f"max_abs_err={err:.3e} (tol {tol:.3e}) ms={ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} bound_ms={bnd:.5f} ({by})")
        if not err <= tol:
            raise AssertionError(f"K1 at {row['shape']}: error {err} over tolerance {tol}")
        rows.append(row)
    return rows


def aspp_inputs(gen, b, h, w):
    def f(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    embeds = [f(b, h, w, 256).bfloat16() for _ in range(4)]
    args = (f(3, 3, 3, 1024, scale=0.1), f(3, 1024).abs() + 0.5, f(3, 1024, scale=0.1),
            f(3, 1024, 256, scale=0.03).bfloat16(), f(3, 256).abs() + 0.5, f(3, 256),
            f(1024, 256, scale=0.03).bfloat16(), f(256).abs() + 0.5, f(256))
    return embeds, args


def check_aspp(gen):
    rows = []
    for b, h, w in ASPP_SHAPES:
        embeds, args = aspp_inputs(gen, b, h, w)
        out = aspp_fused(embeds, *args)
        torch.cuda.synchronize()
        ref = aspp_fused_reference(embeds, *args)
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2.0 ** -6 * max(1.0, ref.float().abs().max().item())  # bf16 rounding of outputs and depthwise
        ms = cuda_ms(lambda: aspp_fused(embeds, *args), reps=5)
        plain = cuda_ms(lambda: aspp_fused_reference(embeds, *args), reps=3, warmup=1)
        pix = b * h * w
        nbytes = 2 * (4 * pix * 256 + pix * 1024 + 4 * 1024 * 256) + 4 * (3 * 9 * 1024 + 6 * 1024 + 8 * 256)
        bnd, by = bound_ms(nbytes, (3 * 9 * 2 + 4 * 2 * 256) * pix * 1024)
        row = dict(shape=[b, h, w, 4 * 256], max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                   bound_ms=bnd, bound_by=by)
        log(f"K2 aspp_fused [B,H,W,C]=[{b},{h},{w},1024]: max_abs_err={err:.3e} (tol {tol:.3e}) "
            f"ms={ms:.3f} plain_ms={plain:.3f} bound_ms={bnd:.4f} ({by})")
        if not err <= tol:
            raise AssertionError(f"K2 at {row['shape']}: error {err} over tolerance {tol}")
        rows.append(row)
    return rows


TOY = MADMConfig(num_classes=11, crop_size=(64, 64), unet_channels=(32, 64, 128, 128),
                 vae_channels=(32, 32, 64, 64), feature_dims=(3, 32, 64, 128),
                 projection_dim=(32, 32, 32, 32), compute_dtype=torch.float32)


def check_toy():
    cpu = init_random_(MADM(TOY, device="cpu"), torch.Generator().manual_seed(SEED))
    gpu = MADM(TOY, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    images = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(SEED + 1))
    counts0 = (flash_attention.launches, aspp_fused.launches)
    lg_gpu, ids_gpu = gpu.eval_forward(images).cpu(), gpu.eval_forward_ids(images).cpu()
    if (flash_attention.launches - counts0[0], aspp_fused.launches - counts0[1]) != (68, 1):
        raise AssertionError("toy pass on CUDA did not run K1 x34 per pass and K2 once")
    lg_cpu, ids_cpu = cpu.eval_forward(images), cpu.eval_forward_ids(images)
    err = (lg_gpu - lg_cpu).abs().max().item()
    tol = 1e-3 * max(1.0, lg_cpu.abs().max().item())  # fp32, other summation orders
    top2 = lg_cpu.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * tol
    agree = (ids_gpu == ids_cpu)[sure].float().mean().item()
    log(f"toy fp32 CUDA vs CPU: logits max_abs_err={err:.3e} (tol {tol:.3e}); ids equal on "
        f"{agree:.6f} of {int(sure.sum())} pixels with top-2 margin > {2 * tol:.1e}; "
        f"all pixels {(ids_gpu == ids_cpu).float().mean().item():.6f}")
    if not (err <= tol and agree == 1.0):
        raise AssertionError("toy-width CUDA path disagrees with the CPU twins")


def run_full(card):
    cfg = MADMConfig()
    t0 = time.perf_counter()
    model = init_random_(MADM(cfg, device="cuda"), torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"full width: MADMConfig() built with seeded random weights in "
        f"{time.perf_counter() - t0:.1f} s, {sum(p.numel() for p in model.parameters())} parameters")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    counts = {}
    for b in (1, 2):
        images = torch.rand(b, 512, 512, 3, device="cuda", generator=gen)
        model.eval_forward_ids(images)  # warm-up (cuDNN algorithm choice)
        torch.cuda.synchronize()
        flash_attention.launches = aspp_fused.launches = 0
        ids = model.eval_forward_ids(images)
        torch.cuda.synchronize()
        counts[b] = (flash_attention.launches, aspp_fused.launches)
        if ids.shape != (b, 512, 512) or ids.dtype != torch.int32:
            raise AssertionError(f"ids {tuple(ids.shape)} {ids.dtype}")
        lo, hi = ids.min().item(), ids.max().item()
        if lo < 0 or hi >= cfg.num_classes:
            raise AssertionError(f"ids outside [0, {cfg.num_classes}): {lo}..{hi}")
        logits = model.eval_forward(images)
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        agree = (argmax_classes(logits, dim=-1) == ids).float().mean().item()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: model.eval_forward_ids(images), reps=5, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"full width B={b}: K1 launches {counts[b][0]}, K2 launches {counts[b][1]}; ids in "
            f"[{lo}, {hi}], logits finite, K2 head ids equal module-head argmax on {agree:.4f} of "
            f"pixels; {ms / b:.2f} ms/crop ({ms:.2f} ms/pass), peak memory {peak:.2f} GiB "
            f"[{card}]")
        if counts[b] != (34, 1):
            raise AssertionError(f"B={b} pass launched K1 x{counts[b][0]}, K2 x{counts[b][1]}; "
                                 "expected 34 and 1")
    return counts[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    log(f"build: {kernels.build():.1f} s for {', '.join(kernels.KERNELS)} "
        f"(sm_90a, {kernels.BUILD_DIR})")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash_rows = check_flash(gen)
    aspp_rows = check_aspp(gen)
    check_toy()
    k1_launches, k2_launches = run_full(card)

    def per_pass(key):
        return sum(r[key] * r["per_pass"] for r in flash_rows)

    k1_b, k1_f = (sum(2 * (2 * sq * h * d + 2 * sk * h * d) * n for sq, sk, h, d, n in FLASH_SHAPES),
                  sum(4 * h * sq * sk * d * n for sq, sk, h, d, n in FLASH_SHAPES))
    kernels_line = {"kernels": [
        {"name": "flash_attention", "route": "cuda", "source": "madm_torch/csrc/flash_attention.cu",
         "replaces": "madm_tpu/ops/flash_attention.py:34", "launches": k1_launches,
         "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
         "ms": per_pass("ms"), "plain_ms": per_pass("plain_ms"), "bound_ms": per_pass("bound_ms"),
         "bound_by": bound_ms(k1_b, k1_f)[1], "library_ms": per_pass("library_ms"),
         "per": "one 512x512 pass at B=1 (sum over its 34 calls)", "shapes": flash_rows},
        {"name": "aspp_fused", "route": "cuda", "source": "madm_torch/csrc/aspp_fused.cu",
         "replaces": "madm_tpu/ops/aspp.py:208", "launches": k2_launches,
         "max_abs_err": max(r["max_abs_err"] for r in aspp_rows),
         "ms": aspp_rows[0]["ms"], "plain_ms": aspp_rows[0]["plain_ms"],
         "bound_ms": aspp_rows[0]["bound_ms"], "bound_by": aspp_rows[0]["bound_by"],
         "library_ms": None, "per": "one 512x512 crop at B=1", "shapes": aspp_rows},
    ]}
    log(card)
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
