#!/usr/bin/env python3
"""Smoke test of the madm_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits nonzero):
1. card: name and power limit;
2. build: the CUDA kernels from madm_torch/csrc, one nvcc each, in parallel;
3. what ptxas made of K1's, K3's (and K5's bf16 body, the same library),
   K4's, K5's fp32, K2's, K6's and K7's kernels (registers, shared memory,
   spills, wgmma ptxas serialized; K6's and K7's bf16 bodies must not
   spill), their HGMMA (wgmma), UTMALDG / UTMASTG (TMA load / store) and
   HMMA SASS counts (K6 must hold TMA loads, K7 TMA loads and wgmma), and
   the host cost of a tensor map and of a K1 call; then kernels
   against their plain twins in bf16 at the main path's shapes (K1 at the
   eval pass's, K2 at the eval crop for B=1 and 2 and at the slide head's
   W=1024, with ragged shapes checked too and, as a yardstick for its
   product part, the four products alone in torch.matmul, K3 at the train
   step's, K1 and K3 also at B=2 for Sq=4096; K4 and K5 at the packed
   self-attention's [B,4096,8,40] for B=1 and 2, K4's lse too, and K5 also
   called without the forward's o and lse; K6 at the 'full' eval head's
   one call a dilation (6, 12, 18) over the 1024-channel concat at B=1,
   B=2 and W=1024, and on ragged shapes with several dilations a call; K7
   at the eval head's conv_seg at B=1, B=2, W=1024, 19 classes and a
   ragged pixel count; each bf16 row with its launch plan held to the C
   library's):
   max abs error with its tolerance, kernel ms, twin
   ms, library ms where one PyTorch call computes the same function (SDPA
   forward and backward for K1/K4 and K3/K5), and the least time the card
   could take (bytes at 3.35 TB/s, operations at 989 TFLOP/s bf16 on the
   tensor cores, or 67 TFLOP/s fp32 on the CUDA cores for K6 and K7);
4. the toy-width model in fp32 (TF32 off): the port on CUDA with kernels
   against the port on CPU with twins, logits and ids, in the 'aspp',
   'argmax' and 'full' eval heads (the fp32 bodies of K2, K6 and K7);
5. the flagship config (full SD-v1.4, 512x512, bf16) on seeded random
   weights: eval_forward_ids on [1,512,512,3] and [2,512,512,3] in the
   'aspp', 'argmax' and 'full' eval heads, with the kernel launch counts of
   each pass, ms/crop, peak memory and each head's ids against 'aspp'; then
   the same weights with flash_pack=True in the 'aspp' head (K1 29, K4 5,
   K2 1), ids against the unpacked pass's;
6. the toy-width train step in fp32 (TF32 off), shipped TrainConfig: two
   steps on CUDA (K1, K3) against two on CPU (twins) from the same weights,
   batches and random draws: losses, grad_norm, gradients, parameters; then
   the mixed-precision path: one step of a toy whose heads suit K3's bf16
   body, bf16 compute against fp32 compute on CUDA from the same fp32
   masters: losses, grad_norm and each trained tensor's gradient; each of
   the two again with flash_pack=True at a 256x256 crop, where the S=1024
   self-attentions take K4/K5 (fp32 bodies at D=4, bf16 bodies at D=8);
7. the flagship train step (MADMConfig(), shipped TrainConfig) on seeded
   random weights and synthetic batches through madm_torch.train.loop.train:
   one warm-up and two steps at B=1 and at B=2, with losses, launch counts,
   ms/step and peak memory of each; after B=1's, one more step in which
   every trained tensor must get a finite gradient, not all zero, and move;
   then an eval pass of the trained bf16 model; all of it again with
   flash_pack=True (K1 89, K3 54, K4 15, K5 10 a step);
8. sliding-window eval of [1,512,1024,3] and [2,512,1024,3] images in both
   forms, without and with eval_with_noise=900: ms/image, peak memory,
   K1/K2 launches; then inference_on_dataset over 4 synthetic labelled
   samples, single-crop at batch 2 and sliding-window at batch 1: metrics
   and s/image;
9. the trainer CLI, ``madm_torch.main.main``, with the depth config at full
   width in bf16 and model.flash_pack=True on a synthetic PNG dataset of 4
   images at 512x1024: two iterations at --bs 2, eval, checkpoints (s/iter,
   metrics, files, launch counts), then --eval-only --init-from the best
   checkpoint, which must give the same metrics;
10. real-weight loading: a seeded full-width bf16 trainable model of the
   depth config with LoRA adapters default_r16_a16 and Depth_r16_a8 (B drawn
   nonzero, the UNet rounded to fp16) writes an SD snapshot (UNet F16
   safetensors, VAE fp32 .bin, CLIP ViT-L/14 text encoder BF16 safetensors)
   and a released .pth in the reference's layout; uncond_inputs on CUDA
   against the CPU; a model built through the loaders (as the CLI builds
   it) equal to the writer tensor by tensor; its 'aspp' ids with the Depth
   adapter equal to the writer's (K1 34, K2 1); one train step with the
   adapters (K1 104, K3 64; every adapter gradient finite and nonzero);
   then ``--eval-only --init-from released.pth --sd-snapshot`` through the
   CLI, whose metrics must equal ``do_test`` on the writer;
11. the UDA step's ablation branches in four groups (MIC, mic_reg,
   denoise_supervise, fd, noise_reg, pl_crop, 'discrete', 'batch',
   linear_mix; remove_texture, prompt_confidence, no mixup, 'without
   cross-attention', ema_w_unet with two adapters, unet_lr; the masked
   prompt, add_latent_noise, norm_latent_noise; the perturbed prompt at
   prompt_seq_len=100, 'L2', 'attention', the linear schedule): (a) one toy
   fp32 step of each, CUDA against CPU at phase 6's tolerances; (b) one
   full-width bf16 step of each at B=1 after a warm-up, its K1/K3 launches
   equal to the counts derived from its passes (``derived_launches``),
   every trained tensor's gradient finite and nonzero, the branch losses
   nonzero, ms and peak memory; (c) K1 and K3 against their twins at the
   cross-attentions' key length 100;
12. the JAX package's optimizer reducers and data parallelism: (a)
   optimizer.name='adafactor', adafactor with no_momentum, and adamw with
   mu_dtype='bfloat16': one toy fp32 step of each, CUDA against CPU from
   one state at phase 6's tolerances (each weight and optimizer state
   tensor on the rule applied to the CPU's state, ``compare``), then each
   at full width in bf16, B=1, a warm-up and two steps (K1 104 and K3 64 a
   step, ms, peak memory, the optimizer state's bytes equal to the
   reckoning from the trained shapes, every trained tensor finite and on
   its rule); (b) two ranks spawned on the one card over gloo on CUDA
   tensors: the toy's two steps at world 2 (B=1 a rank), each from the
   state of a step at B=2 in one process, against those steps, then the
   shipped step at full width with ZeRO-1 (each
   rank K1 104 and K3 64 a step, the model states bit-identical, each
   rank's peak memory and half the optimizer state; host ms on a shared
   card are not a scaling figure); (c) the CLI with --distributed at
   WORLD_SIZE=1 on NCCL (phase 9's run), then --eval-only --init-from its
   best checkpoint in one process, which must give the same metrics.
13. the model variants of ROADMAP §A3: (a) the 'attention' group (capture
   at res 16/32 'up', the concat slot, fd_attention, target_attention_loss)
   and the 'structure' group (the second head, mask_diff, the pixel-unshuffle
   tower, per-layer prompts, the ISA fuse layer, final_fuse): one toy fp32
   step of each, CUDA against CPU at phase 6's tolerances; (b) each at full
   width in bf16, B=1 ('structure' also at B=2), then ISA alone at B=1 and
   B=2: K1/K3 launches equal to ``variant_launches``, every trained tensor's
   gradient finite and nonzero, the branch losses nonzero, ms and peak
   memory; each group's model round-trips its checkpoints; (c) full-width
   eval passes at B=1 and B=2 of 'isa', 'conv', 'sep_conv', final_fuse and
   the concat slot ('none'), and of the second head in 'aspp' and 'full':
   ids, launches, ms/crop; (d) a captured cross-attention layer against K1
   at Sq 1024 and 256; (e) a slide_training step at [1, 512, 1024, 3].
The second-to-last stdout line is the kernels JSON, the last the contract line.
Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import copy
import ctypes
import hashlib
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from madm_torch import kernels
from madm_torch.checkpoint import (
    Checkpointer,
    convert_madm_pth,
    merge_into_model,
    reference_state_dict,
    save_sd_snapshot,
)
from madm_torch.device import card_line
from madm_torch.evaluation import DSECSemSegEvaluator, inference_on_dataset, make_slide_eval_fn
from madm_torch.models.clip_text import CLIPTextTransformer, compute_uncond_inputs
from madm_torch.models.daformer import argmax_classes
from madm_torch.models.madm import MADM, MADMConfig, init_random_, trainable_parameters
from madm_torch.ops.aspp import (
    argmax_c_plan,
    argmax_plan,
    aspp_fused,
    aspp_fused_reference,
    aspp_plan,
    c_plan,
    dw_branches,
    dw_branches_reference,
    dw_c_plan,
    dw_plan,
    matmul_argmax,
    matmul_argmax_reference,
)
from madm_torch.ops.flash_attention import (
    attention_backward_reference,
    attention_reference,
    backward_plan,
    flash_attention,
    flash_attention_backward,
    flash_attention_forward,
    forward_plan,
    pack_group,
    packed_attention,
    packed_attention_backward,
    packed_attention_backward_reference,
    packed_attention_forward,
    packed_attention_reference,
    packed_backward_plan,
    packed_forward_plan,
)
from madm_torch.parallel import dist as dist_lib
from madm_torch.train.loop import init_train_state, synthetic_batches, train
from madm_torch.train.optimizer import factored_dims
from madm_torch.train.train_step import (
    TrainConfig,
    add_feature_distance_baseline,
    make_train_state,
    sample_draws,
    train_step,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12   # dense tensor-core bf16
FP32_FLOP_PER_S = 67e12    # CUDA-core fp32 (no tensor-core form: depthwise taps, 11-class dots)
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
# (B, Sq, Sk, H, D, launches per pass): FLASH_SHAPES at B=1, and B=2 (the
# shipped train step's batch) at the Sq=4096 shapes; pass and step sums use B=1
FLASH_CASES = tuple((1, *s) for s in FLASH_SHAPES) + tuple((2, *s) for s in FLASH_SHAPES if s[0] == 4096)
# [B, S, H, D] of the packed self-attentions (the five at S=4096 of a 512x512 pass)
PACKED_SHAPES = ((1, 4096, 8, 40), (2, 4096, 8, 40))
# eval crop at B=1 and B=2 (the B=2 'aspp' pass calls K2 once); sliding-window stitched width
ASPP_SHAPES = ((1, 512, 512), (2, 512, 512), (1, 512, 1024))
# ragged shapes K2's bf16 body takes (B, H, W, EC, embeds, dilations): halo
# rows and columns past every border, a last strip and row pair cut short
ASPP_RAGGED = ((1, 7, 100, 64, 2, (24, 5, 2)), (2, 37, 65, 128, 1, (1, 2, 3)))
DW_DILATIONS = (6, 12, 18)  # the 'full' head: one K6 call a dilation over the 1024-channel concat
# K6 at the 'full' head's concat (C = 1024, one dilation a call): the eval
# crop at B=1 (the kernels line's row) and B=2, the slide head's W=1024
DW_SHAPES = ((1, 512, 512), (2, 512, 512), (1, 512, 1024))
# ragged K6 calls (B, H, W, EC, embeds, dilations): three dilations in one
# call, d > H, d = 1, a last strip and chains cut short, chains cut into
# segments
DW_RAGGED = ((1, 7, 100, 64, 2, (18, 5, 2)), (2, 37, 65, 128, 1, (1, 2, 3)),
             (1, 512, 512, 256, 4, (6, 12, 18)))
# K7 (B, H, W, C, classes): the eval crop at B=1 (the kernels line's row) and
# B=2, the slide head's W=1024, 19 classes (32 padded), a ragged pixel count
ARGMAX_SHAPES = ((1, 512, 512, 256, 11), (2, 512, 512, 256, 11), (1, 512, 1024, 256, 11),
                 (1, 512, 512, 256, 19), (1, 37, 65, 256, 11))
COUNTERS = {"K1": flash_attention, "K2": aspp_fused, "K3": flash_attention_backward,
            "K4": packed_attention, "K5": packed_attention_backward,
            "K6": dw_branches, "K7": matmul_argmax}
# launches of one 512x512 eval pass, by eval head
EVAL_LAUNCHES = {"aspp": {"K1": 34, "K2": 1}, "argmax": {"K1": 34, "K7": 1},
                 "full": {"K1": 34, "K6": 3, "K7": 1}}
# with MADMConfig.flash_pack: the five UNet self-attentions at S=4096 (two in
# down_blocks[0], three in up_blocks[3]) take K4 in place of K1
PACKED_EVAL_LAUNCHES = {"K1": 29, "K4": 5, "K2": 1}
# per train step: K1 in 3 backbone passes (teacher, source, mixed) x 34 + 2
# palette encodes x 1 (the VAE encoder's attention); K3 in 2 grad passes x 32
# UNet attentions (the VAE runs without a graph); with flash_pack, 5 of each
# pass's attentions take K4 and 5 of each grad pass's K5
TRAIN_LAUNCHES = {"K1": 3 * 34 + 2, "K3": 2 * 32}
PACKED_TRAIN_LAUNCHES = {"K1": 3 * 29 + 2, "K3": 2 * 27, "K4": 3 * 5, "K5": 2 * 5}


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


def bound_ms(nbytes, flops, flop_rate=BF16_FLOP_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def launch_counts():
    """Launches since ``reset_counts`` of every kernel that launched."""
    return {k: fn.launches for k, fn in COUNTERS.items() if fn.launches}


def plan_line(kind, b, sq, sk, h, d):
    """The Python launch plan of K1 or K3 at a bf16 shape, held to the one
    the C library computes; returns a short description."""
    out = (ctypes.c_int * 9)()
    if kind == "K1":
        plan = forward_plan(b, sq, sk, h, d, torch.bfloat16)
        kernels.load("flash_attention").madm_flash_attention_fwd_plan(b, sq, sk, h, d, out)
        mine = [plan.dn, plan.bq, plan.bk, plan.warpgroups, int(plan.split_d), plan.stages,
                plan.launches[0].smem]
        theirs = list(out)[:7]
    else:
        plan = backward_plan(b, sq, sk, h, d, torch.bfloat16)
        fn = kernels.load("flash_attention_bwd").madm_flash_attention_bwd_plan
        fn.restype = ctypes.c_longlong
        nbytes = fn(b, sq, sk, h, d, out)
        smem = {l.kernel: l.smem for l in plan.launches}
        mine = [plan.dn, plan.bq, plan.warpgroups, plan.nsplit, plan.bk_dq, plan.bq_dq // 64, plan.sqp,
                smem["dkdv_tma"], smem["dq_tma"], plan.workspace_bytes]
        theirs = list(out) + [nbytes]
    if mine != theirs:
        raise AssertionError(f"{kind} plan at {[b, sq, sk, h, d]}: Python {mine}, C {theirs}")
    return ("plan " + ", ".join(f"{l.kernel} grid {l.grid} x{l.threads} smem {l.smem}" for l in plan.launches)
            + (f", nsplit {plan.nsplit}" if kind == "K3" else ""))


def check_flash(gen, cases=FLASH_CASES):
    rows = []
    for b, sq, sk, h, d, per_pass in cases:
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).bfloat16() for s in (sq, sk, sk))
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attention_reference(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        tol = 2.0 ** -7 * max(1.0, ref.abs().max().item())  # bf16 output rounding
        del ref
        ms = cuda_ms(lambda: flash_attention(q, k, v))
        plain = cuda_ms(lambda: attention_reference(q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        bnd, by = bound_ms(nbytes, 4 * b * h * sq * sk * d)
        row = dict(shape=[b, sq, sk, h, d], per_pass=per_pass, max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by)
        log(f"K1 flash_attention [B,Sq,Sk,H,D]=[{b},{sq},{sk},{h},{d}] x{per_pass}/pass: "
            f"max_abs_err={err:.3e} (tol {tol:.3e}) ms={ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} bound_ms={bnd:.5f} ({by}); {plan_line('K1', b, sq, sk, h, d)}")
        if not err <= tol:
            raise AssertionError(f"K1 at {row['shape']}: error {err} over tolerance {tol}")
        rows.append(row)
    return rows


def check_flash_bwd(gen, cases=FLASH_CASES):
    """K3 against its twin at the 8 UNet shapes (the VAE's D=512 never trains)
    and at B=2 for the two Sq=4096 ones, with K1's lse against the fp32
    log-sum-exp on the way."""
    rows = []
    for b, sq, sk, h, d, per_pass in cases:
        if d > 160:
            continue
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).bfloat16() for s in (sq, sk, sk))
        g = torch.randn(b, sq, h, d, device="cuda", generator=gen).bfloat16()
        scale = d ** -0.5
        o, lse = flash_attention_forward(q, k, v, scale)
        lse_ref = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale, -1)
        lse_err = (lse - lse_ref).abs().max().item()
        lse_tol = 2.0 ** -8 * max(1.0, lse_ref.abs().max().item())  # q*scale rounded to bf16
        grads = flash_attention_backward(q, k, v, o, g, lse, scale)
        torch.cuda.synchronize()
        refs = attention_backward_reference(q.float(), k.float(), v.float(), g.float(), scale)
        # dS and P are rounded to bf16 before the products (as on the TPU), q*scale
        # is rounded to bf16 before the scores: ~2^-9 relative each, summed over
        # Sq or Sk terms; 2^-6 of each gradient's largest entry bounds it
        errs = [(x.float() - r).abs().max().item() for x, r in zip(grads, refs)]
        tols = [2.0 ** -6 * r.abs().max().item() for r in refs]
        del refs
        ms = cuda_ms(lambda: flash_attention_backward(q, k, v, o, g, lse, scale))
        plain = cuda_ms(lambda: attention_backward_reference(q, k, v, g, scale))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt)
        gt = g.transpose(1, 2)
        lib = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True))
        del out
        nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
        bnd, by = bound_ms(nbytes, 10 * b * h * sq * sk * d)
        row = dict(shape=[b, sq, sk, h, d], per_step=2 * per_pass, max_abs_err=max(errs),
                   errs=errs, tols=tols, lse_err=lse_err, ms=ms, plain_ms=plain, library_ms=lib,
                   bound_ms=bnd, bound_by=by)
        log(f"K3 flash_attention_backward [B,Sq,Sk,H,D]=[{b},{sq},{sk},{h},{d}] x{2 * per_pass}/step: "
            + " ".join(f"{n}_err={e:.3e} (tol {t:.3e})" for n, e, t in zip(("dq", "dk", "dv"), errs, tols))
            + f" K1 lse_err={lse_err:.3e} (tol {lse_tol:.3e}) ms={ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} bound_ms={bnd:.5f} ({by}); {plan_line('K3', b, sq, sk, h, d)}")
        if not (all(e <= t for e, t in zip(errs, tols)) and lse_err <= lse_tol):
            raise AssertionError(f"K3 at {row['shape']}: errors {errs} over {tols} or lse {lse_err}")
        rows.append(row)
    return rows


def report_builds(q):
    """What ptxas made of K1's, K3's, K4's, K5's, K2's, K6's and K7's kernels
    (registers, shared memory, spills, and any wgmma ptxas serialized), the
    SASS they hold (HGMMA = wgmma, UTMALDG / UTMASTG = TMA tensor loads /
    stores, HMMA = mma.sync), and the host cost of encoding a tensor map.
    K5's bf16 body is K3's library (flash_attention_bwd);
    flash_attention_packed_bwd holds its fp32 body alone.  K6's and K7's
    bf16 bodies must hold TMA loads (and K7's wgmma) and spill nothing
    (the fp32 bodies may: they are the parity path)."""
    for name in ("flash_attention", "flash_attention_bwd", "flash_attention_packed",
                 "flash_attention_packed_bwd", "aspp_fused", "dw_branches", "matmul_argmax"):
        report = kernels.ptxas_report(name)
        for fn, regs, smem, st, ld in report:
            if any(x in fn for x in ("tma", "bwd_prep", "reduce", "packed", "chain", "argmax")):
                log(f"ptxas {name}: {fn}: {regs} registers, {smem} bytes static smem, "
                    f"spill stores {st} B, spill loads {ld} B")
            if any(x in fn for x in ("dw_chain", "argmax_wgmma")) and (st or ld):
                raise AssertionError(f"ptxas: {fn} of {name} spills ({st} B stored, {ld} B loaded)")
        for line in kernels.BUILD_LOGS.get(name, "").splitlines():
            if "wgmma" in line.lower():
                log(f"ptxas {name}: {line.strip()}")
        try:
            counts = kernels.sass_counts(name, ("HGMMA", "UTMALDG", "UTMASTG", "HMMA"))
            log(f"SASS of lib{name}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
            need = {"dw_branches": ("UTMALDG",), "matmul_argmax": ("HGMMA", "UTMALDG")}.get(name, ())
            if any(counts[k] == 0 for k in need):
                raise AssertionError(f"lib{name} holds no {' or '.join(need)}: {counts}")
        except (FileNotFoundError, subprocess.CalledProcessError) as e:
            log(f"SASS of lib{name}: not counted ({e})")
        if not report:
            log(f"ptxas {name}: no report (library built by an earlier process)")
    fn = kernels.load("flash_attention").madm_tensor_map_encode_ns
    fn.restype = ctypes.c_double
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
    ns, ns_hit = (fn(q.data_ptr(), q.shape[1], q.shape[2], q.shape[3], 2000, c) for c in (0, 1))
    small = [torch.randn(1, 64, 8, 40, device="cuda").bfloat16() for _ in range(3)]
    flash_attention(*small)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        flash_attention(*small)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    log(f"K1 host cost: {ns:.0f} ns to encode one tensor map, {ns_hit:.0f} ns to find it in the table "
        f"of encoded maps (3 a call); {host_us:.1f} us of host "
        f"time a flash_attention call at [1,64,64,8,40] (enqueue, no sync)")


def packed_plan_line(b, s, h, d):
    """K4's and K5's Python launch plans at a bf16 shape, held to the ones
    the C libraries compute; returns a short description."""
    out = (ctypes.c_int * 9)()
    fwd = packed_forward_plan(b, s, h, d, torch.bfloat16)
    kernels.load("flash_attention_packed").madm_packed_attention_fwd_plan(b, s, h, d, out)
    mine = [fwd.dn, fwd.bq, fwd.bk, fwd.warpgroups, int(fwd.split_d), fwd.stages, fwd.launches[0].smem]
    if mine != list(out)[:7]:
        raise AssertionError(f"K4 plan at {[b, s, h, d]}: Python {mine}, C {list(out)[:7]}")
    bwd = packed_backward_plan(b, s, h, d, torch.bfloat16)
    fn = kernels.load("flash_attention_bwd").madm_packed_attention_bwd_plan
    fn.restype = ctypes.c_longlong
    nbytes = fn(b, s, h, d, out)
    smem = {l.kernel: l.smem for l in bwd.launches}
    mine = [bwd.dn, bwd.bq, bwd.warpgroups, bwd.nsplit, bwd.bk_dq, bwd.bq_dq // 64, bwd.sqp,
            smem["dkdv_tma"], smem["dq_tma"], bwd.workspace_bytes]
    if mine != list(out) + [nbytes]:
        raise AssertionError(f"K5 plan at {[b, s, h, d]}: Python {mine}, C {list(out) + [nbytes]}")
    return ("plans K4 " + ", ".join(f"{l.kernel} grid {l.grid} x{l.threads} smem {l.smem}" for l in fwd.launches)
            + "; K5 " + ", ".join(f"{l.kernel} grid {l.grid} x{l.threads} smem {l.smem}" for l in bwd.launches)
            + f", nsplit {bwd.nsplit}")


def check_packed(gen):
    """K4 and K5 at the packed UNet self-attention, [B,4096,8,40] bf16 with
    G=3 (the routing decision; the bf16 bodies take one head a warpgroup),
    against their fp32 twins on the same inputs, with K4's lse against the
    fp32 log-sum-exp; K5 runs on K4's o and lse, and once more called alone
    (it then runs K4 first), which must give the same gradients.  SDPA
    forward and backward at the same shape as the library times.  Bounds
    count the 8 real heads' work only (K4 4*B*H*S^2*D, K5 10*B*H*S^2*D
    operations), not the TPU's padded and block-diagonal MACs nor the
    two-pass recompute."""
    rows = []
    for b, s, h, d in PACKED_SHAPES:
        g = pack_group(s, s, d, True)
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen).bfloat16() for _ in range(4))
        scale = d ** -0.5
        out, lse = packed_attention_forward(q, k, v, scale, g, with_lse=True)
        grads = packed_attention_backward(q, k, v, do, scale, g, out, lse)
        alone = packed_attention_backward(q, k, v, do, scale, g)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(grads, alone))
        ref = packed_attention_reference(q.float(), k.float(), v.float(), scale)
        err = (out.float() - ref).abs().max().item()
        tol = 2.0 ** -7 * max(1.0, ref.abs().max().item())  # bf16 output rounding
        del ref
        lse_ref = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale, -1)
        lse_err = (lse - lse_ref).abs().max().item()
        lse_tol = 2.0 ** -8 * max(1.0, lse_ref.abs().max().item())  # q*scale rounded to bf16
        del lse_ref
        refs = packed_attention_backward_reference(q.float(), k.float(), v.float(), do.float(), scale)
        # P and dS rounded to bf16 before the products, q*scale before the
        # scores (as on the TPU), delta from K4's bf16 O: ~2^-9 relative each
        # over S terms
        errs = [(x.float() - r).abs().max().item() for x, r in zip(grads, refs)]
        tols = [2.0 ** -6 * r.abs().max().item() for r in refs]
        del refs
        ms = cuda_ms(lambda: packed_attention_forward(q, k, v, scale, g))
        plain = cuda_ms(lambda: packed_attention_reference(q, k, v, scale), reps=3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        bwd_ms = cuda_ms(lambda: packed_attention_backward(q, k, v, do, scale, g, out, lse))
        bwd_plain = cuda_ms(lambda: packed_attention_backward_reference(q, k, v, do, scale),
                            reps=3, warmup=1)
        o_lib = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        bwd_lib = cuda_ms(lambda: torch.autograd.grad(o_lib, (qt, kt, vt), dot, retain_graph=True))
        del o_lib
        n = q.numel()
        bnd, by = bound_ms(2 * 4 * n, 4 * b * h * s * s * d)
        bwd_bnd, bwd_by = bound_ms(2 * 7 * n + 4 * lse.numel(), 10 * b * h * s * s * d)
        row = dict(shape=[b, s, h, d], g=g, max_abs_err=err, tol=tol, lse_err=lse_err, ms=ms,
                   plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
                   bwd=dict(max_abs_err=max(errs), errs=errs, tols=tols, alone_equal=same, ms=bwd_ms,
                            plain_ms=bwd_plain, library_ms=bwd_lib, bound_ms=bwd_bnd,
                            bound_by=bwd_by))
        log(f"K4 packed_attention [B,S,H,D]=[{b},{s},{h},{d}] G={g}: max_abs_err={err:.3e} "
            f"(tol {tol:.3e}) lse_err={lse_err:.3e} (tol {lse_tol:.3e}) ms={ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} (SDPA) bound_ms={bnd:.5f} ({by}); {packed_plan_line(b, s, h, d)}")
        log(f"K5 packed_attention_backward [B,S,H,D]=[{b},{s},{h},{d}] G={g}: "
            + " ".join(f"{nm}_err={e:.3e} (tol {t:.3e})" for nm, e, t in zip(("dq", "dk", "dv"), errs, tols))
            + f"; called alone (K4 first) {'equal' if same else 'DIFFERENT'}; ms={bwd_ms:.4f} "
            f"plain_ms={bwd_plain:.4f} library_ms={bwd_lib:.4f} (SDPA backward) "
            f"bound_ms={bwd_bnd:.5f} ({bwd_by})")
        if not (err <= tol and lse_err <= lse_tol and all(e <= t for e, t in zip(errs, tols)) and same):
            raise AssertionError(f"K4/K5 at {row['shape']}: forward error {err} over {tol}, lse {lse_err} "
                                 f"over {lse_tol}, gradient errors {errs} over {tols}, or the gradients "
                                 f"of a lone backward call differ ({same})")
        rows.append(row)
    return rows


def aspp_inputs(gen, b, h, w, ec=256, n=4):
    def f(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    c = ec * n
    embeds = [f(b, h, w, ec).bfloat16() for _ in range(n)]
    args = (f(3, 3, 3, c, scale=0.1), f(3, c).abs() + 0.5, f(3, c, scale=0.1),
            f(3, c, 256, scale=0.03).bfloat16(), f(3, 256).abs() + 0.5, f(3, 256),
            f(c, 256, scale=0.03).bfloat16(), f(256).abs() + 0.5, f(256))
    return embeds, args


def aspp_plan_line(b, h, w):
    """K2's Python launch plan at a bf16 shape, held to the one the C library
    computes; returns a short description."""
    plan = aspp_plan(b, h, w, 256, 4, (6, 12, 18), torch.bfloat16)
    theirs = c_plan(b, h, w, 256, 4, (6, 12, 18), torch.bfloat16)
    if plan.c_plan() != theirs:
        raise AssertionError(f"K2 plan at {[b, h, w]}: Python {plan.c_plan()}, C {theirs}")
    return (f"plan grid {plan.grid} x{plan.threads} smem {plan.smem}, tile {plan.tile_cols}x"
            f"{plan.tile_rows} px, {plan.stages} stages of {plan.chunk} channels, strips {plan.strips} "
            f"in groups of {plan.group}, row pairs {list(plan.row_pairs)}")


def check_aspp(gen):
    """K2 against its fp32 twin at the eval crop (B=1, 2) and the slide head's
    W=1024, with its plan held to the C library's; beside it, as a yardstick
    for the product part only (no single call computes K2), the four bf16
    [B*H*W, 1024] x [1024, 256] products alone in torch.matmul."""
    rows = []
    for b, h, w in ASPP_SHAPES:
        embeds, args = aspp_inputs(gen, b, h, w)
        out = aspp_fused(embeds, *args)
        torch.cuda.synchronize()
        ref = aspp_fused_reference(embeds, *args)
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2.0 ** -6 * max(1.0, ref.float().abs().max().item())  # bf16 rounding of outputs and depthwise
        del ref
        ms = cuda_ms(lambda: aspp_fused(embeds, *args), reps=5)
        plain = cuda_ms(lambda: aspp_fused_reference(embeds, *args), reps=3, warmup=1)
        pix = b * h * w
        xcat = torch.cat(embeds, dim=-1).view(pix, 1024)
        wts = [args[3][i] for i in range(3)] + [args[6]]
        products = cuda_ms(lambda: [torch.matmul(xcat, wt) for wt in wts], reps=5)
        del xcat
        nbytes = 2 * (4 * pix * 256 + pix * 1024 + 4 * 1024 * 256) + 4 * (3 * 9 * 1024 + 6 * 1024 + 8 * 256)
        bnd, by = bound_ms(nbytes, (3 * 9 * 2 + 4 * 2 * 256) * pix * 1024)
        row = dict(shape=[b, h, w, 4 * 256], max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                   bound_ms=bnd, bound_by=by, products_alone_ms=products)
        log(f"K2 aspp_fused [B,H,W,C]=[{b},{h},{w},1024]: max_abs_err={err:.3e} (tol {tol:.3e}) "
            f"ms={ms:.4f} plain_ms={plain:.3f} bound_ms={bnd:.4f} ({by}); yardstick, not the "
            f"library call: the 4 products alone in torch.matmul {products:.4f} ms; "
            f"{aspp_plan_line(b, h, w)}")
        if not err <= tol:
            raise AssertionError(f"K2 at {row['shape']}: error {err} over tolerance {tol}")
        rows.append(row)
    for b, h, w, ec, n, dils in ASPP_RAGGED:
        embeds, args = aspp_inputs(gen, b, h, w, ec, n)
        out = aspp_fused(embeds, *args, dils)
        torch.cuda.synchronize()
        ref = aspp_fused_reference(embeds, *args, dils).float()
        err = (out.float() - ref).abs().max().item()
        tol = 2.0 ** -6 * max(1.0, ref.abs().max().item())
        log(f"K2 aspp_fused ragged [B,H,W]=[{b},{h},{w}], {n} x {ec} channels, dilations {dils}: "
            f"max_abs_err={err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"K2 at ragged {[b, h, w, ec, n, dils]}: error {err} over tolerance {tol}")
    return rows


def dw_plan_line(b, h, w, ec, n, dils):
    """K6's Python launch plan at a bf16 shape, held to the one the C library
    computes; returns a short description."""
    plan = dw_plan(b, h, w, n * ec, dils, torch.bfloat16, n)
    theirs = dw_c_plan(b, h, w, ec, n, dils, torch.bfloat16)
    if plan.c_plan() != theirs:
        raise AssertionError(f"K6 plan at {[b, h, w, ec, n, dils]}: Python {plan.c_plan()}, C {theirs}")
    return (f"plan grid {plan.grid[0]} x{plan.threads} smem {plan.smem}, {plan.strips} strips of "
            f"{plan.tpx} x {plan.slices} slices, segments {list(plan.nseg)} of {list(plan.seg_rows)} rows, "
            f"{plan.loads_per_input():.3f} loads an input element")


def dw_params(gen, c, n_dil):
    """K6's taps, BN scale and bias for n_dil dilations over c channels."""
    taps = torch.randn(n_dil, 3, 3, c, device="cuda", generator=gen) / 3
    scale = torch.rand(n_dil, c, device="cuda", generator=gen) + 0.5
    bias = torch.randn(n_dil, c, device="cuda", generator=gen) * 0.1
    return taps, scale, bias


def dw_error(outs, embeds, taps, scale, bias, dils):
    """Largest error of K6's outputs against the fp32 twin's, and its
    tolerance: output rounding after a 9-term fp32 sum."""
    refs = dw_branches_reference([e.float() for e in embeds], taps, scale, bias, dils)
    err = max((o.float() - r).abs().max().item() for o, r in zip(outs, refs))
    tol = 2.0 ** -7 * max(1.0, max(r.abs().max().item() for r in refs))
    return err, tol


def check_dw(gen):
    """K6 at the 'full' head's shape, one call a dilation over the
    1024-channel concat, at B=1 and B=2 512x512 and the slide head's
    512x1024, against the fp32 twin on the same bf16 input, with its plan
    held to the C library's; cuDNN's grouped conv in bf16 (the train head's
    call) on the same tensor as the library time.  Then ragged calls
    (DW_RAGGED), several dilations in one call among them."""
    rows = []
    for b, h, w in DW_SHAPES:
        c = 1024
        x = torch.randn(b, h, w, c, device="cuda", generator=gen).bfloat16()
        for d in DW_DILATIONS:
            taps, scale, bias = dw_params(gen, c, 1)
            out = dw_branches([x], taps, scale, bias, (d,))
            torch.cuda.synchronize()
            err, tol = dw_error(out, [x], taps, scale, bias, (d,))
            del out
            ms = cuda_ms(lambda: dw_branches([x], taps, scale, bias, (d,)), reps=20)
            plain = cuda_ms(lambda: dw_branches_reference([x], taps, scale, bias, (d,)), reps=3, warmup=1)
            xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor (channels_last)
            k = taps[0].permute(2, 0, 1).unsqueeze(1).bfloat16().contiguous()
            lib = cuda_ms(lambda: F.conv2d(xc, k, padding=d, dilation=d, groups=c), reps=5)
            nbytes = 2 * 2 * b * h * w * c + 4 * 11 * c
            bnd, by = bound_ms(nbytes, 18 * b * h * w * c, FP32_FLOP_PER_S)
            rows.append(dict(shape=[b, h, w, c], dilation=d, max_abs_err=err, tol=tol, ms=ms,
                             plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by))
            log(f"K6 dw_branches [B,H,W,C]=[{b},{h},{w},{c}] d={d}: max_abs_err={err:.3e} (tol {tol:.3e}) "
                f"ms={ms:.4f} plain_ms={plain:.3f} library_ms={lib:.3f} (cuDNN bf16 grouped conv) "
                f"bound_ms={bnd:.4f} ({by}, {bnd / ms:.1%} of it); {dw_plan_line(b, h, w, c, 1, (d,))}")
            if not err <= tol:
                raise AssertionError(f"K6 at {[b, h, w, c]} d={d}: error {err} over tolerance {tol}")
        del x
    for b, h, w, ec, n, dils in DW_RAGGED:
        embeds = [torch.randn(b, h, w, ec, device="cuda", generator=gen).bfloat16() for _ in range(n)]
        taps, scale, bias = dw_params(gen, n * ec, len(dils))
        out = dw_branches(embeds, taps, scale, bias, dils)
        torch.cuda.synchronize()
        err, tol = dw_error(out, embeds, taps, scale, bias, dils)
        log(f"K6 dw_branches ragged [B,H,W]=[{b},{h},{w}], {n} x {ec} channels, dilations {dils}: "
            f"max_abs_err={err:.3e} (tol {tol:.3e}); {dw_plan_line(b, h, w, ec, n, dils)}")
        if not err <= tol:
            raise AssertionError(f"K6 at ragged {[b, h, w, ec, n, dils]}: error {err} over tolerance {tol}")
    return rows


def argmax_plan_line(pixels, c, nc):
    """K7's Python launch plan at a bf16 shape, held to the one the C library
    computes; returns a short description."""
    plan = argmax_plan(pixels, c, nc, torch.bfloat16)
    theirs = argmax_c_plan(pixels, c, nc, torch.bfloat16)
    if plan.c_plan() != theirs:
        raise AssertionError(f"K7 plan at {[pixels, c, nc]}: Python {plan.c_plan()}, C {theirs}")
    return (f"plan grid {plan.grid} x{plan.threads} smem {plan.smem}, {plan.stages} stages, "
            f"{plan.tiles} tiles, {plan.ncp} padded classes")


def check_argmax(gen):
    """K7 at the eval head's shape, conv_seg (256 -> 11) + argmax of a B=1
    512x512 crop, then at B=2, the slide head's 512x1024, 19 classes and a
    ragged pixel count, against the fp32 twin on the same inputs, with its
    plan held to the C library's.  Its error is the largest gap between the
    twin's logits at the twin's and at the kernel's class (0 where the ids
    agree).  Returns the rows; the first is the kernels line's."""
    rows = []
    for b, h, w, c, nc in ARGMAX_SHAPES:
        x = torch.randn(b, h, w, c, device="cuda", generator=gen).bfloat16()
        wt = torch.randn(c, nc, device="cuda", generator=gen) / 16
        bias = torch.randn(nc, device="cuda", generator=gen) * 0.1
        ids = matmul_argmax(x, wt, bias)
        torch.cuda.synchronize()
        ref = matmul_argmax_reference(x, wt, bias)
        logits = x.float() @ wt + bias
        top2 = logits.topk(2, dim=-1).values
        tol = 1e-3 * max(1.0, logits.abs().max().item())
        sure = (top2[..., 0] - top2[..., 1]) > tol
        equal = ids == ref
        wrong_sure = int((sure & ~equal).sum())  # counted exactly: a float mean of 1s may round below 1
        agree = int(equal.sum()) / equal.numel()
        err = (logits.gather(-1, ref.long()[..., None])
               - logits.gather(-1, ids.long()[..., None])).abs().max().item()
        del logits, top2, ref
        ms = cuda_ms(lambda: matmul_argmax(x, wt, bias), reps=50)
        plain = cuda_ms(lambda: matmul_argmax_reference(x, wt, bias), reps=10)
        bnd, by = bound_ms(2 * x.numel() + 4 * (c * nc + nc) + 4 * b * h * w, 2 * c * nc * b * h * w,
                           FP32_FLOP_PER_S)
        log(f"K7 matmul_argmax [B,H,W,C]=[{b},{h},{w},{c}]->{nc}: ids equal the twin's on {agree:.6f} of "
            f"pixels and differ on {wrong_sure} of the {int(sure.sum())} with a top-2 margin > {tol:.2e}; "
            f"max logit gap {err:.3e}; ms={ms:.4f} plain_ms={plain:.4f} library_ms=null (no single "
            f"call) bound_ms={bnd:.4f} ({by}, {bnd / ms:.1%} of it); {argmax_plan_line(b * h * w, c, nc)}")
        if not (wrong_sure == 0 and agree >= 0.999):
            raise AssertionError(f"K7 at {[b, h, w, c, nc]}: ids disagree with the twin on {wrong_sure} sure "
                                 f"pixels, agree on {agree} of all")
        rows.append(dict(shape=[b, h, w, c, nc], max_abs_err=err, agree=agree, ms=ms, plain_ms=plain,
                         bound_ms=bnd, bound_by=by, library_ms=None))
    return rows


TOY = MADMConfig(num_classes=11, crop_size=(64, 64), unet_channels=(32, 64, 128, 128),
                 vae_channels=(32, 32, 64, 64), feature_dims=(3, 32, 64, 128),
                 projection_dim=(32, 32, 32, 32), compute_dtype=torch.float32)


def check_toy():
    """The toy fp32 model on CUDA (kernels) against CPU (twins): logits, and
    ids in each kernel eval head, each pass with its launch counts."""
    cpu = init_random_(MADM(TOY, device="cpu"), torch.Generator().manual_seed(SEED))
    gpu = MADM(TOY, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    images = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(SEED + 1))
    reset_counts()
    lg_gpu = gpu.eval_forward(images).cpu()
    if launch_counts() != {"K1": 34}:
        raise AssertionError(f"toy logits pass on CUDA launched {launch_counts()}; expected K1 x34")
    lg_cpu = cpu.eval_forward(images)
    err = (lg_gpu - lg_cpu).abs().max().item()
    tol = 1e-3 * max(1.0, lg_cpu.abs().max().item())  # fp32, other summation orders
    top2 = lg_cpu.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * tol
    log(f"toy fp32 CUDA vs CPU: logits max_abs_err={err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError("toy-width CUDA logits disagree with the CPU twins")
    for mode, expected in EVAL_LAUNCHES.items():
        reset_counts()
        ids_gpu = gpu.eval_forward_ids(images, eval_head=mode).cpu()
        counts = launch_counts()
        ids_cpu = cpu.eval_forward_ids(images, eval_head=mode)
        agree = (ids_gpu == ids_cpu)[sure].double().mean().item()
        log(f"toy fp32 CUDA vs CPU, '{mode}' head: ids equal on {agree:.6f} of {int(sure.sum())} "
            f"pixels with top-2 margin > {2 * tol:.1e}; all pixels "
            f"{(ids_gpu == ids_cpu).double().mean().item():.6f}; launches {counts}")
        if agree != 1.0:
            raise AssertionError(f"toy-width CUDA '{mode}' head disagrees with the CPU twins")
        if counts != expected:
            raise AssertionError(f"toy '{mode}' pass launched {counts}; expected {expected}")
    # the sliding window over a 64x128 image (three windows, as at 512x1024)
    wide = torch.rand(1, 64, 128, 3, generator=torch.Generator().manual_seed(SEED + 9))
    lg = cpu._eval_head()(cpu.slide_backbone_forward(wide)["output_features"]).permute(0, 2, 3, 1)
    top2 = lg.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2e-3 * max(1.0, lg.abs().max().item())
    ids_cpu = make_slide_eval_fn(cpu)(wide)
    for form in ("window", "batch"):
        f_gpu = gpu.slide_backbone_forward(wide, form=form)["output_features"]
        f_cpu = cpu.slide_backbone_forward(wide, form=form)["output_features"]
        err = max((f_gpu[k].cpu() - v).abs().max().item() / max(1.0, v.abs().max().item())
                  for k, v in f_cpu.items())
        ids_gpu = make_slide_eval_fn(gpu, form=form)(wide).cpu()
        agree = (ids_gpu == ids_cpu)[sure].double().mean().item()
        log(f"toy fp32 slide eval CUDA vs CPU, form={form}: stitched features max err {err:.3e} of "
            f"max(1, max|feature|) (tol 1e-3); ids equal on {agree:.6f} of {int(sure.sum())} pixels "
            f"with a settled argmax")
        if not (err <= 1e-3 and agree == 1.0):
            raise AssertionError(f"toy slide eval form={form}: CUDA disagrees with the CPU twins")


def check_toy_train(cfg=TOY, expected=TRAIN_LAUNCHES, batch=2):
    """Two shipped-config steps of the toy model, CUDA (kernels) against CPU
    (twins), fp32 with TF32 off, on the same weights, batches and draws.
    With ``cfg.flash_pack`` at a 256x256 crop, the S=1024 self-attentions
    (D=4, G=4) take K4/K5's fp32 bodies."""
    tc = TrainConfig()
    cpu = init_random_(MADM(cfg, device="cpu", trainable=True), torch.Generator().manual_seed(SEED))
    gpu = MADM(cfg, device="cuda", trainable=True)
    gpu.load_state_dict(cpu.state_dict())
    s_cpu, s_gpu = make_train_state(cpu, tc), make_train_state(gpu, tc)
    gen = torch.Generator().manual_seed(SEED + 3)
    batches = synthetic_batches(batch, cfg.crop_size, cfg.num_classes, gen)
    named_cpu, named_gpu = dict(cpu.named_parameters()), dict(gpu.named_parameters())
    trained = [n for n, p in named_cpu.items() if p.requires_grad]
    allowed = {n: torch.zeros_like(named_cpu[n]) for n in trained}
    b1, b2 = 0.9, 0.999
    for t in range(2):
        batch = next(batches)
        draws = sample_draws(gen, tc, batch["source_label"], cfg.num_classes, cpu.sem_seg_head)
        m_cpu = train_step(s_cpu, batch, draws=draws)
        reset_counts()
        m_gpu = train_step(s_gpu, batch, draws=draws)
        launches = launch_counts()
        # losses and grad_norm: fp32, other summation orders (the CPU port
        # matches the JAX step to 1e-6 relative)
        worst = max(abs(m_gpu[k] - v) / max(abs(v), 1e-3) for k, v in m_cpu.items())
        # gradients via Adam's first moment: a ReLU whose input sits within
        # fp32 noise of 0 flips on one side only, moving a channel's gradient
        # by ~1/(pixels); 2e-3 of the largest entry bounds it (measured 4.2e-4
        # CPU port against JAX)
        mom = {n: (s_gpu.optimizer.state[named_gpu[n]]["exp_avg"].cpu(),
                   s_cpu.optimizer.state[named_cpu[n]]["exp_avg"]) for n in trained}
        mmax = max(c.abs().max().item() for _, c in mom.values())
        grad_err = max((g - c).abs().max().item() for g, c in mom.values()) / mmax
        # parameters: each step moves a weight by lr_t * (u + wd * w), u = Adam's
        # m^/(sqrt(v^) + eps) from each side's own moments; the sides may part by
        # 1% of lr_t plus lr_t * |u_gpu - u_cpu| per step, plus the fp32 rounding
        # of the decay and of the step on each side (2 ulp of |w|: at the shipped
        # lr, 3.35e-7 at step 0, an update is about one ulp of a weight near 1)
        lr = s_cpu.schedule(t)
        excess = -math.inf
        for n in trained:
            def u(state):
                st = state.optimizer.state[(named_gpu if state is s_gpu else named_cpu)[n]]
                return adam_direction(st, b1, b2, 1e-8).float().cpu()
            ulp2 = 2 * torch.finfo(torch.float32).eps * named_cpu[n].detach().abs()
            allowed[n] += 1e-2 * lr + lr * (u(s_gpu) - u(s_cpu)).abs() + ulp2
            diff = (named_gpu[n].detach().cpu() - named_cpu[n].detach()).abs()
            excess = max(excess, (diff - allowed[n]).max().item())
        log(f"toy train step {t} (crop {cfg.crop_size}, flash_pack={cfg.flash_pack}): CUDA vs CPU "
            f"losses/grad_norm max rel err {worst:.3e} (tol 1e-4); "
            f"gradients (Adam first moment) max err {grad_err:.3e} of the largest (tol 2e-3); "
            f"parameters within the AdamW bound (max excess {excess:.3e}); "
            f"CUDA launches {launches}; " + " ".join(f"{k}={v:.5f}" for k, v in m_gpu.items()))
        if not (worst <= 1e-4 and grad_err <= 2e-3 and excess <= 0.0):
            raise AssertionError(f"toy train step {t}: CUDA disagrees with the CPU twins")
        if launches != expected:
            raise AssertionError(f"toy train step {t} launched {launches}; expected {expected}")


def adam_direction(st, b1, b2, eps):
    """AdamW's u = m^ / (sqrt(v^) + eps) from its state ``st`` after
    ``st['step']`` updates, in float64, with the bias corrections 1 - b^t
    formed in fp32 as optax (and the port) form them: 1 - fp32(0.999) is
    1.3e-5 off 1e-3."""
    t = np.float32(st["step"])
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    return (st["exp_avg"].double() / bc1) / ((st["exp_avg_sq"].double() / bc2).sqrt() + eps)


def unmoved(state, before):
    """Trained tensors that the last step should have moved and did not, or
    that the optimizer does not hold.  AdamW decays w by lr*wd*w and
    subtracts lr*u, u = ``adam_direction``: an element must change where
    lr*|u| exceeds lr*wd*|w| plus 2^-22 |w| (an fp32 ulp for each of the two
    roundings).  Elements with |u| far below 1 (a clipped gradient under
    Adam's eps) may rightly stay put at the shipped lr."""
    opt = state.optimizer
    group_of = {id(p): g for g in opt.param_groups for p in g["params"]}
    faults = []
    for n, p in trainable_parameters(state.model):
        g, st = group_of.get(id(p)), opt.state.get(p)
        if g is None or not st:
            faults.append(f"{n}: not stepped by the optimizer")
            continue
        w = before[n]
        u = adam_direction(st, *g["betas"], g["eps"]).float()
        must = (g["lr"] * u.abs() > (g["lr"] * g["weight_decay"] + 2.0 ** -22) * w.abs()).any()
        if bool(must) and torch.equal(p.detach(), w):
            faults.append(f"{n}: not updated")
    return faults


F32_UNIT = 2.0 ** -24  # fp32's unit roundoff
F32_TINY = 2.0 ** -126  # fp32's smallest normal: below it, subnormal spacing rounds absolutely


def _moment_dtype(group):
    """The dtype a rule stores its first moment in: AdamW the parameter's
    (fp32) unless mu_dtype='bfloat16'; Adafactor bf16 unless 'float32'."""
    if "betas" in group:
        return torch.bfloat16 if group["mu_dtype"] == "bfloat16" else torch.float32
    return torch.float32 if group["mu_dtype"] == "float32" else torch.bfloat16


def _decayed(m, b1):
    """b1 * m of a stored moment, in float64: on a bf16 moment the product is
    rounded to bf16 (b1 too), as JAX's weak types make optax form it."""
    if m.dtype == torch.bfloat16:
        b1 = float(torch.tensor(b1, dtype=torch.bfloat16))
        return (m.double() * b1).to(torch.bfloat16).double()
    return b1 * m.double()


def rule_step(group, st, g, w):
    """One update of the weight ``w`` by the rule of ``group`` (a parameter
    group of the port's AdamW or Adafactor as its state dict holds it),
    written out from optax 0.2.6's formulas in float64, from the state
    ``st`` before the step and the clipped gradient ``g``; the scalar decays
    in fp32, as optax forms them.  Returns (state after, weight after,
    slack of each state tensor, slack of the weight): the slack bounds how
    far the port's fp32 arithmetic may round from this, 32 unit roundoffs of
    the magnitudes that enter (plus twice the lengths of Adafactor's
    means), one bf16 ulp where a moment is stored in bf16, one fp32 ulp of
    the weight, and fp32's smallest normal (squares of tiny gradients fall
    among the subnormals)."""
    g, w = g.double(), w.double()
    t = st.get("step", 0) + 1
    rel = 32 * F32_UNIT
    new, slack = {"step": t}, {}
    zero = torch.zeros_like(g)
    if "betas" in group:  # AdamW: u = m^/(sqrt(v^) + eps); w -= lr (u + wd w)
        b1, b2 = group["betas"]
        bm = _decayed(st["exp_avg"], b1) if st else zero
        new["exp_avg"] = bm + (1 - b1) * g
        new["exp_avg_sq"] = (b2 * st["exp_avg_sq"].double() if st else zero) + (1 - b2) * g * g
        size = bm.abs() + (1 - b1) * g.abs()
        slack["exp_avg"], slack["exp_avg_sq"] = rel * size, rel * new["exp_avg_sq"]
        u = adam_direction(new, b1, b2, group["eps"])
        mag = adam_direction(dict(new, exp_avg=size), b1, b2, group["eps"])
        step = group["lr"] * (u + group["weight_decay"] * w)
        mag = group["lr"] * (mag + group["weight_decay"] * w.abs())
    else:  # Adafactor: m = (1 - b1) lr u + b1 m; w -= m + wd w
        d = np.float32(1) - np.float32(t) ** np.float32(-0.8)
        keep, fresh = float(d), float(np.float32(1) - d)
        g2 = g * g + 1e-30
        shape = tuple(g.shape)
        order = np.argsort(shape)
        if len(shape) >= 2 and shape[order[-2]] >= 128:  # factored over the two largest axes
            d1, d0 = int(order[-2]), int(order[-1])
            rel += 2 * (shape[d0] + shape[d1]) * F32_UNIT
            r = (keep * st["v_row"].double() if st else 0.0) + fresh * g2.mean(d0)
            c = (keep * st["v_col"].double() if st else 0.0) + fresh * g2.mean(d1)
            row = (r / r.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)).rsqrt()
            u = g * row.unsqueeze(d0) * c.rsqrt().unsqueeze(d1)
            new["v_row"], new["v_col"] = r, c
            slack["v_row"], slack["v_col"] = rel * r, rel * c
        else:
            new["v"] = (keep * st["v"].double() if st else zero) + fresh * g2
            slack["v"] = rel * new["v"]
            u = g * new["v"].rsqrt()
        u = group["lr"] * u
        m, mag = u, u.abs()
        if group["b1"] is not None:
            bm = _decayed(st["exp_avg"], group["b1"]) if st else zero
            m = (1 - group["b1"]) * u + bm
            mag = (1 - group["b1"]) * mag + bm.abs()
            new["exp_avg"], slack["exp_avg"] = m, rel * mag
        step = m + group["weight_decay"] * w
        mag = mag + group["weight_decay"] * w.abs()
    if "exp_avg" in new and _moment_dtype(group) == torch.bfloat16:
        slack["exp_avg"] = slack["exp_avg"] + 2.0 ** -8 * new["exp_avg"].abs()
    w_new = w - group["lr_scale"] * step
    slack = {k: v + F32_TINY for k, v in slack.items()}
    w_slack = rel * group["lr_scale"] * mag + 2 * F32_UNIT * torch.maximum(w.abs(), w_new.abs()) + F32_TINY
    return new, w_new, slack, w_slack


def snapshot(state, device=None):
    """What ``off_rule`` reckons a step from, in the optimizer's order: the
    trained parameters' names, weights and gradients (zeros where none),
    the whole optimizer state (consolidated on rank 0 under ZeRO-1, None on
    the other ranks; every rank must call this) and the head's BN
    statistics; copies on ``device``, or the live tensors."""
    opt = dist_lib.consolidated_state_dict(state.optimizer)

    def keep(t):
        return t.detach() if device is None else t.detach().to(device, copy=True)

    names = {id(p): n for n, p in trainable_parameters(state.model)}
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    if opt is not None:
        opt = {"param_groups": copy.deepcopy(opt["param_groups"]),
               "state": {i: {k: keep(v) if torch.is_tensor(v) else v for k, v in st.items()}
                         for i, st in opt["state"].items()}}
    return {"names": [names[id(p)] for p in params], "params": [keep(p) for p in params],
            "grads": [keep(p.grad) if p.grad is not None else torch.zeros_like(keep(p)) for p in params],
            "opt": opt, "bn": {n: keep(b) for n, b in state.model.named_buffers()
                               if n.endswith(("running_mean", "running_var"))}}


def off_rule(start, end):
    """How far each trained tensor's weight and optimizer state in the
    snapshot ``end`` lie from ``rule_step`` applied to the snapshot
    ``start`` with ``end``'s gradients, in units of their slack: (the
    largest such ratio, faults).  A ratio <= 1 and no fault pass; a fault
    names a tensor beyond its slack or not finite, or whose state keys,
    step or moment dtype differ from the rule's.  The groups' lr is
    ``end``'s (the step's)."""
    worst, faults = 0.0, []
    for group in end["opt"]["param_groups"]:
        for i in group["params"]:
            name, w1, st1 = end["names"][i], end["params"][i], end["opt"]["state"].get(i, {})
            dev = w1.device
            st0 = {k: v.to(dev) if torch.is_tensor(v) else v
                   for k, v in start["opt"]["state"].get(i, {}).items()}
            new, w_exp, slack, w_slack = rule_step(group, st0, end["grads"][i].to(dev),
                                                   start["params"][i].to(dev))
            if set(st1) != set(new) or st1["step"] != new["step"] or (
                    "exp_avg" in st1 and st1["exp_avg"].dtype != _moment_dtype(group)):
                faults.append(f"{name}: state {sorted(st1)} at step {st1.get('step')}, the rule's "
                              f"{sorted(new)} at step {new['step']}")
                continue
            r = ((w1.double() - w_exp).abs() / w_slack).max().item()
            for k, v in slack.items():
                r = max(r, ((st1[k].to(dev).double() - new[k]).abs() / v).max().item())
            if not torch.isfinite(w1).all():
                faults.append(f"{name}: not finite")
            elif not r <= 1.0:
                faults.append(f"{name}: {r:.3e} of the rule's slack")
            worst = max(worst, r)
    return worst, faults


def grad_groups(model):
    """Trained tensors' gradients concatenated per top-level module (unet,
    prompt, feature_projections, sem_seg_head)."""
    out = {}
    for n, p in trainable_parameters(model):
        out.setdefault(n.split(".")[0], []).append(p.grad.flatten())
    return {k: torch.cat(v) for k, v in out.items()}


def check_toy_bf16(crop=TOY.crop_size, flash_pack=False, expected=TRAIN_LAUNCHES):
    """The mixed-precision path (fp32 masters cast to bf16 at each use by
    ``functional_call``): one shipped-config step in bf16 compute against the
    same step in fp32 compute, both on CUDA, from the same masters, batch and
    draws.  The toy's UNet widths 64-256 give heads of D = 8/16/32, which K3's
    bf16 body takes.  The mix mask is all source, so that no pseudo-label of
    the random teacher (near-ties everywhere) enters the losses.

    The gradient of a random-init model is ill-conditioned (train-mode BN,
    the L1 palette loss's signs): to state what bf16 rounding may do to it,
    a third step runs in fp32 with every trained weight perturbed by a
    relative N(0, 2^-9), bf16's rounding, and its distance from fp32 is the
    floor.  bf16 also rounds every activation, so each module's gradient may
    be 4x that floor (at least 2^-4) from fp32's in l2.  With
    ``flash_pack`` at a 256x256 crop, the S=1024 self-attentions (D=8, G=4)
    take K4/K5's bf16 bodies in the bf16 step."""
    tc = TrainConfig()
    cfg32 = dataclasses.replace(TOY, unet_channels=(64, 128, 256, 256), feature_dims=(3, 64, 128, 256),
                                crop_size=crop, flash_pack=flash_pack)
    m32 = init_random_(MADM(cfg32, device="cuda", trainable=True),
                       torch.Generator(device="cuda").manual_seed(SEED))
    m16 = MADM(dataclasses.replace(cfg32, compute_dtype=torch.bfloat16), device="cuda", trainable=True)
    mp = MADM(cfg32, device="cuda", trainable=True)
    for m in (m16, mp):
        m.load_state_dict(m32.state_dict())
    noise = torch.Generator(device="cuda").manual_seed(SEED + 6)
    with torch.no_grad():
        for _, p in trainable_parameters(mp):
            p.mul_(1 + 2.0 ** -9 * torch.randn(p.shape, device="cuda", generator=noise))
    s32, s16, sp = (make_train_state(m, tc) for m in (m32, m16, mp))
    gen = torch.Generator().manual_seed(SEED + 5)
    batch = next(synthetic_batches(2, cfg32.crop_size, cfg32.num_classes, gen))
    draws = sample_draws(gen, tc, batch["source_label"], cfg32.num_classes, m32.sem_seg_head)
    draws["mix_mask"] = torch.ones_like(draws["mix_mask"])
    before = {n: p.detach().clone() for n, p in trainable_parameters(m16)}
    ref = train_step(s32, batch, draws=draws)
    pert = train_step(sp, batch, draws=draws)
    reset_counts()
    out = train_step(s16, batch, draws=draws)
    launches = launch_counts()
    # losses and grad_norm: means over many pixels; bf16 keeps 8 significant
    # bits (2^-9 relative rounding): a few 2^-8 expected, 2^-5 allowed
    loss_err = max(abs(out[k] - v) / max(abs(v), 1e-3) for k, v in ref.items())
    # each trained tensor: a finite gradient, all zero only where fp32's is
    # (tanh(alpha_cond_time) = 0 at step 0 zeroes time_embed's), and moved
    # where its AdamW step exceeds fp32 rounding
    grads32 = dict(trainable_parameters(m32))
    faults = [f"{n}: gradient missing, non-finite or zero against fp32's"
              for n, p in trainable_parameters(m16)
              if p.grad is None or not torch.isfinite(p.grad).all()
              or bool(p.grad.any()) != bool(grads32[n].grad.any())]
    faults += unmoved(s16, before)
    g32, g16, gp = grad_groups(m32), grad_groups(m16), grad_groups(mp)
    rows = {k: (((g16[k] - r).norm() / r.norm()).item(), ((gp[k] - r).norm() / r.norm()).item(),
                (g16[k].norm() / r.norm()).item()) for k, r in g32.items()}
    bad = [k for k, (e, floor, _) in rows.items() if not e <= max(4 * floor, 2.0 ** -4)]
    log("toy bf16 / fp32 / fp32 with weight noise metrics: " + " ".join(
        f"{k}={out[k]:.6f}/{v:.6f}/{pert[k]:.6f}" for k, v in ref.items()))
    log(f"toy bf16 vs fp32 train step (CUDA, D 8/16/32, crop {crop}, flash_pack={flash_pack}): "
        f"losses/grad_norm max rel err "
        f"{loss_err:.3e} (tol {2.0 ** -5:.3e}); gradient l2 rel err by module, bf16 (fp32 with "
        f"2^-9 weight noise) [bf16/fp32 norm]: "
        + ", ".join(f"{k} {e:.3e} ({f:.3e}) [{r:.4f}]" for k, (e, f, r) in rows.items())
        + f"; {len(before) - len(faults)} of {len(before)} trained tensors with a finite gradient "
        f"and their update; launches {launches}; "
        + " ".join(f"{k}={v:.5f}" for k, v in out.items()))
    if faults or bad or not loss_err <= 2.0 ** -5:
        raise AssertionError(f"bf16 toy train step disagrees with fp32: modules {bad}, "
                             f"loss err {loss_err}, tensors {faults[:10]}")
    if launches != expected:
        raise AssertionError(f"bf16 toy train step launched {launches}; expected {expected}")


def check_full_grads(state, batches, gen):
    """One more full-width step: every trained tensor gets a finite gradient
    that is not all zero (a cast that cut the graph would leave one missing
    or zero), and moves where its AdamW step exceeds fp32 rounding."""
    named = trainable_parameters(state.model)
    # the prompt blends tanh(alpha_uncond_prompt) * uncond_inputs: no gradient
    # reaches alpha_uncond_prompt while that empty-prompt embedding is zeros,
    # as it is without an SD snapshot (in the JAX package too)
    exempt = () if state.model.uncond_inputs.any() else ("alpha_uncond_prompt",)
    before = {n: p.detach().clone() for n, p in named}
    m = train(state, batches, steps=1, generator=gen)[0]
    faults = [f"{n}: gradient missing, non-finite or zero" for n, p in named
              if p.grad is None or not torch.isfinite(p.grad).all()
              or not (p.grad.any() or n.endswith(exempt))]
    faults += unmoved(state, before)
    moved = sum(not torch.equal(p.detach(), before[n]) for n, p in named)
    log(f"full-width gradient check, step {state.step}: {len(named) - len(faults)} of {len(named)} "
        f"trained tensors pass (finite gradient, nonzero but {exempt}; {moved} moved); "
        f"grad_norm={m['grad_norm']:.5f}")
    if faults:
        raise AssertionError(f"full-width step: {faults[:10]}")


def run_full_train(card, flash_pack=False):
    """The shipped UDA step at full width through the trainer entry point,
    one warm-up and two timed steps at B=1 and at B=2; returns the launches
    of the last B=1 step."""
    t0 = time.perf_counter()
    cfg, tc = MADMConfig(flash_pack=flash_pack), TrainConfig()
    expected = PACKED_TRAIN_LAUNCHES if flash_pack else TRAIN_LAUNCHES
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    state = init_train_state(cfg, tc, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in state.params)
    log(f"full-width train state: MADMConfig(flash_pack={flash_pack}) trainable, seeded random weights, {n_train} "
        f"trained parameters (fp32 masters, AdamW), built in {time.perf_counter() - t0:.1f} s")
    counts = {}
    for b in (1, 2):
        batches = synthetic_batches(b, cfg.crop_size, cfg.num_classes, gen)
        train(state, batches, steps=1, generator=gen)  # warm-up
        torch.cuda.synchronize()
        rows, peaks = [], []
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            m = train(state, batches, steps=1, generator=gen)[0]
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            launches = launch_counts()
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            log(f"full-width train flash_pack={flash_pack} B={b} step {state.step}: {ms:.1f} ms, peak "
                f"memory {peaks[-1]:.2f} GiB; launches {launches}; " + " ".join(
                    f"{k}={v:.5f}" for k, v in m.items() if k != "step_ms") + f" [{card}]")
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"non-finite train metrics at B={b}: {m}")
            if launches != expected:
                raise AssertionError(f"B={b} train step launched {launches}; expected {expected}")
            rows.append(ms)
            counts[b] = launches
        log(f"full-width train flash_pack={flash_pack} B={b}: {sum(rows) / 2:.1f} ms/step (mean of 2 after 1 warm-up; "
            f"{', '.join(f'{r:.1f}' for r in rows)}), peak memory {max(peaks):.2f} GiB [{card}]")
        if b == 1:
            check_full_grads(state, batches, gen)
    # an eval pass of the trained model: bf16 casts of the fp32 masters, BN in fp32
    images = torch.rand(1, 512, 512, 3, device="cuda", generator=gen)
    reset_counts()
    ids = state.model.eval_forward_ids(images)
    torch.cuda.synchronize()
    check_ids(ids, (1, 512, 512), cfg.num_classes)
    log(f"eval pass of the trained bf16 model (step {state.step}): ids in range, launches "
        f"{launch_counts()}")
    if launch_counts() != (PACKED_EVAL_LAUNCHES if flash_pack else EVAL_LAUNCHES["aspp"]):
        raise AssertionError(f"trained model's eval pass launched {launch_counts()}")
    return counts[1]


def run_full(card):
    """The flagship eval pass in each kernel head at B=1 and B=2; returns
    the model and the B=1 launch counts of each head."""
    cfg = MADMConfig()
    t0 = time.perf_counter()
    model = init_random_(MADM(cfg, device="cuda"), torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"full width: MADMConfig() built with seeded random weights in "
        f"{time.perf_counter() - t0:.1f} s, {sum(p.numel() for p in model.parameters())} parameters")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    counts, aspp_ids = {}, {}
    for b in (1, 2):
        images = torch.rand(b, 512, 512, 3, device="cuda", generator=gen)
        ids_of = {}
        for mode, expected in EVAL_LAUNCHES.items():
            model.eval_forward_ids(images, eval_head=mode)  # warm-up (cuDNN algorithm choice)
            torch.cuda.synchronize()
            reset_counts()
            ids = model.eval_forward_ids(images, eval_head=mode)
            torch.cuda.synchronize()
            counts[b, mode] = launch_counts()
            check_ids(ids, (b, 512, 512), cfg.num_classes)
            ids_of[mode] = ids
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: model.eval_forward_ids(images, eval_head=mode), reps=5, warmup=0)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            agree = (ids == ids_of["aspp"]).double().mean().item()
            log(f"full width B={b} '{mode}' head: launches {counts[b, mode]}; ids in range, equal "
                f"to the 'aspp' head's on {agree:.4f} of pixels; {ms / b:.2f} ms/crop "
                f"({ms:.2f} ms/pass), peak memory {peak:.2f} GiB [{card}]")
            if counts[b, mode] != expected:
                raise AssertionError(f"B={b} '{mode}' pass launched {counts[b, mode]}; expected {expected}")
            if agree < 0.99:  # near-ties and bf16 rounding at other places
                raise AssertionError(f"B={b} '{mode}' head agrees with 'aspp' on only {agree:.4f}")
        logits = model.eval_forward(images)
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        agree = (argmax_classes(logits, dim=-1) == ids_of["aspp"]).double().mean().item()
        log(f"full width B={b}: logits finite; 'aspp' head ids equal the module head's argmax on "
            f"{agree:.4f} of pixels")
        aspp_ids[b] = (images, ids_of["aspp"])
    # the noise floor of bf16 ids under a rounding change elsewhere: the first
    # B=2 image alone against the same image in the batch of 2 (unpacked)
    images, ref_ids = aspp_ids[2]
    alone = model.eval_forward_ids(images[:1], eval_head="aspp")
    floor = (alone == ref_ids[:1]).double().mean().item()
    log(f"full width B=1 against B=2 (same image, unpacked 'aspp'): ids equal on {floor:.4f} of pixels")
    # the same weights with flash_pack: K4 in place of K1 at S=4096
    packed = MADM(dataclasses.replace(cfg, flash_pack=True), device="cuda")
    packed.load_state_dict(model.state_dict())
    for b, (images, ref_ids) in aspp_ids.items():
        packed.eval_forward_ids(images, eval_head="aspp")  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        ids = packed.eval_forward_ids(images, eval_head="aspp")
        torch.cuda.synchronize()
        counts[b, "packed"] = launch_counts()
        check_ids(ids, (b, 512, 512), cfg.num_classes)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: packed.eval_forward_ids(images, eval_head="aspp"), reps=5, warmup=0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        agree = (ids == ref_ids).double().mean().item()
        log(f"full width flash_pack B={b} 'aspp' head: launches {counts[b, 'packed']}; ids equal the "
            f"unpacked pass's on {agree:.4f} of pixels; {ms / b:.2f} ms/crop ({ms:.2f} ms/pass), "
            f"peak memory {peak:.2f} GiB (the unpacked model's weights resident too) [{card}]")
        if counts[b, "packed"] != PACKED_EVAL_LAUNCHES:
            raise AssertionError(f"B={b} flash_pack pass launched {counts[b, 'packed']}; "
                                 f"expected {PACKED_EVAL_LAUNCHES}")
        # in bf16, K4 rounds P after the normaliser and K1 before it; the
        # random-weight model turns such rounding changes into id flips at
        # near-ties (the slide forms, which differ only in batch composition,
        # agree on ~97%; the B=1/B=2 floor above); the fp32 check below holds
        # the function itself
        if agree < 0.95:
            raise AssertionError(f"B={b} flash_pack ids agree with the unpacked pass on only {agree:.4f}")
    del packed
    # fp32, same weights and B=1 images: packed and unpacked differ only in
    # summation order, so the ids must agree on >= 99% of pixels
    ids32 = {}
    for pack in (False, True):
        m32 = MADM(dataclasses.replace(cfg, compute_dtype=torch.float32, flash_pack=pack), device="cuda")
        m32.load_state_dict(model.state_dict())
        reset_counts()
        ids32[pack] = m32.eval_forward_ids(aspp_ids[1][0], eval_head="aspp")
        torch.cuda.synchronize()
        counts[pack, "fp32"] = launch_counts()
        del m32
    agree = (ids32[True] == ids32[False]).double().mean().item()
    log(f"full width fp32 B=1 'aspp' head, flash_pack against not: ids equal on {agree:.6f} of pixels "
        f"(tol 0.99); launches {counts[True, 'fp32']} and {counts[False, 'fp32']}")
    if agree < 0.99 or counts[True, "fp32"] != PACKED_EVAL_LAUNCHES:
        raise AssertionError(f"fp32 flash_pack pass: ids agree on {agree}, launches {counts[True, 'fp32']}")
    torch.cuda.empty_cache()
    return model, {mode: counts[1, mode] for mode in (*EVAL_LAUNCHES, "packed")}


def check_ids(ids, shape, num_classes):
    if tuple(ids.shape) != tuple(shape) or ids.dtype != torch.int32:
        raise AssertionError(f"ids {tuple(ids.shape)} {ids.dtype}; expected {tuple(shape)} int32")
    lo, hi = ids.min().item(), ids.max().item()
    if lo < 0 or hi >= num_classes:
        raise AssertionError(f"ids outside [0, {num_classes}): {lo}..{hi}")


def synthetic_samples(n, h, w, num_classes, seed):
    """Test-loader samples: an image [1, H, W, 3] in [0, 1] and a label map."""
    rng = np.random.default_rng(seed)
    return [{"target_second_modality": rng.uniform(size=(1, h, w, 3)).astype(np.float32),
             "target_label": rng.integers(0, num_classes, size=(h, w)).astype(np.int32)}
            for _ in range(n)]


def run_slide_and_dataset(model, card):
    """Sliding-window eval of 512x1024 images in both forms, without and
    with eval_with_noise; then inference_on_dataset single-crop and slide."""
    nc = model.cfg.num_classes
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = []
    for b in (1, 2):
        images = torch.rand(b, 512, 1024, 3, device="cuda", generator=gen)
        ids_of = {}
        for form in ("window", "batch"):
            for noise in (None, 900):
                fn = make_slide_eval_fn(model, eval_with_noise=noise, form=form)
                fn(images)  # warm-up
                torch.cuda.synchronize()
                reset_counts()
                ids = fn(images)
                torch.cuda.synchronize()
                counts = launch_counts()
                check_ids(ids, (b, 512, 1024), nc)
                ids_of[form, noise] = ids
                expected = {"K1": 34 * (3 if form == "window" else 1), "K2": b}
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(lambda: fn(images), reps=3, warmup=0)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                rows.append(dict(batch=b, form=form, eval_with_noise=noise, ms_per_image=ms / b,
                                 peak_gib=peak, launches=counts))
                log(f"slide eval [{b},512,1024,3] form={form} eval_with_noise={noise}: launches "
                    f"{counts}; ids in range; {ms / b:.2f} ms/image ({ms:.2f} ms/pass), peak memory "
                    f"{peak:.2f} GiB [{card}]")
                if counts != expected:
                    raise AssertionError(f"slide pass launched {counts}; expected {expected}")
        # the forms differ only in batch composition, which moves bf16 rounding
        # through the UNet: near-ties of the random weights flip (phase 4 holds
        # the two forms to the CPU twins in fp32)
        same = (ids_of["window", None] == ids_of["batch", None]).double().mean().item()
        moved = (ids_of["batch", None] != ids_of["batch", 900]).double().mean().item()
        log(f"slide eval B={b}: 'window' and 'batch' ids equal on {same:.4f} of pixels; "
            f"eval_with_noise=900 changes {moved:.4f} of them")
        if same < 0.95 or moved < 0.05:
            raise AssertionError(f"slide forms agree on {same}, noise moved {moved}")

    for slide, batch, (h, w) in ((False, 2, (512, 512)), (True, 1, (512, 1024))):
        samples = synthetic_samples(4, h, w, nc, SEED + 8)
        ev = DSECSemSegEvaluator(stuff_classes=[f"class{i}" for i in range(nc)])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = inference_on_dataset(model, samples, ev, slide_inference=slide, batch=batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        metrics = {k: res["sem_seg"][k] for k in ("mIoU", "fwIoU", "mACC", "pACC")}
        log(f"inference_on_dataset {'slide' if slide else 'single-crop'} {h}x{w} batch {batch}: "
            f"{ev.eval_index} samples, {dt / len(samples):.3f} s/image (first groups included), "
            f"launches {counts}; " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()) + f" [{card}]")
        if ev.eval_index != len(samples) or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"dataset eval: {ev.eval_index} samples, metrics {metrics}")
        if not (counts.get("K1") and counts.get("K2")):
            raise AssertionError(f"dataset eval did not launch K1 and K2: {counts}")
    return rows


CLI_CONFIG = "madm_torch/configs/SemSeg/MTMADISE/mtmadise_cityscapes_rgb_to_depth_11.py"
# two B=2 train steps and an eval of 4 test images, flash_pack on
CLI_TRAIN_LAUNCHES = {k: 2 * v for k, v in PACKED_TRAIN_LAUNCHES.items()}
CLI_EVAL_LAUNCHES = {k: 4 * v for k, v in PACKED_EVAL_LAUNCHES.items()}


def write_png_dataset(root, n=4, h=512, w=1024, seed=SEED + 10):
    """A synthetic PNG dataset for the CLI: n 512x1024 source images with
    Cityscapes-id labels (19 classes), n target images with DELIVER-id labels
    (25), train and test manifests, and the rare-class statistics of the
    source labels (``sample_class_stats.json``, ``samples_with_class.json``)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    train = {"source_data": {"RGB": [], "label": []}, "target_data": {"second_modality": []}}
    test = {"source_data": {"RGB": [], "label": []}, "target_data": {"second_modality": [], "label": []}}
    stats, with_class = [], {}
    for i in range(n):
        names = (f"src{i}.png", f"lbl{i}.png", f"tgt{i}.png", f"tlbl{i}.png")
        lbl = rng.integers(0, 19, (h, w), dtype=np.uint8)
        for name, arr in zip(names, (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), lbl,
                                     rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                                     rng.integers(0, 25, (h, w), dtype=np.uint8))):
            Image.fromarray(arr).save(root / name)
        train["source_data"]["RGB"].append(names[0])
        train["source_data"]["label"].append(names[1])
        train["target_data"]["second_modality"].append(names[2])
        test["target_data"]["second_modality"].append(names[2])
        test["target_data"]["label"].append(names[3])
        counts = np.bincount(lbl.ravel(), minlength=19)
        stats.append({"file": names[1], **{str(c): int(k) for c, k in enumerate(counts) if k}})
        for c, k in enumerate(counts):
            with_class.setdefault(str(c), []).append([names[1], int(k)])
    for name, obj in (("train.json", train), ("test.json", test), ("sample_class_stats.json", stats),
                      ("samples_with_class.json", with_class)):
        (root / name).write_text(json.dumps(obj))


def run_cli(card):
    """``python -m madm_torch.main`` on the card: the shipped depth config at
    full width in bf16 with model.flash_pack=True (rare-class sampling on),
    on a synthetic PNG dataset of 4 images at 512x1024: two train iterations
    at --bs 2, an eval of the 4 test images, the periodic and the best
    checkpoint; then --eval-only --init-from the best checkpoint, which must
    give the same metrics.  Each run's kernel launches are counted."""
    import logging
    import tempfile
    from pathlib import Path

    from madm_torch.main import main as cli_main

    # the CLI logs at INFO (environment, parameter table, per-class results)
    # where no logging is configured; this script prints its own summary
    logging.basicConfig(level=logging.WARNING)
    with tempfile.TemporaryDirectory(prefix="madm_cli_") as tmp:
        root = Path(tmp) / "data"
        root.mkdir()
        write_png_dataset(root)
        out = Path(tmp) / "run"
        argv = ["--config-file", CLI_CONFIG, "--bs", "2", "--max_iter", "2", "--eval_iter", "2",
                "--source_root", str(root), "--target_root", str(root), "--output", str(out),
                f"dataloader.train.dataset.json_path={str(root / 'train.json')!r}",
                f"dataloader.test.dataset.json_path={str(root / 'test.json')!r}",
                "train.log_period=1", "model.flash_pack=True"]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        rows = [json.loads(line) for line in (out / "metrics.json").read_text().splitlines()]
        iter_s = [r["time"] for r in rows if "total_loss" in r and "eval/mIoU" not in r]
        results = {k[5:]: v for k, v in rows[-1].items() if k.startswith("eval/")}
        files = sorted(f"{p.relative_to(out)} ({p.stat().st_size} B)" for p in out.rglob("*") if p.is_file())
        expected = {k: CLI_TRAIN_LAUNCHES.get(k, 0) + CLI_EVAL_LAUNCHES.get(k, 0)
                    for k in {*CLI_TRAIN_LAUNCHES, *CLI_EVAL_LAUNCHES}}
        log(f"CLI train (depth config, full width, bf16, flash_pack, --bs 2 --max_iter 2 --eval_iter 2): "
            f"step {state.step}, {wall:.1f} s in all; s/iter {', '.join(f'{s:.3f}' for s in iter_s)} "
            f"(the first includes set-up); eval {results}; launches {counts}; files {files} [{card}]")
        del state
        torch.cuda.empty_cache()
        if counts != expected:
            raise AssertionError(f"CLI run launched {counts}; expected {expected}")
        if not (results and all(math.isfinite(v) for v in results.values())
                and any(f.startswith("model_best.pth") for f in files)
                and all(math.isfinite(r["total_loss"]) for r in rows if "total_loss" in r)):
            raise AssertionError(f"CLI run: eval {results}, files {files}")

        ins = argv.index("--output")
        argv2 = argv[:ins] + ["--output", str(Path(tmp) / "eval"), "--eval-only", "--init-from",
                              str(out / "model_best.pth")] + argv[ins + 2:]
        reset_counts()
        t0 = time.perf_counter()
        again = cli_main(argv2)
        torch.cuda.synchronize()
        counts = launch_counts()
        log(f"CLI --eval-only --init-from model_best.pth: {time.perf_counter() - t0:.1f} s; "
            f"eval {again}; launches {counts} [{card}]")
        torch.cuda.empty_cache()
        if counts != CLI_EVAL_LAUNCHES:
            raise AssertionError(f"CLI eval-only launched {counts}; expected {CLI_EVAL_LAUNCHES}")
        if {k: float(again[k]) for k in results} != results:
            raise AssertionError(f"--eval-only gave {again}, the training run's eval {results}")


# phase 10: the adapters of the loaded model, and what its passes launch
REAL_LORA = "default_r16_a16,Depth_r16_a8"


def clip_text_state(gen):
    """A seeded HF ``CLIPTextModel`` state dict at CLIP ViT-L/14 text width
    (49408 x 768, 12 layers), rounded to bf16 and held in fp32 on the CPU:
    embeddings N(0, 0.02^2), linears N(0, 1/fan_in), biases N(0, 0.02^2),
    LayerNorm weights 1 + N(0, 0.1^2)."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in CLIPTextTransformer().state_dict().items()}
    out = {"text_model.embeddings.position_ids": torch.arange(77)[None]}
    for k, shape in shapes.items():
        std = (shape[1] ** -0.5 if len(shape) == 2 and "embedding" not in k else 0.02 if "norm" not in k
               else 0.1)
        w = torch.randn(shape, generator=gen, device="cuda") * std
        if "norm" in k and k.endswith("weight"):
            w += 1.0
        out["text_model." + k] = w.bfloat16().float().cpu()
    return out


def run_real_weights(card):
    """Phase 10: real-weight loading at full width on files this phase
    writes (no snapshot or checkpoint is in the repository).  Returns the
    launch counts of the loaded model's eval pass and train step."""
    import logging
    import tempfile
    from pathlib import Path

    from madm_torch.main import build_model_and_state, build_parser, do_test, main as cli_main, setup

    logging.basicConfig(level=logging.WARNING)
    t_all = t = time.perf_counter()

    def lap():
        nonlocal t
        now = time.perf_counter()
        dt, t = now - t, now
        return f"{dt:.1f} s [{card}]"

    with tempfile.TemporaryDirectory(prefix="madm_weights_") as tmp:
        tmp = Path(tmp)
        root = tmp / "data"
        root.mkdir()
        write_png_dataset(root)

        def argv(out, *extra):
            return ["--config-file", CLI_CONFIG, "--source_root", str(root), "--target_root", str(root),
                    "--output", str(tmp / out), "--lora_configs", REAL_LORA, *extra,
                    f"dataloader.train.dataset.json_path={str(root / 'train.json')!r}",
                    f"dataloader.test.dataset.json_path={str(root / 'test.json')!r}"]

        # 1. the writer: the CLI's model on seeded random weights, B nonzero,
        # the UNet's fp32 masters rounded to fp16 (so the F16 file is exact)
        parser = build_parser()
        wargs = parser.parse_args(argv("writer"))
        wcfg = setup(wargs)
        writer, _, _ = build_model_and_state(wcfg, wargs)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
        with torch.no_grad():
            for adapter in writer.lora.values():
                for _, site in adapter.sites():
                    site.lora_B.copy_(torch.randn(site.lora_B.shape, generator=gen, device="cuda") * 0.01)
            for p in writer.unet.parameters():
                p.copy_(p.half().float())
            for k, v in writer.state_dict().items():  # a teacher and BN statistics of their own
                if k.startswith("ema.") and v.is_floating_point():
                    v.add_(torch.randn(v.shape, generator=gen, device="cuda") * 1e-3)
                elif k.endswith(("running_mean", "running_var")):
                    v.add_(torch.rand(v.shape, generator=gen, device="cuda") * 0.1)
            clip = clip_text_state(gen)
            writer.uncond_inputs.copy_(compute_uncond_inputs(clip, device="cuda"))
        torch.cuda.synchronize()
        log(f"real weights 1: writer built (depth config, full width, bf16 compute, adapters "
            f"{REAL_LORA}, B ~ N(0, 0.01^2)) in {lap()}")
        snap, pth = tmp / "sd", tmp / "released.pth"
        save_sd_snapshot(str(snap), writer, clip, unet_dtype=torch.float16, text_dtype=torch.bfloat16)
        ref_sd = reference_state_dict(writer)
        torch.save({"model": ref_sd, "iteration": 0}, pth)
        sizes = {str(f.relative_to(tmp)): f.stat().st_size for f in sorted(tmp.rglob("*"))
                 if f.is_file() and f.suffix in (".safetensors", ".bin", ".pth")}
        log(f"real weights 1: wrote {sizes} bytes ({len(ref_sd)} keys in released.pth, "
            f"{sum(k.count('.lora_') for k in ref_sd)} adapter tensors) in {lap()}")
        del ref_sd

        # 2. uncond_inputs: CUDA against the CPU (fp32, TF32 off)
        cpu_uncond = compute_uncond_inputs(clip, device="cpu")
        err = (writer.uncond_inputs.cpu() - cpu_uncond).abs().max().item()
        tol = 1e-4 * max(1.0, cpu_uncond.abs().max().item())
        log(f"real weights 2: uncond_inputs [1,77,768] CUDA vs CPU max_abs_err={err:.3e} (tol {tol:.3e}, "
            f"max |x| {cpu_uncond.abs().max().item():.3f}) in {lap()}")
        if not err <= tol:
            raise AssertionError("uncond_inputs on CUDA disagree with the CPU")

        # 3. a fresh model through the loaders, as the CLI builds it
        largs = parser.parse_args(argv("loaded", "--sd-snapshot", str(snap)))
        loaded_cfg = setup(largs)
        _, state, _ = build_model_and_state(loaded_cfg, largs)
        state, _ = Checkpointer(str(tmp / "loaded")).resume_or_load(state, init_from=str(pth), resume=False)
        model = state.model
        want, got = writer.state_dict(), model.state_dict()
        differ = [k for k in want if k not in got or not torch.equal(want[k], got[k])]
        torch.cuda.synchronize()
        log(f"real weights 3: loaded model (snapshot + released.pth) equals the writer on "
            f"{len(want) - len(differ)} of {len(want)} tensors in {lap()}")
        if differ or want.keys() != got.keys():
            raise AssertionError(f"loaded state differs from the writer's at {differ[:10]}")

        # 4. 'aspp' ids with the Depth adapter: the same weights, so the same ids
        images = torch.rand(1, 512, 512, 3, device="cuda", generator=gen)
        ids_w = writer.eval_forward_ids(images, eval_head="aspp", lora_name="Depth")
        reset_counts()
        ids = model.eval_forward_ids(images, eval_head="aspp", lora_name="Depth")
        torch.cuda.synchronize()
        eval_counts = launch_counts()
        check_ids(ids, (1, 512, 512), model.cfg.num_classes)
        moved = (ids != model.eval_forward_ids(images, eval_head="aspp")).double().mean().item()
        lap()
        merge_ms = cuda_ms(lambda: model.lora_weights("Depth"), reps=10)
        pass_ms = {name: cuda_ms(lambda: model.eval_forward_ids(images, eval_head="aspp", lora_name=name),
                                 reps=5) for name in ("Depth", None)}
        log(f"real weights 4: 'aspp' ids with lora_name='Depth' equal the writer's: {torch.equal(ids, ids_w)}; "
            f"the adapter changes {moved:.4f} of them; launches {eval_counts}; the merge of its 128 sites "
            f"{merge_ms:.3f} ms, the B=1 pass {pass_ms['Depth']:.2f} ms with it and {pass_ms[None]:.2f} "
            f"without (5 passes each); {lap()}")
        if not torch.equal(ids, ids_w) or eval_counts != EVAL_LAUNCHES["aspp"]:
            raise AssertionError(f"loaded model's ids differ from the writer's or launches {eval_counts}")

        # 5. one train step of the loaded state with the adapters
        batches = synthetic_batches(1, model.cfg.crop_size, model.cfg.num_classes, gen)
        reset_counts()
        m = train(state, batches, steps=1, generator=gen)[0]
        torch.cuda.synchronize()
        train_counts = launch_counts()
        grads = {n: p.grad for n, p in model.named_parameters() if n.startswith("lora.")}
        bad = [n for n, g in grads.items() if g is None or not torch.isfinite(g).all() or not g.any()]
        log(f"real weights 5: train step {state.step} with adapters: {len(grads) - len(bad)} of {len(grads)} "
            f"adapter tensors with a finite nonzero gradient; launches {train_counts}; "
            + " ".join(f"{k}={v:.5f}" for k, v in m.items()) + f"; {lap()}")
        if bad or not all(math.isfinite(v) for v in m.values()) or train_counts != TRAIN_LAUNCHES:
            raise AssertionError(f"LoRA train step: gradients {bad[:10]}, metrics {m}, launches {train_counts}")
        del state, model, m, grads, batches
        gc.collect()
        torch.cuda.empty_cache()

        # 6. the CLI's --eval-only on the released files, against do_test on the writer
        want_metrics = do_test(wcfg, writer, None, wargs)
        lap()
        del writer
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts()
        got_metrics = cli_main(argv("cli", "--sd-snapshot", str(snap), "--eval-only",
                                    "--init-from", str(pth)))
        torch.cuda.synchronize()
        counts = launch_counts()
        log(f"real weights 6: CLI --eval-only --init-from released.pth --sd-snapshot --lora_configs "
            f"{REAL_LORA}: {({k: float(v) for k, v in got_metrics.items()})}; the writer's do_test "
            f"{({k: float(v) for k, v in want_metrics.items()})}; launches {counts}; {lap()}")
        expected = {k: 4 * v for k, v in EVAL_LAUNCHES["aspp"].items()}
        if {k: float(v) for k, v in got_metrics.items()} != {k: float(v) for k, v in want_metrics.items()}:
            raise AssertionError("the CLI's metrics on the released files differ from the writer's")
        if counts != expected:
            raise AssertionError(f"CLI eval-only launched {counts}; expected {expected}")
    log(f"phase 10 steps: {time.perf_counter() - t_all:.1f} s in all [{card}]")
    return eval_counts, train_counts


# ------------------------------------------------------------------ phase 11
# the UDA step's ablation groups: (MADMConfig fields, TrainConfig fields),
# as tests/test_torch_ablation_step_*.py group them (the exclusive MIC slot
# once a group)
ABLATION_LORA = ("default_r16_a16", "Depth_r16_a8")
ABLATION_GROUPS = {
    "mic": (dict(reg_target_palette="discrete"),
            dict(mic=True, mic_reg=1.0, denoise_supervise=1.0, denoise_interval=5, fd=0.5,
                 noise_reg=1.0, pl_crop=True, pseudo_weight_scope="batch",
                 merge_with_pl_data="linear_mix")),
    "texture": (dict(finetune_unet="without cross-attention", ema_w_unet=True, lora_configs=ABLATION_LORA),
                dict(remove_texture=True, prompt_confidence=0.5, enable_mixup=False, unet_lr=2.5e-5)),
    "masked": (dict(mask_prompt_ratio=0.5, detach_mask_prompt=True, add_latent_noise=0.5,
                    norm_latent_noise=True),
               dict(mask_prompt_ratio=0.5, detach_mask_prompt=True, rev_noise_gradually=False)),
    "perturbed": (dict(prompt_perturbation=0.1, finetune_unet="attention", prompt_seq_len=100),
                  dict(prompt_perturbation=0.1, vae_decoder_loss_type="L2", rev_noise_sup=False,
                       reg_uncertain=False, schedule="linear")),
}
ABLATION_LOSSES = {"mic": ("masked_prompt_consistency_loss", "mic_vae_decoder_loss",
                           "denoise_consistency_loss", "feature_distance_loss", "noise_reg_loss"),
                   "texture": ("masked_prompt_consistency_loss",), "masked": ("masked_prompt_consistency_loss",),
                   "perturbed": ("masked_prompt_consistency_loss",)}
ABLATION_EXTRA = ("source_pl_data", "target_second_modality_pha")
# K1 and K3 at the cross-attentions' key length under prompt_seq_len=100 (a
# tile of 128 keys, 28 past the end: TMA's zero fill and the mask)
PROMPT_CASES = tuple((1, sq, 100, h, d, n) for sq, sk, h, d, n in FLASH_SHAPES if sk == 77)


def derived_launches(tc):
    """K1 and K3 launches of one step, derived from its passes: 34 K1 a
    backbone pass with the VAE decoder (VAE encoder 1, UNet 32, decoder 1),
    33 one without it (the passes whose losses read no head: the fd
    baseline's, a MIC pass for mic_reg alone, denoise_supervise's and
    noise_reg's student pass), 1 a palette encode; 32 K3 a student pass with
    a gradient through the UNet (the perturbed-prompt pass trains the head
    alone)."""
    decoded = (3 + (tc.prompt_confidence is not None) + bool(tc.noise_reg) + bool(tc.mic)
               + bool(tc.remove_texture) + bool(tc.mask_prompt_ratio) + bool(tc.prompt_perturbation))
    undecoded = (bool(tc.fd) + bool(tc.mic_reg and not tc.mic) + bool(tc.denoise_supervise)
                 + bool(tc.noise_reg))
    encodes = len(tc.vae_decoder_loss) + bool(tc.mic_reg or tc.denoise_supervise) + bool(tc.noise_reg)
    graded = (2 + bool(tc.mic or tc.mic_reg) + bool(tc.remove_texture) + bool(tc.mask_prompt_ratio)
              + bool(tc.denoise_supervise) + bool(tc.noise_reg))
    return {"K1": 34 * decoded + 33 * undecoded + encodes, "K3": 32 * graded}


SEG_SCALE = 40.0  # conv_seg x40: the toy teacher is confident on part of an image


def ablation_model(cfg, device, gen):
    """A trainable model of ``cfg`` on seeded weights, its adapters' B drawn
    nonzero (else no gradient reaches A) and its heads' conv_seg scaled by
    ``SEG_SCALE``, so that the pseudo-weighted losses are live."""
    model = init_random_(MADM(cfg, device=device, trainable=True), gen)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("lora_B"):
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * 0.05)
        for head in (model.sem_seg_head, model.ema["sem_seg_head"]):
            head.conv_seg.weight.mul_(SEG_SCALE)
        model.reset_ema_()
    return model


def ablation_state(model, tc, gen):
    """The train state; under ``fd`` or ``fd_attention`` the baseline, then
    the student's UNet moved 1% off it (so that the distance and its
    gradient are not 0)."""
    state = make_train_state(model, tc)
    if tc.fd or tc.fd_attention:
        add_feature_distance_baseline(state)
        with torch.no_grad():
            for p in model.unet.parameters():
                p.mul_(1 + 0.01 * torch.randn(p.shape, generator=gen, device=p.device))
    return state


def check_ablation_toy():
    """Phase 11 (a): one step of each ablation group on the toy model in fp32
    (TF32 off), CUDA (kernels) against CPU (twins), from the same weights,
    batch and draws: losses and grad_norm to 1e-4 relative, gradients (Adam's
    first moment) to 2e-3 of the largest entry (phase 6's tolerances), and
    the CUDA step's launches equal to the derived counts."""
    check_toy_groups("11", ABLATION_GROUPS, ABLATION_LOSSES, lambda cfg, tc: derived_launches(tc),
                     ablation_model)


def check_toy_groups(phase, groups, branch_losses, launches_of, model_of):
    """One toy fp32 step of each group (MADMConfig fields, TrainConfig
    fields) on ``model_of(cfg, device, generator)``'s weights, CUDA against
    CPU (``check_ablation_toy``'s checks); the CUDA step's launches equal to
    ``launches_of(cfg, tc)``."""
    for name, (model_kw, tc_kw) in groups.items():
        cfg = dataclasses.replace(TOY, **model_kw)
        tc = TrainConfig(**tc_kw)
        cpu = model_of(cfg, "cpu", torch.Generator().manual_seed(SEED))
        gpu = MADM(cfg, device="cuda", trainable=True)
        gpu.load_state_dict(cpu.state_dict())
        s_cpu = ablation_state(cpu, tc, torch.Generator().manual_seed(SEED + 1))
        s_gpu = make_train_state(gpu, tc)
        if tc.fd or tc.fd_attention:  # the baseline is the unperturbed start: the CPU's, copied
            add_feature_distance_baseline(s_gpu)
            for k, m in s_cpu.consts.items():
                s_gpu.consts[k].load_state_dict(m.state_dict())
            gpu.load_state_dict(cpu.state_dict())
        gen = torch.Generator().manual_seed(SEED + 11)
        batch = next(synthetic_batches(2, cfg.crop_size, cfg.num_classes, gen, extra=ABLATION_EXTRA))
        draws = sample_draws(gen, tc, batch["source_label"], cfg.num_classes, cpu.sem_seg_head, cfg)
        m_cpu = train_step(s_cpu, batch, draws=draws)
        reset_counts()
        m_gpu = train_step(s_gpu, batch, draws=draws)
        launches = launch_counts()
        expected = launches_of(cfg, tc)
        worst = max(abs(m_gpu[k] - v) / max(abs(v), 1e-3) for k, v in m_cpu.items())
        named_cpu, named_gpu = dict(cpu.named_parameters()), dict(gpu.named_parameters())
        mom = [(s_gpu.optimizer.state[named_gpu[n]]["exp_avg"].cpu(), s_cpu.optimizer.state[p]["exp_avg"])
               for n, p in named_cpu.items() if p.requires_grad]
        mmax = max(c.abs().max().item() for _, c in mom)
        grad_err = max((g - c).abs().max().item() for g, c in mom) / mmax
        live = [k for k in branch_losses[name] if m_cpu[k] != 0.0]  # 0 where pseudo_val is 0
        log(f"phase {phase} toy '{name}' step (fp32): CUDA vs CPU losses/grad_norm max rel err {worst:.3e} "
            f"(tol 1e-4); gradients (Adam first moment) max err {grad_err:.3e} of the largest (tol 2e-3); "
            f"{len(mom)} trained tensors; branch losses nonzero {live}; CUDA launches {launches} "
            f"(derived {expected}); " + " ".join(f"{k}={v:.5f}" for k, v in m_gpu.items()))
        if not (worst <= 1e-4 and grad_err <= 2e-3):
            raise AssertionError(f"phase {phase} toy '{name}': CUDA disagrees with the CPU twins")
        if launches != expected:
            raise AssertionError(f"phase {phase} toy '{name}' launched {launches}; derived {expected}")


def live_warm_up(state, batches, gen):
    """Warm-up steps until the teacher is confident on part of the image (0 <
    pseudo_val < 1, so that the pseudo-weighted losses are live), scaling both
    heads' conv_seg by 4 (or 1/4) between tries; returns the last metrics."""
    model = state.model
    for _ in range(5):
        m = train(state, batches, steps=1, generator=gen)[0]
        if 0.0 < m["pseudo_val"] < 1.0:
            return m
        with torch.no_grad():
            for head in (model.sem_seg_head, model.ema["sem_seg_head"]):
                head.conv_seg.weight.mul_(4.0 if m["pseudo_val"] == 0.0 else 0.25)
    raise AssertionError(f"no conv_seg scale gave a partly confident teacher: {m}")


def run_ablation_full(card):
    """Phase 11 (b): each ablation group at full width in bf16, B=1, on a
    model of its own MADMConfig (a build takes 0.1 s): warm-up steps
    (``live_warm_up``), then one step with CUDA-event ms, peak memory and launches, which must
    equal the derived counts; every trained tensor's gradient finite and
    nonzero (alpha_uncond_prompt exempt while uncond_inputs is zeros), the
    branch losses finite and nonzero."""
    return {name: run_group_full("11", name, *ABLATION_GROUPS[name], ABLATION_LOSSES[name],
                                 lambda cfg, tc: derived_launches(tc), card)
            for name in ABLATION_GROUPS}


def run_group_full(phase, name, model_kw, tc_kw, branch_losses, launches_of, card, batch=1,
                   keep=None):
    """One group at full width in bf16 (``run_ablation_full``'s checks) at
    ``batch``; ``keep(state)`` sees the stepped state before it is freed.
    Returns the step's row."""
    t0 = time.perf_counter()
    cfg, tc = MADMConfig(**model_kw), TrainConfig(**tc_kw)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    state = ablation_state(ablation_model(cfg, "cuda", gen), tc, gen)
    batches = synthetic_batches(batch, cfg.crop_size, cfg.num_classes, gen, extra=ABLATION_EXTRA)
    warm = live_warm_up(state, batches, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    m = train(state, batches, steps=1, generator=gen)[0]
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = launches_of(cfg, tc)
    named = trainable_parameters(state.model)
    exempt = () if state.model.uncond_inputs.any() else ("alpha_uncond_prompt",)
    faults = [n for n, p in named if p.grad is None or not torch.isfinite(p.grad).all()
              or not (p.grad.any() or n.endswith(exempt))]
    dead = [k for k in branch_losses if not (math.isfinite(m[k]) and m[k] != 0.0)]
    row = dict(ms=ms, peak_gib=peak, launches=launches, derived=expected, batch=batch)
    log(f"phase {phase} full-width '{name}' B={batch} step {state.step}: {ms:.1f} ms, peak memory "
        f"{peak:.2f} GiB; launches {launches} (derived {expected}); {len(named) - len(faults)} of "
        f"{len(named)} trained tensors with a finite nonzero gradient (exempt {exempt}); warm-up "
        f"pseudo_val={warm['pseudo_val']:.5f}; " + " ".join(
            f"{k}={v:.5f}" for k, v in m.items() if k != "step_ms")
        + f"; {time.perf_counter() - t0:.1f} s [{card}]")
    if launches != expected:
        raise AssertionError(f"phase {phase} '{name}' launched {launches}; derived {expected}")
    if faults or dead or not all(math.isfinite(v) for v in m.values()):
        raise AssertionError(f"phase {phase} '{name}': gradients {faults[:10]}, losses {dead}: {m}")
    if keep is not None:
        keep(state)
    del state, batches, named
    gc.collect()
    torch.cuda.empty_cache()
    return row


# ------------------------------------------------------------------ phase 12
# the JAX package's optimizer reducers (TrainConfig fields as build_train_config
# sets them from optimizer.name / no_momentum / mu_dtype)
REDUCERS = {"adafactor": dict(optimizer="adafactor"),
            "adafactor no_momentum": dict(optimizer="adafactor", b1=None),
            "adamw mu bf16": dict(mu_dtype="bfloat16")}


def state_bytes(states):
    """Bytes of the tensors of an optimizer's ``state`` mapping (under
    ZeRO-1 a rank's shard is the wrapped optimizer's, ``optimizer.optim``)."""
    return sum(t.numel() * t.element_size() for st in states.values()
               for t in st.values() if torch.is_tensor(t))


def reckoned_state_bytes(tc, params):
    """The optimizer state's bytes as reckoned from the trained shapes:
    AdamW a first moment (fp32 or bf16) and an fp32 second; Adafactor an
    fp32 row and column of each factored tensor (its two largest axes, the
    second at least 128) or an fp32 v, and a momentum (bf16 unless
    mu_dtype='float32') unless b1 is None."""
    total = 0
    for p in params:
        n = p.numel()
        if tc.optimizer == "adamw":
            total += n * (2 if tc.mu_dtype == "bfloat16" else 4) + 4 * n
            continue
        dims = factored_dims(tuple(p.shape))
        total += 4 * (n if dims is None else n // p.shape[dims[1]] + n // p.shape[dims[0]])
        if tc.b1 is not None:
            total += n * (4 if tc.mu_dtype == "float32" else 2)
    return total


def steps_on_rows(tc, steps, seed, device, starts=None):
    """``steps`` UDA steps of the toy on seeded random weights (``seed``;
    both heads' conv_seg times ``SEG_SCALE``) on seeded synthetic global
    batches of two rows and their draws, both made on the CPU; under a
    process group this rank steps on its rows.  ``starts``: the path of another run's ``starts``, loaded
    (model and optimizer state) before each step, so that each step of the
    two runs sets out from one state.  Returns, on the CPU: each step's
    metrics, the ``snapshot`` at its end, and without ``starts`` the
    snapshot and model state dict at its start; the rank and the world."""
    state = init_train_state(TOY, tc, device=device, seed=seed)
    with torch.no_grad():
        for head in (state.model.sem_seg_head, state.model.ema["sem_seg_head"]):
            head.conv_seg.weight.mul_(SEG_SCALE)
    forced = torch.load(starts, weights_only=False) if starts else None
    gen = torch.Generator().manual_seed(seed + 1)
    batches = synthetic_batches(2, TOY.crop_size, TOY.num_classes, gen)
    out = {"metrics": [], "starts": [], "ends": [], "rank": dist_lib.rank(), "world": dist_lib.world()}
    for t in range(steps):
        if forced is not None:
            state.model.load_state_dict(forced[t]["model"])
            if forced[t]["opt"]["state"]:  # ZeRO-1 keeps this rank's shard of it
                state.optimizer.load_state_dict(copy.deepcopy(forced[t]["opt"]))
        else:
            start = snapshot(state, "cpu")
            del start["grads"]
            start["model"] = {k: v.detach().to("cpu", copy=True) for k, v in state.model.state_dict().items()}
            out["starts"].append(start)
        rows = {k: v[dist_lib.local_rows(2)] for k, v in next(batches).items()}
        draws = sample_draws(gen, tc, rows["source_label"], TOY.num_classes, state.model.sem_seg_head, TOY)
        out["metrics"].append(train_step(state, rows, draws=draws))
        out["ends"].append(snapshot(state, "cpu"))
    return out


def compare(ref, got):
    """How far ``got`` (a run forced onto ``ref``'s starts: CUDA against
    the CPU, or rank 0 of a world-N run against one process) is from
    ``ref``, each step from one state:

    - ``loss_rel``: the largest relative difference of a metric (every
      loss, pseudo_val, grad_norm) of any step, over max(|ref|, 1e-3);
    - ``grad_of_max``: the largest difference of a clipped gradient over
      the step's largest entry (the clip's factor is grad_clip / grad_norm,
      which ``loss_rel`` holds), the worst step;
    - ``state_of_max``: for each optimizer state key, the largest
      difference over the key's largest entry, the worst step (``got``'s
      state consolidated on its rank 0);
    - ``off_rule``: how far ``got``'s weights and optimizer state after a
      step lie from the rule applied to ``ref``'s state before it with
      ``got``'s gradient, in units of fp32 rounding's slack (``off_rule``,
      <= 1 passes), and ``off_rule_ref`` of ``ref``'s own; with ``grad_of_max`` they bound
      each weight and state tensor by the rule applied to the reference's
      state: |x_got - x_ref| <= |X(s_ref, g_got) - X(s_ref, g_ref)| plus
      rounding; ``faults`` names what is off its rule;
    - ``bn_of_max``: the head's BN statistics after each step, the largest
      difference over max(1, the largest statistic)."""
    loss = max(abs(g[k] - v) / max(abs(v), 1e-3)
               for r, g in zip(ref["metrics"], got["metrics"]) for k, v in r.items())
    out = {"loss_rel": loss, "grad_of_max": 0.0, "state_of_max": {}, "off_rule": 0.0,
           "off_rule_ref": 0.0, "faults": [], "bn_of_max": 0.0}
    for start, r, g in zip(ref["starts"], ref["ends"], got["ends"]):
        gmax = max(x.abs().max().item() for x in r["grads"])
        diff = max((a - b).abs().max().item() for a, b in zip(g["grads"], r["grads"]))
        out["grad_of_max"] = max(out["grad_of_max"], diff / gmax)
        for key in {k for st in r["opt"]["state"].values() for k, v in st.items() if torch.is_tensor(v)}:
            pairs = [(g["opt"]["state"][i][key].double(), st[key].double())
                     for i, st in r["opt"]["state"].items() if key in st]
            err = (max((a - b).abs().max().item() for a, b in pairs)
                   / max(b.abs().max().item() for _, b in pairs))
            out["state_of_max"][key] = max(out["state_of_max"].get(key, 0.0), err)
        ratio, faults = off_rule(start, g)
        out["off_rule"], out["faults"] = max(out["off_rule"], ratio), out["faults"] + faults
        ratio, faults = off_rule(start, r)
        out["off_rule_ref"], out["faults"] = max(out["off_rule_ref"], ratio), out["faults"] + faults
        bmax = max(1.0, max(b.abs().max().item() for b in r["bn"].values()))
        bn = max((g["bn"][n] - b).abs().max().item() for n, b in r["bn"].items()) / bmax
        out["bn_of_max"] = max(out["bn_of_max"], bn)
    return out


def compare_line(err):
    return (f"losses and grad_norm max rel err {err['loss_rel']:.3e} (tol 1e-4); clipped gradients "
            f"{err['grad_of_max']:.3e} of the largest (tol 2e-3); optimizer state of the largest "
            + ", ".join(f"{k} {v:.3e}" for k, v in sorted(err["state_of_max"].items()))
            + f"; weights and state off the rule applied to the reference's state: "
            f"{err['off_rule']:.3e} of fp32 rounding's slack (the reference's own "
            f"{err['off_rule_ref']:.3e}; tol 1); BN "
            f"statistics {err['bn_of_max']:.3e} of the largest (tol 1e-5)")


def compare_passes(err):
    return (err["loss_rel"] <= 1e-4 and err["grad_of_max"] <= 2e-3 and err["off_rule"] <= 1.0
            and err["off_rule_ref"] <= 1.0 and not err["faults"] and err["bn_of_max"] <= 1e-5)


def check_reducers_toy():
    """Phase 12 (a): one shipped-config step of the toy model under each
    reducer in fp32 (TF32 off), CUDA (kernels) against CPU (twins), from the
    same state, batch and draws (``compare``): losses and grad_norm to 1e-4
    relative, the clipped gradients to 2e-3 of the largest entry (phase 6's
    tolerances), the head's BN statistics to 1e-5 of the largest, each
    side's weights and optimizer state on the rule applied to the CPU's
    state with that side's gradient, and the state's bytes as reckoned."""
    import tempfile

    for name, kw in REDUCERS.items():
        tc = TrainConfig(**kw)
        ref = steps_on_rows(tc, 1, SEED + 13, "cpu")
        with tempfile.TemporaryDirectory(prefix="madm_starts_") as tmp:
            path = os.path.join(tmp, "starts.pt")
            torch.save(ref["starts"], path)
            reset_counts()
            got = steps_on_rows(tc, 1, SEED + 13, "cuda", starts=path)
            launches = launch_counts()
        err = compare(ref, got)
        end = got["ends"][0]
        nbytes, reckoned = state_bytes(end["opt"]["state"]), reckoned_state_bytes(tc, end["params"])
        log(f"phase 12 toy '{name}' step (fp32), CUDA vs CPU: {compare_line(err)}; state {nbytes} B "
            f"(reckoned {reckoned}); CUDA launches {launches}; "
            + " ".join(f"{k}={v:.5f}" for k, v in got["metrics"][0].items()))
        if not (compare_passes(err) and nbytes == reckoned):
            raise AssertionError(f"phase 12 toy '{name}': CUDA disagrees with the CPU twins: "
                                 f"{err['faults'][:10]}")
        if launches != TRAIN_LAUNCHES:
            raise AssertionError(f"phase 12 toy '{name}' launched {launches}; expected {TRAIN_LAUNCHES}")


def run_reducers_full(card):
    """Phase 12 (a): each reducer at full width (MADMConfig(), shipped
    TrainConfig, bf16, B=1): a warm-up and two steps through the trainer
    entry point, with ms, peak memory and launches (K1 104, K3 64) of each;
    the optimizer state's bytes equal to the reckoning from the trained
    shapes; after the second step every trained tensor finite, and its
    weight and optimizer state on its rule (``off_rule``, from a host
    snapshot taken before the step)."""
    rows = {}
    for name, kw in REDUCERS.items():
        t0 = time.perf_counter()
        cfg, tc = MADMConfig(), TrainConfig(**kw)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
        state = init_train_state(cfg, tc, device="cuda", seed=SEED)
        batches = synthetic_batches(1, cfg.crop_size, cfg.num_classes, gen)
        train(state, batches, steps=1, generator=gen)  # warm-up
        torch.cuda.synchronize()
        ms, peaks = [], []
        for i in range(2):
            if i == 1:  # host copies: the measured step's memory stays the step's
                start = snapshot(state, "cpu")
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start_ev.record()
            m = train(state, batches, steps=1, generator=gen)[0]
            end_ev.record()
            end_ev.synchronize()
            ms.append(start_ev.elapsed_time(end_ev))
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            launches = launch_counts()
            if launches != TRAIN_LAUNCHES:
                raise AssertionError(f"phase 12 '{name}' launched {launches}; expected {TRAIN_LAUNCHES}")
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"phase 12 '{name}': non-finite metrics {m}")
        ratio, faults = off_rule(start, snapshot(state))
        nbytes = state_bytes(state.optimizer.state)
        reckoned = reckoned_state_bytes(tc, state.params)
        n_train = sum(p.numel() for p in state.params)
        rows[name] = dict(ms=ms, peak_gib=max(peaks), state_bytes=nbytes)
        log(f"phase 12 full-width '{name}' B=1 steps {state.step - 1}-{state.step}: "
            f"{', '.join(f'{x:.1f}' for x in ms)} ms, peak memory {', '.join(f'{x:.2f}' for x in peaks)} "
            f"GiB; launches {launches} a step; {len(state.params)} trained tensors, {n_train} "
            f"parameters; optimizer state {nbytes} B = {nbytes / 2 ** 30:.4f} GiB (reckoned "
            f"{reckoned}); {len(state.params) - len(faults)} trained tensors finite and on their "
            f"rule (at most {ratio:.3e} of fp32 rounding's slack); " + " ".join(
                f"{k}={v:.5f}" for k, v in m.items() if k != "step_ms")
            + f"; {time.perf_counter() - t0:.1f} s [{card}]")
        if nbytes != reckoned:
            raise AssertionError(f"phase 12 '{name}': state {nbytes} B, reckoned {reckoned}")
        if faults:
            raise AssertionError(f"phase 12 '{name}': {faults[:10]}")
        del state, batches, start
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _toy_rank(*args):
    """A rank of phase 12 (b)'s toy run (a spawned process: TF32 off again)."""
    _no_tf32()
    return steps_on_rows(*args)


def _full_rank(seed):
    """A rank of phase 12 (b)'s full-width run: the shipped step in bf16 at
    world 2 (ZeRO-1), B=1 a rank, a warm-up and two steps; each step's ms,
    peak memory and launches, the optimizer state this rank holds, and a
    digest of the whole model state (parameters, BN statistics, teacher)."""
    _no_tf32()
    cfg, tc = MADMConfig(), TrainConfig()
    state = init_train_state(cfg, tc, device="cuda", seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    batches = synthetic_batches(2, cfg.crop_size, cfg.num_classes, gen)  # global B=2
    train(state, batches, steps=1, generator=gen)  # warm-up
    steps = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        m = train(state, batches, steps=1, generator=gen)[0]
        torch.cuda.synchronize()
        steps.append(dict(ms=(time.perf_counter() - t0) * 1e3, launches=launch_counts(), metrics=m,
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30))
    digest = hashlib.sha256()
    for k, v in state.model.state_dict().items():
        digest.update(k.encode())
        digest.update(v.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return dict(steps=steps, state_bytes=state_bytes(state.optimizer.optim.state),
                whole_state_bytes=reckoned_state_bytes(tc, state.params),
                sharded=type(state.optimizer).__name__, digest=digest.hexdigest(),
                rank=dist_lib.rank(), world=dist_lib.world())


def same_on_ranks(ranks):
    """Whether every rank's weights, gradients and BN statistics equal rank
    0's, bit for bit, after every step."""
    return all(torch.equal(a, b) for r in ranks[1:] for e0, e in zip(ranks[0]["ends"], r["ends"])
               for key in ("params", "grads") for a, b in zip(e0[key], e[key])) and all(
        torch.equal(t, e["bn"][n]) for r in ranks[1:] for e0, e in zip(ranks[0]["ends"], r["ends"])
        for n, t in e0["bn"].items())


def run_two_ranks(card):
    """Phase 12 (b): two ranks on the one card over gloo on CUDA tensors
    (NCCL refuses two ranks on one device), spawned, each loading phase 2's
    libraries.  The toy in fp32: two steps at world 2 (B=1 a rank), each
    from the state of one process's step at B=2 on CUDA, against those
    steps (``compare``: phase 6's tolerances, the head's BN statistics to
    1e-5 of the largest, rank 0's consolidated ZeRO-1 state and the weights
    on the rule applied to the one process's state), and bit-identical
    across the ranks.  Then the shipped step at full width in bf16 with
    ZeRO-1: each rank K1 104 and K3 64 a step, the whole model state
    bit-identical across the ranks, each rank's peak memory and half the
    optimizer state."""
    import tempfile

    missing = [n for n in kernels.KERNELS if not kernels.library_path(n).exists()]
    if missing:  # the ranks load phase 2's builds; none builds
        raise AssertionError(f"phase 12 (b): no library built for {missing}")
    gc.collect()
    torch.cuda.empty_cache()
    tc = TrainConfig()
    args = (tc, 2, SEED, "cuda")
    t0 = time.perf_counter()
    ref = steps_on_rows(*args)
    with tempfile.TemporaryDirectory(prefix="madm_starts_") as tmp:
        path = os.path.join(tmp, "starts.pt")
        torch.save(ref["starts"], path)
        ranks = dist_lib.run_ranks(_toy_rank, 2, ["cuda:0", "cuda:0"], backend="gloo", args=args + (path,))
    err = compare(ref, ranks[0])
    same = same_on_ranks(ranks)
    log(f"phase 12 toy fp32, world 2 over gloo on one card (B=1 a rank) against one process at B=2 "
        f"(CUDA), two steps, each from the one process's state: {compare_line(err)}; ranks "
        f"bit-identical: {same}; pseudo_val {[round(m['pseudo_val'], 5) for m in ref['metrics']]}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (compare_passes(err) and same):
        raise AssertionError(f"phase 12 (b) toy: world 2 disagrees with one process: {err}, same {same}")
    t0 = time.perf_counter()
    full = dist_lib.run_ranks(_full_rank, 2, ["cuda:0", "cuda:0"], backend="gloo", args=(SEED,))
    for r in full:
        for i, st in enumerate(r["steps"]):
            log(f"phase 12 full-width bf16 world 2 (gloo, two ranks sharing one card: host ms are "
                f"not a scaling figure) rank {r['rank']} step {i + 1}: {st['ms']:.1f} ms, peak memory "
                f"{st['peak_gib']:.2f} GiB; launches {st['launches']}; " + " ".join(
                    f"{k}={v:.5f}" for k, v in st["metrics"].items() if k != "step_ms") + f" [{card}]")
            if st["launches"] != TRAIN_LAUNCHES:
                raise AssertionError(f"phase 12 (b) rank {r['rank']} launched {st['launches']}")
            if not all(math.isfinite(v) for v in st["metrics"].values()):
                raise AssertionError(f"phase 12 (b) rank {r['rank']}: {st['metrics']}")
        log(f"phase 12 full-width world 2 rank {r['rank']}: {r['sharded']}, optimizer state held "
            f"{r['state_bytes']} B of the whole {r['whole_state_bytes']} B "
            f"({r['state_bytes'] / r['whole_state_bytes']:.4f}); model state digest {r['digest'][:16]}")
    if full[0]["digest"] != full[1]["digest"]:
        raise AssertionError("phase 12 (b): the ranks' model states differ after two steps")
    if not all(0.45 < r["state_bytes"] / r["whole_state_bytes"] < 0.55 for r in full):
        raise AssertionError("phase 12 (b): ZeRO-1 does not halve the optimizer state")
    log(f"phase 12 (b) full width: {time.perf_counter() - t0:.1f} s in all")


def run_nccl_cli(card):
    """Phase 12 (c): the CLI with --distributed at WORLD_SIZE=1 on NCCL
    (phase 9's depth config, full width, bf16, flash_pack, two iterations
    at --bs 2 and an eval): NCCL init, the gradient all-reduce, the global
    BN statistics and a ZeRO-1 state consolidated into its checkpoints; then
    --eval-only --init-from the best one in a single process must give the
    same metrics."""
    import logging
    import tempfile
    from pathlib import Path

    from madm_torch.main import main as cli_main

    logging.basicConfig(level=logging.WARNING)
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(dist_lib.free_port()), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    with tempfile.TemporaryDirectory(prefix="madm_nccl_") as tmp:
        root = Path(tmp) / "data"
        root.mkdir()
        write_png_dataset(root)
        out = Path(tmp) / "run"
        argv = ["--config-file", CLI_CONFIG, "--bs", "2", "--max_iter", "2", "--eval_iter", "2",
                "--source_root", str(root), "--target_root", str(root), "--output", str(out),
                f"dataloader.train.dataset.json_path={str(root / 'train.json')!r}",
                f"dataloader.test.dataset.json_path={str(root / 'test.json')!r}",
                "train.log_period=1", "model.flash_pack=True"]
        os.environ.update(env)
        try:
            reset_counts()
            t0 = time.perf_counter()
            state = cli_main(["--distributed"] + argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for k in env:
                os.environ.pop(k, None)
        counts = launch_counts()
        sharded = type(state.optimizer).__name__
        rows = [json.loads(line) for line in (out / "metrics.json").read_text().splitlines()]
        results = {k[5:]: v for k, v in rows[-1].items() if k.startswith("eval/")}
        ckpt = torch.load(out / "model_best.pth", map_location="cpu", weights_only=True)
        whole = len(ckpt["optimizer"]["state"]) == sum(len(g["params"]) for g in ckpt["optimizer"]["param_groups"])
        expected = {k: CLI_TRAIN_LAUNCHES.get(k, 0) + CLI_EVAL_LAUNCHES.get(k, 0)
                    for k in {*CLI_TRAIN_LAUNCHES, *CLI_EVAL_LAUNCHES}}
        log(f"phase 12 CLI --distributed (WORLD_SIZE=1, NCCL, {sharded}): "
            f"step {state.step}, {wall:.1f} s in all; eval {results}; launches {counts}; checkpoint "
            f"optimizer state whole: {whole} ({len(ckpt['optimizer']['state'])} tensors) [{card}]")
        del state, ckpt
        gc.collect()
        torch.cuda.empty_cache()
        if counts != expected or not whole or sharded != "ZeroRedundancyOptimizer":
            raise AssertionError(f"phase 12 (c): launches {counts} (expected {expected}), whole {whole}")
        if not (results and all(math.isfinite(v) for v in results.values())):
            raise AssertionError(f"phase 12 (c): eval {results}")
        ins = argv.index("--output")
        argv2 = argv[:ins] + ["--output", str(Path(tmp) / "eval"), "--eval-only", "--init-from",
                              str(out / "model_best.pth")] + argv[ins + 2:]
        reset_counts()
        again = cli_main(argv2)
        counts = launch_counts()
        log(f"phase 12 CLI --eval-only --init-from model_best.pth (one process, no group): eval "
            f"{again}; launches {counts} [{card}]")
        torch.cuda.empty_cache()
        if counts != CLI_EVAL_LAUNCHES or {k: float(again[k]) for k in results} != results:
            raise AssertionError(f"phase 12 (c): --eval-only gave {again}, the run's eval {results}")


# ------------------------------------------------------------------ phase 13
# the model variants of ROADMAP §A3 in two step groups (MADMConfig fields,
# TrainConfig fields), as tests/test_torch_variant_step_*.py group them
SELECT = (3, 7, 12, 20, 26, 33, 41, 48, 55, 63, 76)  # the concat slot's 11 prompt tokens
CAPTURE_UP = dict(attention_features_res=(16, 32), attention_features_location=("up",))
VARIANT_GROUPS = {
    "attention": (dict(CAPTURE_UP, concat_attention_to_conv_seg=True, attention_select_index=SELECT),
                  dict(fd_attention=0.5, target_attention_loss=True)),
    "structure": (dict(sem_seg_head_sec_modal=True, mask_diff="rgb=0_Depth=1", input_channel_plus=1,
                       concat_pixel_shuffle=True, multi_layer_prompt=True, head_fusion="isa",
                       final_fuse_vae_decoder_feat=True), {}),
}
VARIANT_LOSSES = {"attention": ("feature_distance_loss", "target_attention_loss"), "structure": (),
                  "isa": ()}
# the UNet's 16 cross-attentions in pass order, (location, res at the 512 naming)
CROSS_ATTENTIONS = (tuple(("down", 64 >> b) for b in range(3) for _ in range(2)) + (("mid", 8),)
                    + tuple(("up", 8 << b) for b in range(1, 4) for _ in range(3)))
# the eval heads of phase 13 (c): the variants the kernels do not serve
# ('none'), and the second head in the kernel heads
EVAL_VARIANTS = {"isa": dict(head_fusion="isa"), "conv": dict(head_fusion="conv"),
                 "sep_conv": dict(head_fusion="sep_conv"), "final_fuse": dict(final_fuse_vae_decoder_feat=True),
                 "concat": dict(CAPTURE_UP, concat_attention_to_conv_seg=True, attention_select_index=SELECT)}


def captured(cfg):
    """Which of the 16 cross-attentions a capture pass of ``cfg`` captures."""
    return [loc in cfg.attention_features_location and res in cfg.attention_features_res
            for loc, res in CROSS_ATTENTIONS]


def variant_launches(cfg, tc):
    """K1 and K3 launches of one step with attention capture
    (``derived_launches`` for its passes): a capture pass runs its c
    captured cross-attentions in plain torch, so it launches c fewer K1 and,
    under a gradient, c fewer K3.  The teacher captures under
    target_attention_loss or the concat slot, the source under fd_attention
    or the slot, the mixed pass under the slot; fd_attention's baseline pass
    (no decoder) captures; target_attention_loss adds a student pass without
    the decoder whose loss reads the maps alone, so K3 runs for the
    attentions before the last captured one (every attn1 up to its block,
    and the uncaptured attn2 before it)."""
    base = derived_launches(tc)
    cap = captured(cfg)
    c, concat = sum(cap), cfg.concat_attention_to_conv_seg
    k1 = base["K1"] - c * (bool(tc.target_attention_loss or concat) + bool(tc.fd_attention or concat) + concat)
    k3 = base["K3"] - c * (bool(tc.fd_attention or concat) + concat)
    if tc.fd_attention and not tc.fd:
        k1 += 33 - c
    if tc.target_attention_loss:
        last = max(i for i, x in enumerate(cap) if x)
        k1 += 33 - c
        k3 += (last + 1) + sum(not x for x in cap[:last])
    return {"K1": k1, "K3": k3}


def check_variant_toy():
    """Phase 13 (a): one toy fp32 step of each variant group, CUDA against
    CPU at phase 6's tolerances on phase 6's weights (``init_random_``,
    conv_seg unscaled), launches as derived.  With phase 11's conv_seg x40
    the 'structure' step is too ill-conditioned for fp32 to meet them on
    either side: on the CPU its fp32 gradient sits 1.16e-3 of the largest
    entry from fp64 (ISA's key projection, a ReLU near 0 on 16 tokens),
    grad_norm 1.4e-4 relative; unscaled, 2.7e-4 and 8e-6."""
    check_toy_groups("13", VARIANT_GROUPS, VARIANT_LOSSES, variant_launches,
                     lambda cfg, device, gen: init_random_(MADM(cfg, device=device, trainable=True), gen))


def check_round_trip(state):
    """A full-width model of the variants through the released layout
    (``reference_state_dict`` -> ``convert_madm_pth`` -> ``merge_into_model``
    into a fresh model) and through its own state dict: every tensor back
    equal."""
    model = state.model
    converted = convert_madm_pth(reference_state_dict(model))
    fresh = MADM(model.cfg, device="cuda", trainable=True)
    merge_into_model(fresh, converted)
    own, back = model.state_dict(), fresh.state_dict()
    bad = [k for k in converted if not torch.equal(own[k], back[k])]
    buf = io.BytesIO()
    torch.save(own, buf)
    buf.seek(0)
    fresh.load_state_dict(torch.load(buf, weights_only=True, map_location="cuda"))
    back = fresh.state_dict()
    bad += [k for k in own if not torch.equal(own[k], back[k])]
    trees = sorted({k.split(".")[0] for k in converted})
    log(f"phase 13 checkpoint round trip ({model.cfg.head_fusion} head, second head "
        f"{model.cfg.sem_seg_head_sec_modal}, tower {model.cfg.concat_pixel_shuffle}, per-layer prompts "
        f"{model.cfg.multi_layer_prompt}): {len(converted)} released-layout tensors of {trees} and "
        f"{len(own)} state-dict tensors back equal: {not bad}")
    if bad:
        raise AssertionError(f"phase 13 round trip changed {bad[:10]}")
    del fresh


def run_variant_full(card):
    """Phase 13 (b): each group at full width in bf16, B=1 ('structure' at
    B=2 too), then ISA alone at B=1 and B=2 (the head fuses at 512x512:
    the global relation's [64 B, 4096, 4096] fp32 similarities), each with
    ``run_ablation_full``'s checks and launches as derived; each group's
    model round-trips its checkpoints."""
    rows = {}
    for name, (model_kw, tc_kw) in VARIANT_GROUPS.items():
        rows[name, 1] = run_group_full("13", name, model_kw, tc_kw, VARIANT_LOSSES[name], variant_launches,
                                       card, keep=check_round_trip)
    rows["structure", 2] = run_group_full("13", "structure", *VARIANT_GROUPS["structure"], (),
                                          variant_launches, card, batch=2)
    for b in (1, 2):
        rows["isa", b] = run_group_full("13", "isa", dict(head_fusion="isa"), {}, (), variant_launches, card,
                                        batch=b)
    return rows


def run_variant_eval(card):
    """Phase 13 (c): full-width bf16 eval passes at B=1 and B=2 of the head
    variants ('none': the module head; the concat slot's pass captures) and
    of the second head in 'aspp' (K2) and 'full' (K6, K7) on its own
    weights: ids in range, launches, ms/crop; the second head's kernel ids
    equal its module head's on >= 99% of pixels (bf16 near-ties) and not
    the first head's."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    images = {b: torch.rand(b, 512, 512, 3, device="cuda", generator=gen) for b in (1, 2)}
    models = dict(EVAL_VARIANTS, sec=dict(sem_seg_head_sec_modal=True))
    rows = {}
    for name, kw in models.items():
        cfg = MADMConfig(**kw)
        model = init_random_(MADM(cfg, device="cuda"), torch.Generator(device="cuda").manual_seed(SEED))
        if name == "sec":  # the second head's own weights
            sec_gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
            with torch.no_grad():
                w = model.sem_seg_head_sec_modal.conv_seg.weight
                w.copy_(torch.randn(w.shape, device="cuda", generator=sec_gen).to(w.dtype) * 0.01)
        c = sum(captured(cfg)) if cfg.concat_attention_to_conv_seg else 0
        for mode in (("aspp", "full") if name == "sec" else ("none",)):
            expected = {"none": {"K1": 34 - c}, "aspp": {"K1": 34, "K2": 1},
                        "full": {"K1": 34, "K6": 3, "K7": 1}}[mode]
            for b, x in images.items():
                model.eval_forward_ids(x, eval_head=mode)  # warm-up
                torch.cuda.synchronize()
                reset_counts()
                ids = model.eval_forward_ids(x, eval_head=mode)
                torch.cuda.synchronize()
                launches = launch_counts()
                check_ids(ids, (b, 512, 512), cfg.num_classes)
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(lambda: model.eval_forward_ids(x, eval_head=mode), reps=3, warmup=0)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                extra = ""
                if name == "sec":
                    with torch.no_grad():
                        feats = model.backbone_forward(x)["output_features"]
                        own = argmax_classes(model.sem_seg_head_sec_modal(feats))
                        first = argmax_classes(model.sem_seg_head(feats))
                    agree, other = ((ids == own).double().mean().item(), (ids == first).double().mean().item())
                    extra = (f"; ids equal the second head's module argmax on {agree:.4f} of pixels, the "
                             f"first head's on {other:.4f}")
                    if agree < 0.99 or other > 0.99:
                        raise AssertionError(f"phase 13 second head '{mode}' B={b}: agree {agree}, first {other}")
                rows[name, mode, b] = dict(ms_per_crop=ms / b, launches=launches, peak_gib=peak)
                log(f"phase 13 full-width eval '{name}' '{mode}' B={b}: launches {launches} (expected "
                    f"{expected}); {ms / b:.2f} ms/crop ({ms:.2f} ms/pass), peak memory {peak:.2f} GiB"
                    f"{extra} [{card}]")
                if launches != expected:
                    raise AssertionError(f"phase 13 eval '{name}' '{mode}' B={b} launched {launches}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def check_capture_layers(gen):
    """Phase 13 (d): a captured cross-attention layer (explicit fp32 softmax,
    no kernel) against the same layer through K1, bf16, at each captured
    shape: Sq 1024 (D 80) and 256 (D 160), Sk 77, 8 heads; within K1's
    2^-7 x max(1, max|ref|), its probabilities summing to 1, and no K1
    launch; ms of both."""
    from madm_torch.models.sd.layers import Attention

    for sq, d in ((1024, 80), (256, 160)):
        layer = Attention(8 * d, 8, d, context_dim=768).to("cuda", torch.bfloat16)
        x = torch.randn(1, sq, 8 * d, device="cuda", generator=gen).bfloat16()
        ctx = torch.randn(1, 77, 768, device="cuda", generator=gen).bfloat16()
        with torch.no_grad():
            ref = layer(x, ctx)
            probs = []
            reset_counts()
            out = layer(x, ctx, probs)
            torch.cuda.synchronize()
            launches = launch_counts()
            ms = cuda_ms(lambda: layer(x, ctx, []))
            k1_ms = cuda_ms(lambda: layer(x, ctx))
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2.0 ** -7 * max(1.0, ref.float().abs().max().item())
        sums = (probs[0].sum(-1) - 1).abs().max().item()
        log(f"phase 13 captured attn2 [B,Sq,Sk,H,D]=[1,{sq},77,8,{d}]: max_abs_err={err:.3e} against K1 "
            f"(tol {tol:.3e}); probabilities [1,{sq},77] sum to 1 within {sums:.1e}; launches {launches}; "
            f"layer ms captured {ms:.4f}, through K1 {k1_ms:.4f}")
        if not (err <= tol and sums <= 1e-5 and not launches):
            raise AssertionError(f"phase 13 captured layer at Sq={sq}: err {err}, sums {sums}, {launches}")


def run_slide_training(card):
    """Phase 13 (e): one slide_training step at [1, 512, 1024, 3] (decoder
    losses off, as the step requires): every pass takes the sliding window
    of 3 crops a pass at B=1, so K1 3 x 3 x 34 (teacher, source, mixed, each
    with the s0 decoder) and K3 2 x 3 x 32, after a warm-up step; ms, peak
    memory, finite losses."""
    cfg = MADMConfig(slide_training=True)
    tc = TrainConfig(vae_decoder_loss="", reg_uncertain=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    state = make_train_state(ablation_model(cfg, "cuda", gen), tc)
    batches = synthetic_batches(1, (512, 1024), cfg.num_classes, gen)
    train(state, batches, steps=1, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    m = train(state, batches, steps=1, generator=gen)[0]
    end.record()
    end.synchronize()
    launches = launch_counts()
    n = len(state.model.slide_windows(512, 1024))
    expected = {"K1": 3 * n * 34, "K3": 2 * n * 32}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"phase 13 slide_training step [1,512,1024,3] ({n} windows a pass): {start.elapsed_time(end):.1f} ms, "
        f"peak memory {peak:.2f} GiB; launches {launches} (derived {expected}); "
        + " ".join(f"{k}={v:.5f}" for k, v in m.items() if k != "step_ms") + f" [{card}]")
    if launches != expected or not all(math.isfinite(v) for v in m.values()):
        raise AssertionError(f"phase 13 slide_training: launches {launches}, metrics {m}")
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 1
    _no_tf32()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    t_phase = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        log(f"phase {name}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    log(f"build: {kernels.build():.1f} s for {', '.join(kernels.KERNELS)} "
        f"(sm_90a, {kernels.BUILD_DIR})")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    report_builds(torch.randn(1, 4096, 8, 40, device="cuda", generator=gen).bfloat16())
    flash_rows = check_flash(gen)
    bwd_rows = check_flash_bwd(gen)
    log(f"K1 at B=1: {sum(r['ms'] * r['per_pass'] for r in flash_rows if r['shape'][0] == 1):.4f} ms a "
        f"pass over its 34 calls; K3 at B=1: "
        f"{sum(r['ms'] * r['per_step'] for r in bwd_rows if r['shape'][0] == 1):.4f} ms a step over its 64 calls")
    packed_rows = check_packed(gen)
    aspp_rows = check_aspp(gen)
    dw_rows = check_dw(gen)
    argmax_rows = check_argmax(gen)
    phase_done("2-3 (build, kernels against twins)")
    check_toy()
    phase_done("4 (toy eval, CUDA against CPU)")
    model, eval_counts = run_full(card)
    phase_done("5 (full-width eval passes)")
    run_slide_and_dataset(model, card)
    phase_done("8 (slide eval, inference_on_dataset)")
    del model
    torch.cuda.empty_cache()
    check_toy_train()
    phase_done("6 (toy train, CUDA against CPU)")
    # S=1024 packs at a 256x256 crop; a 64-wide head and B=1 keep the CPU side short
    check_toy_train(dataclasses.replace(TOY, crop_size=(256, 256), head_channels=64, flash_pack=True),
                    PACKED_TRAIN_LAUNCHES, batch=1)
    phase_done("6 (toy flash_pack train at 256x256, CUDA against CPU)")
    check_toy_bf16()
    check_toy_bf16((256, 256), True, PACKED_TRAIN_LAUNCHES)
    phase_done("6 (toy bf16 against fp32, without and with flash_pack)")
    k3_launches = run_full_train(card)["K3"]
    phase_done("7 (full-width train)")
    packed_train = run_full_train(card, flash_pack=True)
    phase_done("7 (full-width train, flash_pack)")
    gc.collect()
    torch.cuda.empty_cache()
    run_cli(card)
    phase_done("9 (the CLI)")
    gc.collect()
    torch.cuda.empty_cache()
    run_real_weights(card)
    phase_done("10 (real-weight loading)")
    gc.collect()
    torch.cuda.empty_cache()
    check_ablation_toy()
    run_ablation_full(card)
    check_flash(gen, PROMPT_CASES)
    check_flash_bwd(gen, PROMPT_CASES)
    phase_done("11 (the step's ablation branches)")
    gc.collect()
    torch.cuda.empty_cache()
    check_reducers_toy()
    run_reducers_full(card)
    phase_done("12 (a) (the optimizer reducers)")
    run_two_ranks(card)
    phase_done("12 (b) (two ranks on one card, gloo)")
    run_nccl_cli(card)
    phase_done("12 (c) (the CLI on NCCL)")
    gc.collect()
    torch.cuda.empty_cache()
    check_variant_toy()
    phase_done("13 (a) (the variant groups' toy steps, CUDA against CPU)")
    run_variant_full(card)
    phase_done("13 (b) (the variant groups at full width)")
    run_variant_eval(card)
    phase_done("13 (c) (the variant eval heads at full width)")
    check_capture_layers(gen)
    run_slide_training(card)
    phase_done("13 (d, e) (captured layers against K1, slide_training)")

    def per_pass(key):
        return sum(r[key] * r["per_pass"] for r in flash_rows if r["shape"][0] == 1)

    k1_b, k1_f = (sum(2 * (2 * sq * h * d + 2 * sk * h * d) * n for sq, sk, h, d, n in FLASH_SHAPES),
                  sum(4 * h * sq * sk * d * n for sq, sk, h, d, n in FLASH_SHAPES))
    def per_step(key):
        return sum(r[key] * r["per_step"] for r in bwd_rows if r["shape"][0] == 1)

    def dw_pass(key):  # the three B=1 512x512 calls of a 'full' pass
        return sum(r[key] for r in dw_rows if r["shape"] == [1, 512, 512, 1024])

    k3_b = sum((2 * 4 * (sq + sk) * h * d + 4 * h * sq) * 2 * n
               for sq, sk, h, d, n in FLASH_SHAPES if d <= 160)
    k3_f = sum(10 * h * sq * sk * d * 2 * n for sq, sk, h, d, n in FLASH_SHAPES if d <= 160)
    kernels_line = {"kernels": [
        {"name": "flash_attention", "route": "cuda", "source": "madm_torch/csrc/flash_attention.cu",
         "replaces": "madm_tpu/ops/flash_attention.py:34", "launches": eval_counts["aspp"]["K1"],
         "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
         "ms": per_pass("ms"), "plain_ms": per_pass("plain_ms"), "bound_ms": per_pass("bound_ms"),
         "bound_by": bound_ms(k1_b, k1_f)[1], "library_ms": per_pass("library_ms"),
         "per": "one 512x512 pass at B=1 (sum over its 34 calls)", "shapes": flash_rows},
        {"name": "aspp_fused", "route": "cuda", "source": "madm_torch/csrc/aspp_fused.cu",
         "replaces": "madm_tpu/ops/aspp.py:208", "launches": eval_counts["aspp"]["K2"],
         "max_abs_err": max(r["max_abs_err"] for r in aspp_rows),
         "ms": aspp_rows[0]["ms"], "plain_ms": aspp_rows[0]["plain_ms"],
         "bound_ms": aspp_rows[0]["bound_ms"], "bound_by": aspp_rows[0]["bound_by"],
         "library_ms": None, "per": "one 512x512 crop at B=1", "shapes": aspp_rows},
        {"name": "flash_attention_backward", "route": "cuda",
         "source": "madm_torch/csrc/flash_attention_bwd.cu",
         "replaces": "madm_tpu/ops/flash_attention.py:141", "launches": k3_launches,
         "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
         "ms": per_step("ms"), "plain_ms": per_step("plain_ms"), "bound_ms": per_step("bound_ms"),
         "bound_by": bound_ms(k3_b, k3_f)[1], "library_ms": per_step("library_ms"),
         "per": "one train step at B=1", "shapes": bwd_rows},
        {"name": "packed_attention", "route": "cuda",
         "source": "madm_torch/csrc/flash_attention_packed.cu",
         "body": "madm_torch/csrc/flash_fwd_tma.cuh (two-pass mode)",
         "replaces": "madm_tpu/ops/flash_attention.py:383", "launches": eval_counts["packed"]["K4"],
         "max_abs_err": max(r["max_abs_err"] for r in packed_rows),
         **{k: 5 * packed_rows[0][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         "bound_by": packed_rows[0]["bound_by"],
         "per": "one 512x512 flash_pack pass at B=1 (its 5 calls at [1,4096,8,40])",
         "shapes": packed_rows},
        {"name": "packed_attention_backward", "route": "cuda",
         "source": "madm_torch/csrc/flash_attention_bwd.cu",
         "fp32_body": "madm_torch/csrc/flash_attention_packed_bwd.cu",
         "replaces": "madm_tpu/ops/flash_attention.py:254", "launches": packed_train["K5"],
         "max_abs_err": max(r["bwd"]["max_abs_err"] for r in packed_rows),
         **{k: 10 * packed_rows[0]["bwd"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         "bound_by": packed_rows[0]["bwd"]["bound_by"],
         "per": "one flash_pack train step at B=1 (its 10 calls at [1,4096,8,40])"},
        {"name": "dw_branches", "route": "cuda", "source": "madm_torch/csrc/dw_branches.cu",
         "replaces": "madm_tpu/ops/aspp.py:44", "launches": eval_counts["full"]["K6"],
         "max_abs_err": max(r["max_abs_err"] for r in dw_rows),
         "ms": dw_pass("ms"), "plain_ms": dw_pass("plain_ms"), "bound_ms": dw_pass("bound_ms"),
         "bound_by": dw_rows[0]["bound_by"], "library_ms": dw_pass("library_ms"),
         "body": "chains of rows on TMA (bf16); fp32 SIMT body for the parity checks",
         "per": "one 512x512 'full' pass at B=1 (sum over its 3 calls, d = 6, 12, 18)",
         "shapes": dw_rows},
        {"name": "matmul_argmax", "route": "cuda", "source": "madm_torch/csrc/matmul_argmax.cu",
         "replaces": "madm_tpu/ops/aspp.py:503", "launches": eval_counts["full"]["K7"],
         **{k: argmax_rows[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "max_abs_err": max(r["max_abs_err"] for r in argmax_rows),
         "per": "one 512x512 'argmax' or 'full' pass at B=1", "shapes": argmax_rows},
    ]}
    log(card)
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
