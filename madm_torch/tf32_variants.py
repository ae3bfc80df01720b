"""K1's and K3's fp32 bodies on the card beside builds of them with fewer
tf32 pieces, a control that drops delta, and the SIMT bodies: each one's
error against fp64, against its own arithmetic in plain torch, and every
toy fp32 train step of ``chip_smoke.py`` (phases 6, 11-14) run on it.

    python -m madm_torch.tf32_variants [--out PATH] [--names kept,x1,...]
    python -m madm_torch.tf32_variants --times [--out PATH]
    python -m madm_torch.tf32_variants --turns [--out PATH]
    python -m madm_torch.tf32_variants --reread RUN.json [--seeds N] [--out PATH]

Run from the repository's root (it imports ``chip_smoke``).  The variants
are builds of ``csrc/flash_attention.cu`` (K1's, ``EDITS``: lines of
``flash_fwd_tf32.cuh`` replaced) or ``csrc/flash_attention_bwd.cu`` (K3's,
``BWD_EDITS``: lines of ``flash_bwd_tf32.cuh``) from copies of ``csrc/`` in
a temporary directory (an edit whose line is not in the source once
raises), one nvcc a variant, all started together:

  kept      both bodies as they are
  s2        K1: q and k in two pieces everywhere (a score: 3 tf32 products, not 6)
  p2        K1: P in two pieces (a P V term: 3 products, not 5)
  x3        K1: s2 and p2: three tf32 products for each fp32 one everywhere
  pvsum     K1: P V's k-steps of a key tile summed in one accumulator
  x1        K1: x3 with every lo piece zero: one tf32 product for each fp32
            one, a control that ``chip_smoke.py``'s TF32X3_TOL must refuse
  simt      K1 on the kept library with q, k and v handed over as copies
            one element past an aligned base (what TMA cannot address)
  k3_x1     K3: every lo piece zero (the prep kernel's and the registers'),
            a control that TF32X3_BWD_TOL must refuse
  k3_delta  K3: delta dropped (dS = P dP), a gross error every toy check
            must refuse
  k3_simt   K3: its plan names SIMT for every fp32 call
  k3_notrans  K3: the prep kernel writes no transposed copies (its
            gradients are wrong: a timing control, for ``--times`` only)

For every FLASH_SHAPES shape at B=1 (seeded normal inputs): K1's variants'
largest error of o and lse against fp64 and against
``attention_tf32x3_reference``, and ms a call; K3's variants' largest
error of dq, dk and dv (of max(1, max|ref|)) against fp64 and against
``attention_backward_tf32x3_reference``, and ms a call.  Then, with each
variant in place, every toy check, CUDA against CPU: whether it passed and
its readings against their yardsticks (``chip_smoke.TOY_READINGS``).
Between the two, the fp32 bodies still on the CUDA cores (K2, K4-K7) are
timed at their paths' shapes (``simt_bodies``).

``--times`` instead profiles K3's fp32 kernels one by one, kept and
``k3_notrans``, at every train shape (``k3_kernel_times``): what the prep
kernel's transposed copies cost, beside the least that transposing the
tiles in the main kernels' shared memory would cost in their place.

``--turns`` instead times the full-width fp32 train step at B=1
(``chip_smoke.fp32_train_state``) in turns with K3's kept body and
``k3_simt``: 3xTF32, SIMT, SIMT, 3xTF32 after a warm-up (``step_in_turns``).

Prints one JSON object (with the card's name and power limit) and writes it
to ``--out``.  Needs a GPU, but for ``--reread``: on the CPU, it holds the
toy checks' readings of an earlier run's JSON to ``chip_smoke.limits_of``
as it stands, from the nudged spreads the run recorded and, with
``--seeds N``, from every choice of m of N seeds' spreads computed here
(``reread``): whether a verdict hangs on which seeds the check draws.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import itertools
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from . import kernels
from .device import card_line
from .ops import flash_attention as fa

_S3 = "static constexpr bool S3 = !SPLITD && DN <= 80;"
_P3 = "static constexpr bool P3 = !SPLITD;"
_PV = "constexpr bool PV_STEP = !SPLITD && DVW <= 80;"
_LO = "lo = make_float4(tf32_rn(x.x - hi.x), tf32_rn(x.y - hi.y), tf32_rn(x.z - hi.z), tf32_rn(x.w - hi.w));"
_PL = "pl[kk][e] = __float_as_uint(tf32_rn(p[e] - hi));"
EDITS = {  # K1's variants: lines of flash_fwd_tf32.cuh
    "kept": [],
    "s2": [(_S3, "static constexpr bool S3 = false;")],
    "p2": [(_P3, "static constexpr bool P3 = false;")],
    "x3": [(_S3, "static constexpr bool S3 = false;"), (_P3, "static constexpr bool P3 = false;")],
    "pvsum": [(_PV, "constexpr bool PV_STEP = false;")],
    "x1": [(_S3, "static constexpr bool S3 = false;"), (_P3, "static constexpr bool P3 = false;"),
           (_LO, "lo = make_float4(0.f, 0.f, 0.f, 0.f);"), (_PL, "pl[kk][e] = 0u;")],
}
BWD_EDITS = {  # K3's variants: lines of flash_bwd_tf32.cuh
    "k3_x1": [("lo[i] = tf32_rn(x - h);", "lo[i] = 0.f;"),
              ("xl[kk][e] = __float_as_uint(tf32_rn(v4[e] - h));", "xl[kk][e] = 0u;")],
    "k3_delta": [("w.delta[row] = acc;", "w.delta[row] = 0.f;")],
    "k3_simt": [("p.tma = addressable && d >= 1 && d <= kMaxD && d % 4 == 0;", "p.tma = false;")],
    "k3_notrans": [("if (trans != nullptr) {", "if (false) {")],
}
CHECKED = [*EDITS, "simt", *(n for n in BWD_EDITS if n != "k3_notrans")]  # the builds read for accuracy
# each edited header and the library whose source includes it
_TARGETS = {"flash_fwd_tf32.cuh": "flash_attention", "flash_bwd_tf32.cuh": "flash_attention_bwd"}


def edited(header: str, edits) -> str:
    """``csrc/<header>`` with ``edits`` made; raises unless each line stands
    in it once."""
    text = (kernels.CSRC / header).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{header}: the line to edit is not in it once: {old}")
        text = text.replace(old, new)
    return text


def build_variants(tmp: Path, names) -> dict:
    """{variant: (library name, its built library)} for the variants
    ``names`` that edit a source, built under ``tmp``."""
    jobs = {}
    for name in names:
        header = "flash_bwd_tf32.cuh" if name in BWD_EDITS else "flash_fwd_tf32.cuh"
        edits = BWD_EDITS.get(name, EDITS.get(name))
        if not edits:
            continue
        d = tmp / name
        shutil.copytree(kernels.CSRC, d)
        (d / header).write_text(edited(header, edits))
        lib = _TARGETS[header]
        jobs[name] = (lib, subprocess.Popen([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", str(d / "lib.so"),
                                             str(d / f"{lib}.cu")],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        cdll = ctypes.CDLL(str(tmp / name / "lib.so"))
        cdll.madm_error_string.argtypes = [ctypes.c_int]
        cdll.madm_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, cdll)
    return libs


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return buf.copy_(t)


@contextlib.contextmanager
def variant(libs: dict, name: str):
    """The variant ``name``'s library in its kernel's place while the context
    lasts (``simt``: K1 on the kept one, every call on misaligned copies)."""
    forward = fa.flash_attention_forward
    lib, cdll = libs.get(name, (None, None))
    kept = {n: kernels.load(n) for n in _TARGETS.values()}
    if cdll is not None:
        kernels._loaded[lib] = cdll
    if name == "simt":
        fa.flash_attention_forward = lambda q, k, v, *a, **kw: forward(_misaligned(q), _misaligned(k),
                                                                       _misaligned(v), *a, **kw)
    try:
        yield
    finally:
        fa.flash_attention_forward = forward
        kernels._loaded.update(kept)


def _fp64_backward(q, k, v, g, scale):
    q, k, v, g = (t.double() for t in (q, k, v, g))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, -1)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale, torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale,
            torch.einsum("bhqk,bqhd->bkhd", p, g))


def _of_max(got, ref):
    return (got.double() - ref.double()).abs().max().item() / max(1.0, ref.abs().max().item())


def accuracy(cs, libs: dict, names, gen: torch.Generator) -> list:
    """Each FLASH_SHAPES shape at B=1: K1's variants' errors and ms, and (D
    <= 160) K3's variants' errors and ms."""
    rows = []
    fwd_names = [n for n in names if n not in BWD_EDITS]
    bwd_names = ["kept", *(n for n in names if n in BWD_EDITS)]
    for sq, sk, h, d, _ in cs.FLASH_SHAPES:
        q, k, v = (torch.randn(1, s, h, d, device="cuda", generator=gen) for s in (sq, sk, sk))
        scale = d ** -0.5
        s64 = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
        o64 = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s64, -1), v.double())
        l64 = torch.logsumexp(s64, -1)
        del s64
        plan = fa.forward_plan(1, sq, sk, h, d, torch.float32, [(t.data_ptr(), t.stride()[:3]) for t in (q, k, v)])
        o3, l3 = fa.attention_tf32x3_reference(q, k, v, scale, plan.bk, plan.nsplit)
        row = {"shape": [1, sq, sk, h, d]}
        for name in fwd_names:
            with variant(libs, name):
                o, lse = fa.flash_attention_forward(q, k, v, scale)
                ms = cs.cuda_ms(lambda: fa.flash_attention_forward(q, k, v, scale, False))
            row[name] = {"err_fp64": _of_max(o, o64), "lse_err_fp64": (lse.double() - l64).abs().max().item(),
                         "err_tf32x3": _of_max(o, o3), "lse_err_tf32x3": (lse - l3).abs().max().item(), "ms": ms}
        del o64, l64, o3, l3
        if d <= fa.MAX_BWD_HEAD_DIM:
            g = torch.randn(1, sq, h, d, device="cuda", generator=gen)
            o, lse = fa.flash_attention_forward(q, k, v, scale)
            bplan = fa.backward_plan(1, sq, sk, h, d, torch.float32)
            ref3 = fa.attention_backward_tf32x3_reference(q, k, v, o, g, lse, scale, bplan.bq, bplan.bk_dq,
                                                          bplan.nsplit)
            ref64 = _fp64_backward(q, k, v, g, scale)
            row["bwd"] = {}
            for name in bwd_names:
                with variant(libs, name):
                    grads = fa.flash_attention_backward(q, k, v, o, g, lse, scale)
                    ms = cs.cuda_ms(lambda: fa.flash_attention_backward(q, k, v, o, g, lse, scale))
                row["bwd"][name] = {"err_fp64": [_of_max(x, r) for x, r in zip(grads, ref64)],
                                    "err_tf32x3": [_of_max(x, r) for x, r in zip(grads, ref3)], "ms": ms}
            del g, o, lse, ref3, ref64, grads
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def toy_checks(cs) -> dict:
    """Every toy fp32 train-step check of ``chip_smoke.py``, by name."""
    checks = {"6 toy": cs.check_toy_train,
              "6 flash_pack": lambda: cs.check_toy_train(cs.TOY_PACK, cs.PACKED_TRAIN_LAUNCHES, batch=1),
              "6 unet": cs.check_toy_unet}
    checks.update({f"11 {n}": (lambda n=n: cs.check_toy_groups(
        "11", {n: cs.ABLATION_GROUPS[n]}, cs.ABLATION_LOSSES, lambda cfg, tc: cs.derived_launches(tc),
        cs.ablation_model)) for n in cs.ABLATION_GROUPS})
    checks["12 reducers"] = cs.check_reducers_toy
    checks.update({f"13 {n}": (lambda n=n: cs.check_toy_groups(
        "13", {n: cs.VARIANT_GROUPS[n]}, cs.VARIANT_LOSSES, cs.variant_launches, cs.variant_model))
        for n in cs.VARIANT_GROUPS})
    checks["14 clip"] = lambda: cs.check_toy_train(cs.TOY_CLIP_TRAIN)
    return checks


def _run(cs, check) -> dict:
    """``check()``: {"pass", the readings it took (``TOY_READINGS``), the
    error where it raised}."""
    cs.TOY_READINGS.clear()
    err = None
    try:
        check()
    except AssertionError as e:
        err = str(e)
    return {"pass": err is None, "readings": list(cs.TOY_READINGS), "error": err}


def toy_steps(cs, libs: dict, names) -> dict:
    """Each variant in place: every toy check, CUDA against CPU (the CPU
    sides are computed once, for the first variant)."""
    checks = toy_checks(cs)
    out = {}
    for name in names:
        with variant(libs, name):
            out[name] = {check: _run(cs, fn) for check, fn in checks.items()}
        print(json.dumps({name: out[name]}), flush=True)
    return out


def simt_bodies(cs, gen: torch.Generator) -> list:
    """The fp32 bodies still on the CUDA cores, at their paths' full-width
    shapes (B=1): K4 and K5 at the packed self-attention [1, 4096, 8, 40]
    (SDPA forward and backward in fp32, TF32 off, beside them), K2 at the
    'aspp' head's 512x512 concat of four 256-channel embeds, K6 at the
    'full' head's one call a dilation (6, 12, 18) over the 1024-channel
    concat (cuDNN's fp32 grouped conv beside it), K7 at conv_seg (256 ->
    11): ms, twin ms, the library's ms where one call computes the same
    function, and the bound at 67 TFLOP/s fp32 (what the CUDA cores do)."""
    from torch.nn import functional as F

    from .ops import aspp

    rows = []

    def row(name, fn, plain, nbytes, flops, launches, lib=None):
        ms, plain_ms = cs.cuda_ms(fn), cs.cuda_ms(plain, reps=3, warmup=1)
        bnd, by = cs.bound_ms(nbytes, flops, cs.FP32_FLOP_PER_S)
        r = dict(kernel=name, ms=ms, plain_ms=plain_ms, library_ms=None if lib is None else cs.cuda_ms(lib),
                 bound_ms=bnd, bound_by=by, launches=launches)
        print(json.dumps(r), flush=True)
        rows.append(r)

    b, s, h, d = 1, 4096, 8, 40
    g = fa.pack_group(s, s, d, True)  # 3 heads a block at D=40, as the flash_pack pass takes them
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen) for _ in range(4))
    scale, n = d ** -0.5, b * s * h * d
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    row("K4 fp32 [1,4096,8,40]", lambda: fa.packed_attention_forward(q, k, v, scale, g),
        lambda: fa.packed_attention_reference(q, k, v, scale), 4 * 4 * n, 4 * b * h * s * s * d,
        "5 / fp32 flash_pack pass", lambda: F.scaled_dot_product_attention(qt, kt, vt))
    row("K5 fp32 [1,4096,8,40]", lambda: fa.packed_attention_backward(q, k, v, do, scale, g),
        lambda: fa.packed_attention_backward_reference(q, k, v, do, scale), 4 * 7 * n, 10 * b * h * s * s * d,
        "10 / fp32 flash_pack step",
        lambda: torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    del q, k, v, do, qt, kt, vt, out
    embeds, args = cs.aspp_inputs(gen, 1, 512, 512)
    embeds, args = [e.float() for e in embeds], [a.float() for a in args]
    pix = 512 * 512
    row("K2 fp32 [1,512,512,1024]", lambda: aspp.aspp_fused(embeds, *args),
        lambda: aspp.aspp_fused_reference(embeds, *args),
        4 * (4 * pix * 256 + pix * 1024 + 4 * 1024 * 256 + 3 * 9 * 1024 + 6 * 1024 + 8 * 256),
        (3 * 9 * 2 + 4 * 2 * 256) * pix * 1024, "1 / fp32 'aspp' pass")
    del embeds, args
    x = torch.randn(1, 512, 512, 1024, device="cuda", generator=gen)
    taps, sc, bias = cs.dw_params(gen, 1024, 1)
    xc, wc = x.permute(0, 3, 1, 2).contiguous(), taps[0].permute(2, 0, 1)[:, None].contiguous()
    row("K6 fp32 [1,512,512,1024] d=6", lambda: aspp.dw_branches([x], taps, sc, bias, (6,)),
        lambda: aspp.dw_branches_reference([x], taps, sc, bias, (6,)), 4 * 2 * x.numel(), 18 * x.numel(),
        "3 / fp32 'full' pass", lambda: F.conv2d(xc, wc, padding=6, dilation=6, groups=1024))
    del x, xc
    x = torch.randn(1, 512, 512, 256, device="cuda", generator=gen)
    wt = torch.randn(256, 11, device="cuda", generator=gen) / 16
    bias = torch.randn(11, device="cuda", generator=gen) * 0.1
    row("K7 fp32 [1,512,512,256,11]", lambda: aspp.matmul_argmax(x, wt, bias),
        lambda: aspp.matmul_argmax_reference(x, wt, bias), 4 * x.numel() + 4 * (256 * 11 + 11) + 4 * pix,
        2 * 256 * 11 * pix, "1 / fp32 'argmax' or 'full' pass")
    return rows


def _max_sm_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0]) * 1e6


def k3_kernel_times(cs, libs: dict, gen: torch.Generator) -> list:
    """Where K3's fp32 body spends a call, at every train shape at B=1: the
    device time of each of its kernels (the prep kernel, the dK/dV kernel,
    the split's reduction, the dQ kernel), mean of 5 calls from
    ``torch.profiler``, kept and without the prep kernel's transposed copies
    (``k3_notrans``).  Beside them, the least time in which the main kernels
    could transpose their tiles in shared memory instead: every dK/dV block
    reads all its queries' q and dO and every dQ block all keys' k, so each
    element of q and dO would be transposed once a key block and each of k
    once a query block; one fp32 word read and written (8 bytes) an element,
    at 128 bytes a clock an SM at the card's top clock."""
    from torch.profiler import ProfilerActivity, profile

    # the kernels' names, demangled (bwd_tf32_kernel<0, ...>) or not (bwd_tf32_kernelILi0E...)
    names = {"bwd_tf32_prep": "prep", "bwd_tf32_reduce": "reduce", "bwd_tf32_kernel<0": "dkdv",
             "bwd_tf32_kernelILi0E": "dkdv", "bwd_tf32_kernel<1": "dq", "bwd_tf32_kernelILi1E": "dq"}
    smem_rate = 128 * fa.SM_COUNT * _max_sm_hz()
    rows = []
    for sq, sk, h, d, _ in cs.FLASH_SHAPES:
        if d > fa.MAX_BWD_HEAD_DIM:
            continue
        q, k, v, g = (torch.randn(1, s, h, d, device="cuda", generator=gen) for s in (sq, sk, sk, sq))
        o, lse = fa.flash_attention_forward(q, k, v, d ** -0.5)
        moved = 8 * h * d * (-(-sk // 64) * 2 * sq + -(-sq // 64) * sk)
        row = {"shape": [1, sq, sk, h, d], "smem_transpose_floor_ms": moved / smem_rate * 1e3}
        for name in ("kept", "k3_notrans"):
            with variant(libs, name):
                for _ in range(2):
                    fa.flash_attention_backward(q, k, v, o, g, lse, d ** -0.5)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        fa.flash_attention_backward(q, k, v, o, g, lse, d ** -0.5)
                    torch.cuda.synchronize()
            ms = {}
            for ev in prof.key_averages():
                key = next((n for m, n in names.items() if m in ev.key), None)
                if key is not None:
                    ms[key] = ms.get(key, 0.0) + ev.device_time_total / 1e3 / 5
            row[name] = ms
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, g, o, lse
    return rows


def step_in_turns(cs, libs: dict) -> list:
    """The full-width fp32 train step at B=1 after a warm-up, in turns with
    K3's kept body and ``k3_simt``: each step's body by K3's counters, ms,
    peak memory and losses."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 43)
    state = cs.fp32_train_state()
    batches = cs.synthetic_batches(1, state.model.cfg.crop_size, state.model.cfg.num_classes, gen)
    cs.train(state, batches, steps=1, generator=gen)  # warm-up
    turns = []
    for name, body in (("kept", "tma_tf32x3"), ("k3_simt", "simt"), ("k3_simt", "simt"), ("kept", "tma_tf32x3")):
        with variant(libs, name):
            r = cs.fp32_step(state, batches, gen)
        if r["bodies"]["K3"] != {body: cs.TRAIN_LAUNCHES["K3"]}:
            raise AssertionError(f"step in turns: K3 bodies {r['bodies']['K3']}, wanted {body}")
        turns.append(dict(body=body, ms=r["ms"], peak_gib=r["peak_gib"], metrics=r["metrics"]))
        print(json.dumps(turns[-1]), flush=True)
    return turns


def check_spreads(cs, sides: dict) -> dict:
    """{a toy check's reading as ``chip_smoke.hold`` names it: its nudged
    readings} from the CPU sides ``sides`` (keyed as ``cpu_side`` keys
    them; a toy train step's halves joined in order)."""
    cfgs = {repr(c): c for c in (cs.TOY, cs.TOY_PACK, cs.TOY_CLIP_TRAIN)}
    out = {}
    for (kind, *rest), side in sorted(sides.items(), key=lambda kv: repr(kv[0])):
        if kind == "train":
            cfg = cfgs[rest[0]]
            for t, st in enumerate(side["steps"]):
                name = f"6 toy {cfg.crop_size} flash_pack={cfg.flash_pack} clip={cfg.clip_state} step {t}"
                out[name] = out.get(name, []) + st["spreads"]
        elif kind == "unet":
            out["6 unet"] = side["spreads"]
        elif kind == "group":
            out[" ".join(rest)] = side["spreads"]
        elif kind == "reducer spreads":
            out.update({f"12 {n}": side for n in cs.REDUCERS})
    return out


def _ratio(cs, got: dict, spreads: list) -> float:
    """The largest of a reading's ratios to its limits from ``spreads``."""
    lim = cs.limits_of(spreads, got["modules"])
    return max(got["loss"] / lim["loss"], got["grad"] / lim["grad"],
               *(got["modules"][m] / v for m, v in lim["modules"].items()))


def _limits(cs, spreads: list, modules) -> list:
    lim = cs.limits_of(spreads, modules)
    return [lim["loss"], lim["grad"], *lim["modules"].values()]


def reread(cs, run: dict, seeds: int) -> dict:
    """Each build's toy checks in ``run`` (``toy_steps``' output) held to
    ``chip_smoke.limits_of``: the largest ratio of a reading to its limit
    from the spreads the run recorded ("recorded").  With ``seeds``, the
    CPU sides again on this machine's CPU with ``seeds`` nudge seeds (the
    first eight the smoke's), and for each number m from 2 to 8 of
    seeds a limit may draw on (the smoke draws on ``len(NUDGE_SEEDS)``):
    the smallest and largest such ratio over every m of them ("draws":
    [m, smallest, largest]), and for each reading how far its limits swing
    over those choices ("limit_swing": [m, the largest over the smallest
    limit, the worst limit]); "spreads" keeps each seed's and
    "smoke_limits" each reading's limits from the smoke's seeds (the first
    ``len(NUDGE_SEEDS)``).  A check that
    raised on a reading stays refused whatever its ratios: a check stops
    at the failing step."""
    local, drawn = None, len(cs.NUDGE_SEEDS)
    if seeds:
        cs.NUDGE_SEEDS = tuple(cs.SEED + 17 + i for i in range(seeds))
        sides = {key: cs.cpu_side(key, lambda fn=fn, args=args: fn(*args)) for key, fn, args in cs.toy_cpu_work()}
        local = check_spreads(cs, sides)
    choices = {m: list(itertools.combinations(range(seeds), m)) for m in range(2, min(seeds, 8) + 1)}
    out = {"seeds": list(cs.NUDGE_SEEDS) if seeds else None, "builds": {}}
    for build, checks in run["toy"].items():
        rows = out["builds"][build] = {}
        for check, res in checks.items():
            recorded = max(_ratio(cs, r["got"], r["spreads"]) for r in res["readings"])
            row = dict(recorded=recorded, raised=res["error"])
            if local is not None:
                row["draws"] = []
                for m, subsets in choices.items():
                    ratios = [max(_ratio(cs, r["got"], [local[r["check"]][i] for i in sub]) for r in res["readings"])
                              for sub in subsets]
                    row["draws"].append([m, min(ratios), max(ratios)])
            rows[check] = row
    if local is not None:
        readings = {r["check"]: r for res in run["toy"]["kept"].values() for r in res["readings"]}
        out["limit_swing"] = {}
        for name, r in readings.items():
            out["limit_swing"][name] = []
            for m, subsets in choices.items():
                lims = [_limits(cs, [local[name][i] for i in sub], r["got"]["modules"]) for sub in subsets]
                swing = [max(col) / min(col) for col in zip(*lims)]
                out["limit_swing"][name].append([m, max(swing), ["loss", "grad", *r["got"]["modules"]][
                    swing.index(max(swing))]])
        # this CPU's spreads of the run's seeds beside the run's
        out["spread_here_over_run"] = {
            name: {k: max(x[k] for x in local[name][:len(r["spreads"])]) / max(max(x[k] for x in r["spreads"]), 1e-30)
                   for k in ("loss", "grad")} for name, r in readings.items()}
        out["spreads"] = local
        out["smoke_limits"] = {name: cs.limits_of(local[name][:drawn], r["got"]["modules"])
                               for name, r in readings.items()}  # the smoke's seeds' limits
    return out


def on_card(cs, args) -> dict:
    """The builds' readings on the card (``--times``, ``--turns`` or the
    default ``--names``), with the card's name and power limit."""
    if not torch.cuda.is_available():
        raise SystemExit("tf32_variants needs a GPU")
    cs._no_tf32()
    names = ["k3_notrans"] if args.times else ["k3_simt"] if args.turns else args.names.split(",")
    with tempfile.TemporaryDirectory(prefix="madm_tf32_") as tmp:
        libs = build_variants(Path(tmp), names)
        kernels.build()
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        result = {"card": card_line(), "torch": torch.__version__}
        if args.times:
            result["k3_kernel_times"] = k3_kernel_times(cs, libs, gen)
        elif args.turns:
            result["fp32_step_in_turns"] = step_in_turns(cs, libs)
        else:
            cs.prefetch_cpu_sides(os.path.join(tmp, "cpu_sides.pt"), cs.toy_cpu_work())  # while the card runs
            result.update(tf32x3_tol=cs.TF32X3_TOL, tf32x3_bwd_tol=cs.TF32X3_BWD_TOL, yard_k=cs.YARD_K,
                          yard_floor=cs.YARD_FLOOR, grad_tol=cs.GRAD_TOL, shapes=accuracy(cs, libs, names, gen),
                          simt_bodies=simt_bodies(cs, gen), toy=toy_steps(cs, libs, names))
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/tf32_variants.json")
    ap.add_argument("--names", default=",".join(CHECKED))
    ap.add_argument("--times", action="store_true", help="profile K3's fp32 kernels only (k3_kernel_times)")
    ap.add_argument("--turns", action="store_true", help="the fp32 train step in turns with K3's SIMT body")
    ap.add_argument("--reread", metavar="RUN.json", help="on the CPU: hold an earlier run's toy readings again")
    ap.add_argument("--seeds", type=int, default=0, help="with --reread: nudge seeds whose every pair is read")
    args = ap.parse_args()
    import chip_smoke as cs  # the checks it holds the port to; from the repository's root

    if args.reread:
        with open(args.reread) as f:
            run = json.load(f)
        result = dict(run=args.reread, run_card=run["card"], run_torch=run["torch"], torch=torch.__version__,
                      yard_k=cs.YARD_K, yard_floor=cs.YARD_FLOOR, grad_tol=cs.GRAD_TOL,
                      **reread(cs, run, args.seeds))
    else:
        result = on_card(cs, args)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
