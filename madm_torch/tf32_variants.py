"""K1's fp32 body on the card beside builds of it with fewer tf32 pieces,
and the SIMT body: each one's error against fp64, against its own
arithmetic in plain torch, and the toy fp32 train steps of ``chip_smoke.py``
(phases 11-13) run on it.

    python -m madm_torch.tf32_variants [--out PATH]

Run from the repository's root (it imports ``chip_smoke``).  The variants
are builds of ``csrc/flash_attention.cu`` from copies of ``csrc/`` in a
temporary directory, with lines of ``flash_fwd_tf32.cuh`` replaced
(``EDITS``; an edit whose line is not in the source raises), one nvcc a
variant, all started together:

  kept   the body as it is
  s2     q and k in two pieces everywhere (a score: 3 tf32 products, not 6)
  p2     P in two pieces (a P V term: 3 products, not 5)
  x3     s2 and p2: three tf32 products for each fp32 one everywhere
  pvsum  P V's k-steps of a key tile summed in one accumulator (not each
         in its own, added in fp32)
  x1     x3 with every lo piece zero: one tf32 product for each fp32 one, a
         control that ``chip_smoke.py``'s TF32X3_TOL check must refuse
  simt   the kept library with q, k and v handed over as copies one element
         past an aligned base (what TMA cannot address)

For every FLASH_SHAPES shape at B=1 (seeded normal q, k, v): the largest
error of o and of lse against fp64 (softmax in fp64) and against
``attention_tf32x3_reference`` (o of max(1, max|ref|), as ``chip_smoke.py``
holds it), and ms a call.  Then, with each variant in K1's place, each
group of phases 11 and 13 and phase 12's reducers, CUDA against CPU, as
``chip_smoke.py`` checks them: whether the check passed and its readings
(losses and grad_norm, gradients).

Prints one JSON object (with the card's name and power limit) and writes it
to ``--out``.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import os
import re
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
EDITS = {
    "kept": [],
    "s2": [(_S3, "static constexpr bool S3 = false;")],
    "p2": [(_P3, "static constexpr bool P3 = false;")],
    "x3": [(_S3, "static constexpr bool S3 = false;"), (_P3, "static constexpr bool P3 = false;")],
    "pvsum": [(_PV, "constexpr bool PV_STEP = false;")],
    "x1": [(_S3, "static constexpr bool S3 = false;"), (_P3, "static constexpr bool P3 = false;"),
           (_LO, "lo = make_float4(0.f, 0.f, 0.f, 0.f);"), (_PL, "pl[kk][e] = 0u;")],
}
_READING = re.compile(r"max rel err ([0-9.e+-]+).*?(?:max err|clipped gradients) ([0-9.e+-]+)")


def build_variants(tmp: Path) -> dict:
    """{variant: its library of flash_attention.cu}, built under ``tmp``."""
    src = (kernels.CSRC / "flash_fwd_tf32.cuh").read_text()
    jobs = {}
    for name, edits in EDITS.items():
        d = tmp / name
        shutil.copytree(kernels.CSRC, d)
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: the line to edit is not in the kernel once: {old}")
            text = text.replace(old, new)
        (d / "flash_fwd_tf32.cuh").write_text(text)
        jobs[name] = subprocess.Popen([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", str(d / "lib.so"),
                                       str(d / "flash_attention.cu")],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        lib = ctypes.CDLL(str(tmp / name / "lib.so"))
        lib.madm_error_string.argtypes = [ctypes.c_int]
        lib.madm_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return buf.copy_(t)


@contextlib.contextmanager
def variant(libs: dict, name: str):
    """K1 on variant ``name``'s library (``simt``: the kept one, every call
    on misaligned copies) while the context lasts."""
    forward = fa.flash_attention_forward
    kernels._loaded["flash_attention"] = libs["kept" if name == "simt" else name]
    if name == "simt":
        fa.flash_attention_forward = lambda q, k, v, *a, **kw: forward(_misaligned(q), _misaligned(k),
                                                                       _misaligned(v), *a, **kw)
    try:
        yield
    finally:
        fa.flash_attention_forward = forward
        kernels._loaded["flash_attention"] = libs["kept"]


def accuracy(cs, libs: dict, names, gen: torch.Generator) -> list:
    """Each FLASH_SHAPES shape at B=1: every variant's errors and ms."""
    rows = []
    for sq, sk, h, d, _ in cs.FLASH_SHAPES:
        q, k, v = (torch.randn(1, s, h, d, device="cuda", generator=gen) for s in (sq, sk, sk))
        scale = d ** -0.5
        s64 = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
        o64 = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s64, -1), v.double())
        l64 = torch.logsumexp(s64, -1)
        del s64
        plan = fa.forward_plan(1, sq, sk, h, d, torch.float32, [(t.data_ptr(), t.stride()[:3]) for t in (q, k, v)])
        o3, l3 = fa.attention_tf32x3_reference(q, k, v, scale, plan.bk, plan.nsplit)
        norm64, norm3 = max(1.0, o64.abs().max().item()), max(1.0, o3.abs().max().item())
        row = {"shape": [1, sq, sk, h, d]}
        for name in names:
            with variant(libs, name):
                o, lse = fa.flash_attention_forward(q, k, v, scale)
                ms = cs.cuda_ms(lambda: fa.flash_attention_forward(q, k, v, scale, False))
            row[name] = {"err_fp64": (o.double() - o64).abs().max().item() / norm64,
                         "lse_err_fp64": (lse.double() - l64).abs().max().item(),
                         "err_tf32x3": (o - o3).abs().max().item() / norm3,
                         "lse_err_tf32x3": (lse - l3).abs().max().item(), "ms": ms}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, o64, l64, o3, l3
        torch.cuda.empty_cache()
    return rows


def _run(check) -> dict:
    """``check()``'s log lines: {"pass", readings (losses and grad_norm,
    gradients) of each line, the error where it raised}."""
    buf = io.StringIO()
    err = None
    with contextlib.redirect_stdout(buf):
        try:
            check()
        except AssertionError as e:
            err = str(e)
    readings = [[float(x) for x in m.groups()] for m in map(_READING.search, buf.getvalue().splitlines()) if m]
    return {"pass": err is None, "readings": readings, "error": err}


def toy_steps(cs, libs: dict, names) -> dict:
    """Each variant in K1's place: each group of phases 11 and 13 alone and
    phase 12's reducers, CUDA against CPU."""
    variant_model = lambda cfg, device, g: cs.init_random_(cs.MADM(cfg, device=device, trainable=True), g)
    checks = {f"11 {n}": (lambda n=n: cs.check_toy_groups(
                  "11", {n: cs.ABLATION_GROUPS[n]}, cs.ABLATION_LOSSES, lambda cfg, tc: cs.derived_launches(tc),
                  cs.ablation_model)) for n in cs.ABLATION_GROUPS}
    checks.update({f"13 {n}": (lambda n=n: cs.check_toy_groups(
                       "13", {n: cs.VARIANT_GROUPS[n]}, cs.VARIANT_LOSSES, cs.variant_launches, variant_model))
                   for n in cs.VARIANT_GROUPS})
    checks["12 reducers"] = cs.check_reducers_toy
    out = {}
    for name in names:
        with variant(libs, name):
            out[name] = {check: _run(fn) for check, fn in checks.items()}
        print(json.dumps({name: out[name]}), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/tf32_variants.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tf32_variants needs a GPU")
    import chip_smoke as cs  # the checks it holds the port to; from the repository's root

    cs._no_tf32()
    kernels.build()
    names = [*EDITS, "simt"]
    with tempfile.TemporaryDirectory(prefix="madm_tf32_") as tmp:
        libs = build_variants(Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        result = {"card": card_line(), "torch": torch.__version__, "tf32x3_tol": cs.TF32X3_TOL,
                  "shapes": accuracy(cs, libs, names, gen), "toy": toy_steps(cs, libs, names)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
