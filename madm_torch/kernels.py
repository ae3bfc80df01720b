"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exports a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/madm_torch/`` at the repository root, named by a hash of the source,
the shared headers ``csrc/*.cuh`` and the flags (an edited source rebuilds;
an unchanged one loads the cached library), and bound with ``ctypes``.
Nothing is built at import time.  The attention kernels encode TMA tensor
maps with libcuda's ``cuTensorMapEncodeTiled``, whose address they fetch at
run time from the CUDA runtime: no library links ``-lcuda``.
``ptxas`` reports each kernel's registers, shared memory and spills
(``-Xptxas -v``); ``build`` keeps that report in ``BUILD_LOGS``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "madm_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("flash_attention", "flash_attention_bwd", "flash_attention_packed",
           "flash_attention_packed_bwd", "aspp_fused", "dw_branches", "matmul_argmax")

_loaded: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}  # nvcc's output of each source built by this process


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels are built at first use on a machine with "
            "the CUDA toolkit"
        )
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = KERNELS) -> float:
    """Compile every listed kernel that has no up-to-date library, one
    ``nvcc`` per source, all started together.  Returns the wall seconds."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def ptxas_report(name: str, kernel_substr: str = "") -> list:
    """(kernel, registers, shared bytes, spill stores, spill loads) of each
    kernel in ``csrc/<name>.cu``'s ``-Xptxas -v`` report whose mangled name
    holds ``kernel_substr``; empty if this process did not build it."""
    rows, fn = [], None
    for line in BUILD_LOGS.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            spills = (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?", line)
        if m and fn:
            if kernel_substr in fn:
                smem = re.search(r"(\d+) bytes smem", line)
                rows.append((fn, int(m.group(1)), int(smem.group(1)) if smem else 0, *spills))
            fn = None
    return rows


def sass_counts(name: str, opcodes: Sequence[str]) -> Dict[str, int]:
    """How many SASS instructions of each opcode the built library of
    ``csrc/<name>.cu`` holds, from ``cuobjdump -sass`` (next to ``nvcc``);
    raises if the toolkit has no ``cuobjdump``."""
    tool = Path(nvcc()).with_name("cuobjdump")
    if not tool.exists():
        raise FileNotFoundError(f"no cuobjdump beside {nvcc()}")
    sass = subprocess.run([str(tool), "-sass", str(library_path(name))], check=True,
                          capture_output=True, text=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        lib.madm_error_string.argtypes = [ctypes.c_int]
        lib.madm_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a nonzero ``cudaGetLastError()``."""
    if err != 0:
        msg = lib.madm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
