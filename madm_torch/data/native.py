"""ctypes bindings and on-demand build of the native image decoder (port of
``madm_tpu/data/native.py`` over the same ``native/madm_data.cpp``).

The C++ library decodes PNG / JPEG, resamples (bilinear for images,
nearest for labels), crops and flips on the host; the dataset calls it
through ctypes and falls back to PIL where it cannot be built or loaded
(``available()``).  It is host code: no device runs it.

The library builds at first use with ``g++`` into the port's build
directory (``build/madm_torch/`` at the repository root), named by a hash
of the source and the flags as ``madm_torch/kernels.py`` names its
libraries.  The compiler writes a file of its own, which is renamed into
place under a file lock, so processes that start together build it once
and never load a half-written file.  ``native/libmadm_data.so``, the JAX
package's build of the same source, is neither read nor written.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = REPO_ROOT / "native" / "madm_data.cpp"
BUILD_DIR = REPO_ROOT / "build" / "madm_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LINK = ("-lpng", "-ljpeg", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_tried = False
error: Optional[str] = None  # why the library is unavailable, after a failed first use


def library_path() -> Path:
    """Where ``native/madm_data.cpp`` builds to, keyed by its source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((CXX,) + CXX_FLAGS + LINK).encode())
    return BUILD_DIR / f"libmadm_data-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless an up-to-date one exists; raises
    ``RuntimeError`` with the compiler's output if it fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libmadm_data.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # built by the process that held the lock before
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), *LINK, "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=300)
        except (FileNotFoundError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native decoder build failed: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native decoder build failed ({proc.returncode}):\n{proc.stderr[-2000:]}")
        os.replace(tmp, out)
    return out


def headers_found() -> bool:
    """Whether the compiler finds ``png.h`` and ``jpeglib.h``."""
    try:
        proc = subprocess.run([CXX, "-fsyntax-only", "-x", "c++", "-"], capture_output=True, text=True,
                              input="#include <png.h>\n#include <jpeglib.h>\n", timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        error = str(e)
        logger.info(f"native image decoder unavailable, PIL decodes: {error[:500]}")
        return None
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.madm_image_size.argtypes = [ctypes.c_char_p, c_int_p, c_int_p, c_int_p]
    lib.madm_image_size.restype = ctypes.c_int
    lib.madm_load.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.madm_load.restype = ctypes.c_int
    lib.madm_init_pool.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library is built and loaded (built at the first call)."""
    return _load() is not None


def decoder_name() -> str:
    """'native' or 'PIL': which decoder the datasets use."""
    return "native" if available() else "PIL"


def image_size(path: str):
    """(width, height, channels) of an image file."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native image decoder unavailable: {error}")
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.madm_image_size(path.encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c)):
        raise IOError(f"cannot decode {path}")
    return w.value, h.value, c.value


def load(path: str, resize_wh=None, crop=None, flip: bool = False, nearest: bool = False,
         out_c: int = 3) -> np.ndarray:
    """Decode -> resize to ``resize_wh`` -> crop (x, y, w, h) -> flip: HWC
    uint8 with ``out_c`` channels (a gray image is replicated)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native image decoder unavailable: {error}")
    if crop is not None:
        out_w, out_h = crop[2], crop[3]
    elif resize_wh is not None:
        out_w, out_h = resize_wh
    else:
        out_w, out_h, _ = image_size(path)
    buf = np.empty((out_h, out_w, out_c), np.uint8)
    rw, rh = resize_wh if resize_wh is not None else (0, 0)
    cx, cy, cw, ch = crop if crop is not None else (0, 0, 0, 0)
    rc = lib.madm_load(path.encode(), rw, rh, cx, cy, cw, ch, int(flip), int(nearest),
                       buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_c)
    if rc:
        raise IOError(f"native load failed ({rc}) for {path}")
    return buf
