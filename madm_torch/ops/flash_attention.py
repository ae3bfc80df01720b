"""Flash-attention forward (kernel K1) and its plain PyTorch twin.

``flash_attention`` takes ``[B, S, H, D]`` tensors (the JAX package's
layout).  A CPU tensor goes to ``attention_reference``; a CUDA tensor
launches the hand-written kernel ``csrc/flash_attention.cu`` (which replaces
``madm_tpu/ops/flash_attention.py::_attn_kernel``), or raises.
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 512


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v with an fp32 softmax; [B,S,H,D] in, q.dtype out."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype).contiguous()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,Sq,H,D], k/v [B,Sk,H,D]; got {q.shape}, {k.shape}, {v.shape}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B, H or D")
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k, v must lie on one CUDA device "
                         f"(got {q.device}, {k.device}, {v.device})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q/k/v, got {q.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention needs a unit-stride head dim")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    lib = kernels.load("flash_attention")
    fn = lib.madm_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
    strides = [t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 b, sq, sk, h, d, *strides, float(scale), stream)
    kernels.check(lib, err, "flash_attention launch")
    flash_attention.launches += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention on [B, S, H, D]; returns [B, Sq, H, D]
    in q.dtype.  CPU tensors run the twin; CUDA tensors run kernel K1."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    return _launch(q, k, v, scale)


flash_attention.launches = 0
