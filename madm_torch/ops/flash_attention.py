"""Flash attention: forward (kernel K1), backward (kernel K3), their plain
PyTorch twins, and the autograd Function that joins them.

``flash_attention`` takes ``[B, S, H, D]`` tensors (the JAX package's
layout).  A CPU tensor goes to the twins (``attention_reference``, and
``attention_backward_reference`` for its gradient); a CUDA tensor launches
the hand-written kernels ``csrc/flash_attention.cu`` (which replaces
``madm_tpu/ops/flash_attention.py::_attn_kernel``) and
``csrc/flash_attention_bwd.cu`` (which replaces ``_attn_bwd_kernel``), or
raises.  When a gradient is needed, K1 also writes the fp32 row
log-sum-exp that K3 recomputes the probabilities from; eval passes skip it.
``flash_attention.launches`` and ``flash_attention_backward.launches`` count
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 512
MAX_BWD_HEAD_DIM = 160  # the UNet's widest head; the VAE's D=512 never trains


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v with an fp32 softmax; [B,S,H,D] in, q.dtype out."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype).contiguous()


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 g: torch.Tensor, scale: Optional[float] = None,
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``attention_reference`` for the output gradient ``g``,
    in fp32 as ``_attn_bwd_kernel`` states it: P recomputed from q and k,
    dS = P * (dP - rowsum(dP * P)); returned in the inputs' dtypes."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float, with_lse: bool = True,
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel K1 on CUDA tensors (raises for any other): (o, lse), lse the
    fp32 row log-sum-exp [B, H, Sq] of the scaled scores, or None unless
    ``with_lse``."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    if o.numel() == 0:
        return o, lse
    lib = kernels.load("flash_attention")
    fn = lib.madm_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
    strides = [t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(), b, sq, sk, h, d, *strides,
                 float(scale), stream)
    kernels.check(lib, err, "flash_attention launch")
    flash_attention.launches += 1
    return o, lse


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, g: torch.Tensor, lse: Optional[torch.Tensor],
                             scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) for the output gradient ``g`` of ``o = attention(q, k, v)``.
    CPU tensors run ``attention_backward_reference`` (``o`` and ``lse`` are
    not needed); CUDA tensors launch kernel K3 with the forward's ``o`` and
    fp32 ``lse`` [B, H, Sq]: D <= 160, and in bf16 D % 8 == 0 with 16-byte
    aligned storage (the tensor-core body), else it raises."""
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, g, scale)
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d > MAX_BWD_HEAD_DIM:
        raise ValueError(f"flash_attention_backward: head dim {d} > {MAX_BWD_HEAD_DIM}")
    if o.shape != q.shape or g.shape != q.shape or o.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"o {tuple(o.shape)} / g {tuple(g.shape)} must match q {tuple(q.shape)}")
    if lse is None or lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError("flash_attention_backward needs the forward's fp32 lse [B, H, Sq]")
    q, k, v, o, lse = (t.contiguous() for t in (q, k, v, o, lse))
    g = g.to(q.dtype).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.bfloat16 and (d % 8 or any(t.data_ptr() % 16 for t in (q, k, v, g, dq, dk, dv))):
        raise ValueError("flash_attention_backward: bf16 needs a head dim divisible by 8 and "
                         f"16-byte aligned tensors (head dim {d})")
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = kernels.load("flash_attention_bwd")
    fn = lib.madm_flash_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[q.dtype], *(t.data_ptr() for t in (q, k, v, o, g, lse, delta, dq, dk, dv)),
                 b, sq, sk, h, d, float(scale), stream)
    kernels.check(lib, err, "flash_attention_backward launch")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


class FlashAttention(torch.autograd.Function):
    """K1 forward saving (q, k, v, o, lse); K3 backward.  On CPU tensors the
    twins take both roles."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        if q.device.type == "cpu":
            o, lse = attention_reference(q, k, v, scale), None
        else:
            o, lse = flash_attention_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, g, lse, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention on [B, S, H, D]; returns [B, Sq, H, D]
    in q.dtype.  CPU tensors run the twins; CUDA tensors run kernel K1, and
    kernel K3 for the gradient when one is needed."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, float(scale))
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    return flash_attention_forward(q, k, v, scale, with_lse=False)[0]


flash_attention.launches = 0
