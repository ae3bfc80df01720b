"""Multi-head attention for the SD UNet and VAE on ``[B, S, H, D]`` tensors
(port of ``madm_tpu/ops/attention.py``).  Every call goes through kernel K1's
wrapper, which runs the kernel on CUDA tensors and its fp32-softmax twin on
CPU tensors."""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v, softmax in fp32; returns [B, Sq, H, D] in q.dtype."""
    return flash_attention(q, k, v, scale=scale)
