"""Multi-head attention for the SD UNet and VAE on ``[B, S, H, D]`` tensors
(port of ``madm_tpu/ops/attention.py``).  Every call goes through kernel K1's
wrapper, or, where packing is on and ``pack_group`` picks the shape, through
the packed kernels K4/K5; each wrapper runs its kernel on CUDA tensors and
its twin on CPU tensors."""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, pack_group, packed_attention


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          scale: Optional[float] = None, pack: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale) v, softmax in fp32; returns [B, Sq, H, D] in
    q.dtype.  ``pack``: the packed-head path (``MADMConfig.flash_pack``) for
    the shapes ``pack_group`` packs."""
    g = pack_group(q.shape[1], k.shape[1], q.shape[-1], pack)
    if g > 1:
        return packed_attention(q, k, v, g, scale=scale)
    return flash_attention(q, k, v, scale=scale)
