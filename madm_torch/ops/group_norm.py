"""GroupNorm with fp32 statistics from sum and sum of squares, optional
fused activation (port of ``madm_tpu/ops/group_norm.py``; plain torch)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5,
               act: Optional[str] = None) -> torch.Tensor:
    """x: [B, C, *spatial].  Statistics in fp32 (eps inside the sqrt), output
    in x.dtype; ``act`` is None, 'silu' or 'relu'."""
    b, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    dims = tuple(range(2, x.ndim))
    n = x[0, 0].numel() * (c // num_groups)
    xf = x.float()
    s1 = xf.sum(dims).view(b, num_groups, -1).sum(-1)
    s2 = (xf * xf).sum(dims).view(b, num_groups, -1).sum(-1)
    mean = s1 / n
    inv = torch.rsqrt(s2 / n - mean * mean + eps)
    per = c // num_groups
    a = inv.repeat_interleave(per, dim=1) * weight.float()
    shift = bias.float() - mean.repeat_interleave(per, dim=1) * a
    shape = (b, c) + (1,) * len(dims)
    y = xf * a.view(shape) + shift.view(shape)
    if act == "silu":
        y = F.silu(y)
    elif act == "relu":
        y = F.relu(y)
    elif act is not None:
        raise ValueError(f"unknown activation {act!r}")
    return y.to(x.dtype)
