"""Per-scale GN BottleneckBlock projections (port of
``madm_tpu/models/projections.py``).  detectron2 layout: each conv carries
its GroupNorm as ``<conv>.norm``; ``feature_projections.<idx>.<block>``."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .sd.layers import GroupNorm


class Conv2dGN(nn.Conv2d):
    """detectron2 Conv2d: bias-free conv followed by its GroupNorm(32)."""

    def __init__(self, cin: int, cout: int, k: int, act: Optional[str] = None):
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        self.norm = GroupNorm(cout, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 convs with GN (+ReLU), 1x1+GN shortcut when the
    width changes, ReLU after the sum.  Stride 1."""

    def __init__(self, in_channels: int, bottleneck_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = Conv2dGN(in_channels, bottleneck_channels, 1, act="relu")
        self.conv2 = Conv2dGN(bottleneck_channels, bottleneck_channels, 3, act="relu")
        self.conv3 = Conv2dGN(bottleneck_channels, out_channels, 1)
        self.shortcut = (
            Conv2dGN(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv3(self.conv2(self.conv1(x)))
        s = x if self.shortcut is None else self.shortcut(x)
        return F.relu(h + s)


class MultiScaleProjection(nn.ModuleList):
    """One BottleneckBlock stage per tapped scale; features arrive largest
    resolution first and leave as {name: NCHW}."""

    def __init__(self, feature_dims: Sequence[int], projection_dim: Sequence[int],
                 out_features: Sequence[str], bottleneck_channels: int = 128):
        super().__init__(
            nn.Sequential(BottleneckBlock(cin, bottleneck_channels, cout))
            for cin, cout in zip(feature_dims, projection_dim)
        )
        self.out_features = tuple(out_features)

    def forward(self, features: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        if len(features) != len(self.out_features):
            raise ValueError(f"{len(features)} features for {self.out_features}")
        return {name: stage(x) for name, stage, x in zip(self.out_features, self, features)}
