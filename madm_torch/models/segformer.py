"""SegFormer all-MLP decode head (port of ``madm_tpu/models/segformer.py``;
reference ``modeling/sem_seg_head/segformer_head.py``).  No shipped config
uses it and no model builds it, in the JAX package as here.

per-scale Linear embed (``linear_c<i>``) -> bilinear resize to the first
key's resolution -> concat -> 1x1 ConvModule fuse (BN + ReLU,
``linear_fuse``) -> Dropout2d -> 1x1 ``conv_seg``.  NCHW; BN as
``daformer.ConvModule``'s.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .daformer import ConvModule, resize_bilinear


class SegFormerHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], in_keys: Sequence[str], num_classes: int,
                 embed_dims: int = 256):
        super().__init__()
        self.in_keys = tuple(in_keys)
        self.embed_dims = embed_dims
        for i, c in enumerate(in_channels):
            setattr(self, f"linear_c{i}", nn.Linear(c, embed_dims))
        self.linear_fuse = ConvModule(embed_dims * len(in_channels), embed_dims)
        self.conv_seg = nn.Conv2d(embed_dims, num_classes, 1)

    def forward(self, features: Dict[str, torch.Tensor], train: bool = False,
                update_bn: bool = False, dropout: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [B, num_classes, h, w] at the first key's resolution;
        ``dropout``: Dropout2d's channel multiplier [B, embed_dims] (train
        only)."""
        xs = [features[k] for k in self.in_keys]
        size = xs[0].shape[2:]
        embeds = [resize_bilinear(getattr(self, f"linear_c{i}")(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2),
                                  size) for i, x in enumerate(xs)]
        x = self.linear_fuse(torch.cat(embeds, dim=1), train, update_bn)
        if dropout is not None:
            x = x * dropout.to(x.dtype)[:, :, None, None]
        return self.conv_seg(x)
