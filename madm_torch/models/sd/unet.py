"""SD-v1.4 UNet2DConditionModel with MADM's feature taps (port of
``madm_tpu/models/sd/unet.py``).

- 'after' taps: the up-block resnets are numbered globally 0..11; for each
  index in ``unet_block_indices`` the hidden state after that resnet (and its
  attention) is returned, smallest resolution first.
- an optional learned residual [B, 1280] (or [B, 1, 1280]) is added to the
  time embedding (the prompt generator's ``cond_time``).
The whole UNet runs: eps feeds the VAE decoder that gives the s0 feature.
NCHW; diffusers module names.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from .layers import (
    Block,
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2DModel,
    Upsample2D,
    timestep_embedding,
)

BLOCK_OUT_CHANNELS = (320, 640, 1280, 1280)
LAYERS_PER_BLOCK = 2
NUM_HEADS = 8
CROSS_ATTENTION_DIM = 768
IN_CHANNELS = 4
OUT_CHANNELS = 4


class UNet2DCondition(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = BLOCK_OUT_CHANNELS,
                 unet_block_indices: Sequence[int] = (5, 8, 11)):
        super().__init__()
        boc = tuple(block_out_channels)
        self.boc = boc
        self.unet_block_indices = tuple(unet_block_indices)
        temb = boc[0] * 4
        n = len(boc)

        def transformer(c):
            return Transformer2DModel(c, NUM_HEADS, c // NUM_HEADS, CROSS_ATTENTION_DIM)

        self.conv_in = nn.Conv2d(IN_CHANNELS, boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], temb)

        self.down_blocks = nn.ModuleList()
        prev = boc[0]
        for i, c in enumerate(boc):
            blk = Block()
            blk.resnets = nn.ModuleList(
                [ResnetBlock2D(prev if j == 0 else c, c, temb) for j in range(LAYERS_PER_BLOCK)]
            )
            if i != n - 1:  # CrossAttnDownBlock2D; the last level is a plain DownBlock2D
                blk.attentions = nn.ModuleList([transformer(c) for _ in range(LAYERS_PER_BLOCK)])
                blk.downsamplers = nn.ModuleList([Downsample2D(c)])
            self.down_blocks.append(blk)
            prev = c

        self.mid_block = Block()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock2D(boc[-1], boc[-1], temb) for _ in range(2)]
        )
        self.mid_block.attentions = nn.ModuleList([transformer(boc[-1])])

        rev = tuple(reversed(boc))
        self.up_blocks = nn.ModuleList()
        prev_out = rev[0]
        for i, c in enumerate(rev):
            skip_in = rev[min(i + 1, n - 1)]
            blk = Block()
            blk.resnets = nn.ModuleList([
                ResnetBlock2D((prev_out if j == 0 else c) + (skip_in if j == LAYERS_PER_BLOCK else c),
                              c, temb)
                for j in range(LAYERS_PER_BLOCK + 1)
            ])
            if i != 0:  # CrossAttnUpBlock2D; the first level is a plain UpBlock2D
                blk.attentions = nn.ModuleList(
                    [transformer(c) for _ in range(LAYERS_PER_BLOCK + 1)]
                )
            if i != n - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(c)])
            self.up_blocks.append(blk)
            prev_out = c

        self.conv_norm_out = GroupNorm(boc[0], eps=1e-5, act="silu")
        self.conv_out = nn.Conv2d(boc[0], OUT_CHANNELS, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                res_time_embedding: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """sample [B, 4, h, w], timesteps [B], context [B, 77, 768] ->
        (eps [B, 4, h, w], taps smallest-resolution first)."""
        dtype = self.conv_in.weight.dtype
        timesteps = timesteps.expand(sample.shape[0])
        temb = self.time_embedding(timestep_embedding(timesteps, self.boc[0]).to(dtype))
        if res_time_embedding is not None:
            if res_time_embedding.ndim == 3:  # [B, 1, 1280]
                res_time_embedding = res_time_embedding[:, 0]
            temb = temb + res_time_embedding.to(temb.dtype)
        context = context.to(dtype)

        x = self.conv_in(sample.to(dtype))
        skips = [x]
        for blk in self.down_blocks:
            for j, r in enumerate(blk.resnets):
                x = r(x, temb)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, context)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x, context)
        x = self.mid_block.resnets[1](x, temb)

        taps = []
        gidx = 0
        for blk in self.up_blocks:
            for j, r in enumerate(blk.resnets):
                x = r(torch.cat([x, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, context)
                if gidx in self.unet_block_indices:
                    taps.append(x)
                gidx += 1
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        return self.conv_out(self.conv_norm_out(x)), taps
