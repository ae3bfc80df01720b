"""SD-v1.4 UNet2DConditionModel with MADM's feature taps (port of
``madm_tpu/models/sd/unet.py``).

- taps: the up-block resnets are numbered globally 0..11; for each index in
  ``unet_block_indices`` the hidden state after that resnet (and its
  attention) is returned ('after'), or the concat of the hidden state and
  its skip that enters the resnet ('in'), smallest resolution first.
- ``in_channels``: conv_in's input, 4 latent channels plus those of the
  conv_in-surgery ablations (``mask_diff``, ``concat_pixel_shuffle``).
- the context is [B, 77, 768] for every cross-attention, or one per layer
  [16, B, 77, 768] (``multi_layer_prompt``; down 2 a block, mid 1, up 3 a
  block, in that order).
- ``capture`` (an ``AttentionCapture``) names the cross-attentions whose
  probabilities a pass keeps (JAX ``UNet2DCondition._capture``): res in the
  512-input naming (down 64 >> level, mid 8, up 8 << level, up only where
  the level has cross-attention); those layers run in plain torch, the
  others keep the kernels.
- an optional learned residual [B, 1280] (or [B, 1, 1280]) is added to the
  time embedding (the prompt generator's ``cond_time``).
- ``flash_pack`` sends the self-attentions that ``pack_group`` picks through
  the packed-head kernels K4/K5 (at 512x512: the five at S=4096).
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


class AttentionCapture:
    """The cross-attentions one pass captures (at ``location`` in 'down',
    'mid', 'up' and ``res`` in the 512-input naming), and what they
    captured: ``entries`` [(location, res, probs [B, Sq, Sk] fp32)] in the
    order the pass ran them."""

    def __init__(self, res: Sequence[int], location: Sequence[str]):
        self.res, self.location = tuple(res), tuple(location)
        self.entries: List[Tuple[str, int, torch.Tensor]] = []

    def wants(self, location: str, res: int) -> bool:
        return location in self.location and res in self.res


class UNet2DCondition(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = BLOCK_OUT_CHANNELS,
                 unet_block_indices: Sequence[int] = (5, 8, 11), flash_pack: bool = False,
                 in_channels: int = IN_CHANNELS, unet_block_indices_type: str = "after"):
        super().__init__()
        if unet_block_indices_type not in ("in", "after"):
            raise ValueError(f"unet_block_indices_type {unet_block_indices_type!r} is not 'in' or 'after'")
        boc = tuple(block_out_channels)
        self.boc = boc
        self.unet_block_indices = tuple(unet_block_indices)
        self.indices_type = unet_block_indices_type
        temb = boc[0] * 4
        n = len(boc)

        def transformer(c):
            return Transformer2DModel(c, NUM_HEADS, c // NUM_HEADS, CROSS_ATTENTION_DIM, flash_pack)

        self.conv_in = nn.Conv2d(in_channels, boc[0], 3, padding=1)
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
                capture: Optional[AttentionCapture] = None,
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """sample [B, in_channels, h, w], timesteps [B], context [B, 77, 768]
        or [16, B, 77, 768] -> (eps [B, 4, h, w], taps smallest-resolution
        first); ``capture`` collects the probabilities of the layers it
        names."""
        dtype = self.conv_in.weight.dtype
        timesteps = timesteps.expand(sample.shape[0])
        temb = self.time_embedding(timestep_embedding(timesteps, self.boc[0]).to(dtype))
        if res_time_embedding is not None:
            if res_time_embedding.ndim == 3:  # [B, 1, 1280]
                res_time_embedding = res_time_embedding[:, 0]
            temb = temb + res_time_embedding.to(temb.dtype)
        context = context.to(dtype)
        layer_ctx = iter(context) if context.ndim == 4 else None

        def attend(attn, x, location, res):
            ctx = context if layer_ctx is None else next(layer_ctx)
            if capture is None or not capture.wants(location, res):
                return attn(x, ctx)
            probs: List[torch.Tensor] = []
            x = attn(x, ctx, probs)
            capture.entries.append((location, res, probs[0]))
            return x

        x = self.conv_in(sample.to(dtype))
        skips = [x]
        for level, blk in enumerate(self.down_blocks):
            for j, r in enumerate(blk.resnets):
                x = r(x, temb)
                if hasattr(blk, "attentions"):
                    x = attend(blk.attentions[j], x, "down", 64 >> level)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        x = self.mid_block.resnets[0](x, temb)
        x = attend(self.mid_block.attentions[0], x, "mid", 8)
        x = self.mid_block.resnets[1](x, temb)

        taps = []
        gidx = 0
        for level, blk in enumerate(self.up_blocks):
            for j, r in enumerate(blk.resnets):
                x = torch.cat([x, skips.pop()], dim=1)
                if self.indices_type == "in" and gidx in self.unet_block_indices:
                    taps.append(x)
                x = r(x, temb)
                if hasattr(blk, "attentions"):
                    x = attend(blk.attentions[j], x, "up", 8 << level)
                if self.indices_type == "after" and gidx in self.unet_block_indices:
                    taps.append(x)
                gidx += 1
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        return self.conv_out(self.conv_norm_out(x)), taps
