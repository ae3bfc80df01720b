"""SD-v1.4 AutoencoderKL (port of ``madm_tpu/models/sd/vae.py``).

The JAX ``Encoder`` owns ``quant_conv`` and returns the posterior mean times
the scaling factor; its ``Decoder`` owns ``post_quant_conv``.  Here the
modules keep diffusers' ``AutoencoderKL`` layout (``encoder``, ``decoder``,
``quant_conv``, ``post_quant_conv``) so a diffusers VAE state dict loads
as is, and ``AutoencoderKL.encode`` / ``decode`` compute what the JAX
``Encoder`` / ``Decoder`` compute.  NCHW; images in [-1, 1].
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...ops.attention import dot_product_attention
from .layers import Block, Downsample2D, GroupNorm, ResnetBlock2D, Upsample2D

SCALING_FACTOR = 0.18215
BLOCK_OUT_CHANNELS = (128, 256, 512, 512)
LAYERS_PER_BLOCK = 2
LATENT_CHANNELS = 4


class VAEAttention(nn.Module):
    """Single-head (D = channels) mid-block attention with biased q/k/v;
    runs through kernel K1 as a [B, S, 1, C] attention."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q = self.to_q(t).view(b, h * w, 1, c)
        k = self.to_k(t).view(b, h * w, 1, c)
        v = self.to_v(t).view(b, h * w, 1, c)
        out = self.to_out[0](dot_product_attention(q, k, v).reshape(b, h * w, c))
        return out.view(b, h, w, c).permute(0, 3, 1, 2) + x


class MidBlock2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(channels, channels, eps=1e-6) for _ in range(2)]
        )
        self.attentions = nn.ModuleList([VAEAttention(channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    """image [-1, 1] -> the 8-channel moments before ``quant_conv``."""

    def __init__(self, block_out_channels: Sequence[int] = BLOCK_OUT_CHANNELS):
        super().__init__()
        boc = tuple(block_out_channels)
        self.conv_in = nn.Conv2d(3, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = boc[0]
        for i, c in enumerate(boc):
            blk = Block()
            blk.resnets = nn.ModuleList(
                [ResnetBlock2D(prev if j == 0 else c, c, eps=1e-6) for j in range(LAYERS_PER_BLOCK)]
            )
            if i != len(boc) - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(c, padding=0)])
            self.down_blocks.append(blk)
            prev = c
        self.mid_block = MidBlock2D(boc[-1])
        self.conv_norm_out = GroupNorm(boc[-1], eps=1e-6, act="silu")
        self.conv_out = nn.Conv2d(boc[-1], 2 * LATENT_CHANNELS, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for r in blk.resnets:
                x = r(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    """latent (after ``post_quant_conv``) -> RGB [-1, 1]."""

    def __init__(self, block_out_channels: Sequence[int] = BLOCK_OUT_CHANNELS):
        super().__init__()
        rev = tuple(reversed(tuple(block_out_channels)))
        self.conv_in = nn.Conv2d(LATENT_CHANNELS, rev[0], 3, padding=1)
        self.mid_block = MidBlock2D(rev[0])
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, c in enumerate(rev):
            blk = Block()
            blk.resnets = nn.ModuleList(
                [ResnetBlock2D(prev if j == 0 else c, c, eps=1e-6)
                 for j in range(LAYERS_PER_BLOCK + 1)]
            )
            if i != len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(c)])
            self.up_blocks.append(blk)
            prev = c
        self.conv_norm_out = GroupNorm(rev[-1], eps=1e-6, act="silu")
        self.conv_out = nn.Conv2d(rev[-1], 3, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for r in blk.resnets:
                x = r(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = BLOCK_OUT_CHANNELS):
        super().__init__()
        self.encoder = Encoder(block_out_channels)
        self.decoder = Decoder(block_out_channels)
        self.quant_conv = nn.Conv2d(2 * LATENT_CHANNELS, 2 * LATENT_CHANNELS, 1)
        self.post_quant_conv = nn.Conv2d(LATENT_CHANNELS, LATENT_CHANNELS, 1)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """Deterministic latent: posterior mean x scaling factor (not a sample)."""
        moments = self.quant_conv(self.encoder(images))
        return moments[:, :LATENT_CHANNELS] * SCALING_FACTOR

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(latents / SCALING_FACTOR))
