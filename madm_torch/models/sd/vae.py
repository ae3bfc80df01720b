"""SD-v1.4 AutoencoderKL (port of ``madm_tpu/models/sd/vae.py``).

The JAX ``Encoder`` owns ``quant_conv`` and returns the posterior mean times
the scaling factor; its ``Decoder`` owns ``post_quant_conv``.  Here the
modules keep diffusers' ``AutoencoderKL`` layout (``encoder``, ``decoder``,
``quant_conv``, ``post_quant_conv``) so a diffusers VAE state dict loads
as is, and ``AutoencoderKL.encode`` / ``decode`` compute what the JAX
``Encoder`` / ``Decoder`` compute.  NCHW; images in [-1, 1].

Feature taps (the LDM extractor's, ``models/ldm_extractor.py``): the
encoder's ``encoder_block_indices`` count its resnets, 1-based after a
resnet (``tap_type='after'``) or 0-based at a resnet's input ('in'); the
decoder's ``decoder_block_indices`` count its resnets (3 a level) 0-based
at a resnet's input.  ``encode_features`` / ``decode_features`` return the
taps beside the latent / image; ``decode_features(..., output_final=False)``
stops after the last resnet.  Without indices there are no taps, and
``encode`` / ``decode`` are unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
    """image [-1, 1] -> (the 8-channel moments before ``quant_conv``, taps)."""

    def __init__(self, block_out_channels: Sequence[int] = BLOCK_OUT_CHANNELS,
                 encoder_block_indices: Sequence[int] = (), tap_type: str = "after"):
        super().__init__()
        if tap_type not in ("in", "after"):
            raise ValueError(f"tap_type {tap_type!r} is not 'in' or 'after'")
        self.encoder_block_indices = tuple(encoder_block_indices)
        self.tap_type = tap_type
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

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        feats = []
        index = 0
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for r in blk.resnets:
                if self.tap_type == "in" and index in self.encoder_block_indices:
                    feats.append(x)
                x = r(x)
                index += 1
                if self.tap_type == "after" and index in self.encoder_block_indices:
                    feats.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x)), feats


class Decoder(nn.Module):
    """latent (after ``post_quant_conv``) -> (RGB [-1, 1], or None without
    ``output_final``; taps)."""

    def __init__(self, block_out_channels: Sequence[int] = BLOCK_OUT_CHANNELS,
                 decoder_block_indices: Sequence[int] = ()):
        super().__init__()
        self.decoder_block_indices = tuple(decoder_block_indices)
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

    def forward(self, z: torch.Tensor, output_final: bool = True
                ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
        feats = []
        index = 0
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for r in blk.resnets:
                if index in self.decoder_block_indices:
                    feats.append(x)
                index += 1
                x = r(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        if not output_final:
            return None, feats
        return self.conv_out(self.conv_norm_out(x)), feats


class AutoencoderKL(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = BLOCK_OUT_CHANNELS,
                 encoder_block_indices: Sequence[int] = (), tap_type: str = "after",
                 decoder_block_indices: Sequence[int] = ()):
        super().__init__()
        self.encoder = Encoder(block_out_channels, encoder_block_indices, tap_type)
        self.decoder = Decoder(block_out_channels, decoder_block_indices)
        self.quant_conv = nn.Conv2d(2 * LATENT_CHANNELS, 2 * LATENT_CHANNELS, 1)
        self.post_quant_conv = nn.Conv2d(LATENT_CHANNELS, LATENT_CHANNELS, 1)

    def encode_features(self, images: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(deterministic latent: posterior mean x scaling factor, not a
        sample; the encoder's taps)."""
        moments, feats = self.encoder(images)
        return self.quant_conv(moments)[:, :LATENT_CHANNELS] * SCALING_FACTOR, feats

    def decode_features(self, latents: torch.Tensor, output_final: bool = True
                        ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
        """(RGB of a scaled latent, or None without ``output_final``; the
        decoder's taps)."""
        return self.decoder(self.post_quant_conv(latents / SCALING_FACTOR), output_final)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return self.encode_features(images)[0]

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self.decode_features(latents)[0]
