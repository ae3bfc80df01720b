"""SD-v1.4 building blocks (port of ``madm_tpu/models/sd/layers.py``).

NCHW inside; module and parameter names follow diffusers so that a
diffusers state dict loads with ``load_state_dict``.  Attention runs through
``ops.attention.dot_product_attention`` (kernel K1 on CUDA) on ``[B, S, H, D]``
views of the projections, without transposes.  A cross-attention handed a
``capture`` list computes its softmax explicitly in plain torch instead and
appends the head-mean probabilities (JAX ``Attention.capture_attn``,
``madm_tpu/models/sd/layers.py:248-256``).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import dot_product_attention
from ...ops.group_norm import group_norm


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, diffusers ``Timesteps`` with flip_sin_to_cos=True,
    freq_shift=0: [cos | sin].  [B] -> [B, dim] float32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class GroupNorm(nn.Module):
    """GroupNorm (32 groups) with fp32 statistics and an optional fused
    activation; parameters ``weight``/``bias`` as in ``nn.GroupNorm``."""

    def __init__(self, num_channels: int, eps: float = 1e-5, act: Optional[str] = None):
        super().__init__()
        self.eps, self.act = eps, act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, 32, self.eps, self.act)


class Block(nn.Module):
    """Container of one UNet/VAE level (``resnets``, ``attentions``,
    re-samplers), giving diffusers' parameter paths."""


class TimestepEmbedding(nn.Module):
    """linear_1 -> SiLU -> linear_2."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> conv -> (+temb) -> GN -> SiLU -> conv, plus shortcut.
    UNet resnets use eps 1e-5, the VAE's 1e-6."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, eps=eps, act="silu")
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(out_channels, eps=eps, act="silu")
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv.  ``padding=1`` for the UNet; the VAE uses
    ``padding=0`` after an asymmetric (0, 1) pad, as diffusers does."""

    def __init__(self, channels: int, padding: int = 1):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x resize then 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Attention(nn.Module):
    """Multi-head attention over tokens [B, S, C] with an optional context;
    q/k/v have no bias.  ``pack``: the packed-head kernels where
    ``pack_group`` picks the shape (``MADMConfig.flash_pack``)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, pack: bool = False):
        super().__init__()
        self.pack = pack
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                capture: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """``capture``: a list to append the head-mean probabilities
        [B, Sq, Sk] fp32 to; the layer then computes fp32 logits x D^-0.5 and
        their softmax explicitly, and multiplies V by the probabilities cast
        to V's dtype, without the kernel."""
        ctx = x if context is None else context
        b, s, _ = x.shape
        sk = ctx.shape[1]
        q = self.to_q(x).view(b, s, self.heads, self.dim_head)
        k = self.to_k(ctx).view(b, sk, self.heads, self.dim_head)
        v = self.to_v(ctx).view(b, sk, self.heads, self.dim_head)
        if capture is None:
            out = dot_product_attention(q, k, v, pack=self.pack)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * self.dim_head ** -0.5
            p = torch.softmax(logits, dim=-1)
            capture.append(p.mean(dim=1))
            out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
        return self.to_out[0](out.reshape(b, s, self.heads * self.dim_head))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) gelu


class FeedForward(nn.Module):
    """GEGLU feed-forward; ``net`` = [GEGLU, (dropout slot), Linear] as in
    diffusers, so the keys are ``net.0.proj`` and ``net.2``."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> GEGLU FF, pre-LayerNorm, residuals; ``pack``
    goes to the self-attention (cross-attention never packs)."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int, pack: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head, pack=pack)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, context_dim=context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                capture: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """``capture``: the cross-attention's (``Attention.forward``)."""
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context, capture)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """GN -> 1x1 proj_in -> transformer block -> 1x1 proj_out, plus residual.
    proj_in/proj_out are 1x1 convs as in SD-v1.x checkpoints."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 pack: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim, pack)]
        )
        self.proj_out = nn.Conv2d(inner, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                capture: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        b, _, h, w = x.shape
        t = self.proj_in(self.norm(x))
        inner = t.shape[1]
        t = t.permute(0, 2, 3, 1).reshape(b, h * w, inner)
        t = self.transformer_blocks[0](t, context, capture)
        t = t.reshape(b, h, w, inner).permute(0, 3, 1, 2)
        return self.proj_out(t) + x
