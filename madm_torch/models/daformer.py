"""DAFormer decode head (port of ``madm_tpu/models/daformer.py``: the
shipped sep-ASPP fusion on the ``ASPPWrapper`` module math, and the
variants of ``head_fusion``, ``final_fuse_vae_decoder_feat`` and
``concat_attention_to_conv_seg``).

per-scale Linear embed -> bilinear resize to the largest scale -> concat ->
fuse layer -> Dropout2d -> [concat slot] -> 1x1 conv_seg.  The fuse layer:
'aspp' sep-ASPP (dilations 1/6/12/18, BN + ReLU) -> 3x3 bottleneck; 'isa'
interlaced sparse self-attention (``ISALayer``); 'sep_conv' a depthwise 3x3
+ pointwise ConvModule pair; 'conv' one ConvModule.  With
``final_fuse_vae_decoder_feat`` the head fuses at half the s0 resolution,
resizes back and concatenates a projection of the s0 feature
(``vae_decoder_feat_proj``, a GN bottleneck block 32 -> 64) before
conv_seg; with ``concat_attention_to_conv_seg`` conv_seg reads the token-
selected cross-attention map (``num_classes`` channels) resized to the
fused features instead.  NCHW; mmseg/mmcv parameter names
(``embed_layers.<i>.proj``, ``fuse_layer.aspp_modules.<i>``,
``fuse_layer.bottleneck``, ``fuse_layer.global_relation.query_project.<i>``,
``conv_seg``).
Eval BN uses the running statistics.  Train BN (flax semantics) normalises
by the batch statistics over N, H, W; with ``update_bn`` it folds them into
the running statistics with momentum 0.9 and the biased variance.  Under a
process group the batch is the global one, as under the
JAX package's GSPMD step, whose means over a batch-sharded axis reduce
across the data axis: the mean and E[y^2] are all-reduced sums over the
global element count, with a gradient through the reduction.  Dropout2d
takes its channel multiplier from the caller.  This module head is the plain
path; ``ops.aspp``'s eval heads compute the same eval ids with kernels K2
(``aspp_head_forward``), K7 (``argmax_head_forward``) or K6 and K7
(``fused_head_forward``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import dist as dist_lib
from .projections import BottleneckBlock


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW bilinear resize, align_corners=False, no antialias.  A narrow
    tensor that needs a gradient is resized in fp32: the CUDA backward adds
    each fine pixel's share into the coarse gradient with atomics in the
    tensor's dtype, and in bf16 the small shares of an 8-32x upsampling
    round away, which shrinks the gradient of the coarse scales."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    if x.dtype != torch.float32 and x.requires_grad and torch.is_grad_enabled():
        return resize_bilinear(x.float(), size).to(x.dtype)
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=False)


def argmax_classes(logits: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """First-occurrence argmax over ``dim`` as int32 (ties -> lowest index)."""
    c = logits.shape[dim]
    m = logits.amax(dim=dim, keepdim=True)
    shape = [1] * logits.ndim
    shape[dim] = c
    iota = torch.arange(c, device=logits.device, dtype=torch.int32).view(shape)
    big = torch.tensor(c, device=logits.device, dtype=torch.int32)
    return torch.where(logits == m, iota, big).amin(dim=dim)


BN_MOMENTUM = 0.9  # flax convention: running = 0.9 * running + 0.1 * batch
DROPOUT_RATIO = 0.1  # Dropout2d before conv_seg, train only


@torch.no_grad()
def _fold_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor) -> None:
    bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
    bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)


@torch.no_grad()
def _update_running_stats(bn: nn.BatchNorm2d, y: torch.Tensor) -> None:
    """Fold y's batch mean and biased variance (fp32 accumulators over the
    compute-dtype tensor, E[y^2] - E[y]^2 as flax computes them) into the
    running statistics."""
    mean = torch.mean(y, dim=(0, 2, 3), dtype=torch.float32)
    var = (torch.mean(torch.square(y), dim=(0, 2, 3), dtype=torch.float32) - mean * mean).clamp_min(0.0)
    _fold_running_stats(bn, mean, var)


def global_batch_stats(y: torch.Tensor):
    """fp32 mean and biased variance of y over N, H, W of the global batch:
    the sums of y and y^2 all-reduced (with a gradient) over the global
    element count (JAX ``_bn_stats`` under GSPMD)."""
    sums = torch.stack([torch.sum(y, dim=(0, 2, 3), dtype=torch.float32),
                        torch.sum(torch.square(y), dim=(0, 2, 3), dtype=torch.float32)])
    moments = dist_lib.all_reduce_sum(sums) / (y.numel() // y.shape[1] * dist_lib.world())
    mean = moments[0]
    return mean, (moments[1] - mean * mean).clamp_min(0.0)


class ConvModule(nn.Module):
    """mmcv ConvModule: bias-free conv -> BN -> ReLU."""

    def __init__(self, cin: int, cout: int, k: int = 1, dilation: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=dilation * (k // 2), dilation=dilation,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: torch.Tensor, train: bool = False, update_bn: bool = False) -> torch.Tensor:
        bn = self.bn
        if self.conv.groups > 1 and x.device.type == "cpu":
            # a dilated depthwise conv over a channels-last input (the head's
            # embeds are) on the CPU: oneDNN's bf16 backward reads memory it
            # did not write (a NaN or inf weight gradient, ROADMAP §C), and in
            # fp32 it runs 1.6-6x slower than over a contiguous input
            x = x.contiguous()
        y = self.conv(x)
        if not train:
            return F.relu(F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                       training=False, eps=bn.eps))
        if dist_lib.initialized():
            mean, var = global_batch_stats(y)
            if update_bn:
                _fold_running_stats(bn, mean.detach(), var.detach())
            # JAX _bn_apply_relu: scale and shift formed in fp32, applied in y's dtype
            mul = torch.rsqrt(var + bn.eps) * bn.weight.float()
            shift = bn.bias.float() - mean * mul
            return F.relu(y * mul.to(y.dtype)[:, None, None] + shift.to(y.dtype)[:, None, None])
        if update_bn:
            _update_running_stats(bn, y)
        # batch statistics only: F.batch_norm would fold the unbiased variance
        # into running statistics handed to it, so it gets none
        return F.relu(F.batch_norm(y, None, None, bn.weight, bn.bias, training=True, eps=bn.eps))


class DepthwiseSeparableConvModule(nn.Module):
    """depthwise 3x3 (dilated) ConvModule then pointwise 1x1 ConvModule."""

    def __init__(self, cin: int, cout: int, dilation: int):
        super().__init__()
        self.depthwise_conv = ConvModule(cin, cin, 3, dilation=dilation, groups=cin)
        self.pointwise_conv = ConvModule(cin, cout, 1)

    def forward(self, x: torch.Tensor, train: bool = False, update_bn: bool = False) -> torch.Tensor:
        return self.pointwise_conv(self.depthwise_conv(x, train, update_bn), train, update_bn)


class ASPPWrapper(nn.Module):
    """Separable ASPP (sep=True, no image pool)."""

    def __init__(self, cin: int, channels: int, dilations: Sequence[int]):
        super().__init__()
        self.dilations = tuple(dilations)
        self.aspp_modules = nn.ModuleList([
            ConvModule(cin, channels, 1) if d == 1
            else DepthwiseSeparableConvModule(cin, channels, d)
            for d in self.dilations
        ])
        self.bottleneck = ConvModule(len(self.dilations) * channels, channels, 3)

    def forward(self, x: torch.Tensor, train: bool = False, update_bn: bool = False) -> torch.Tensor:
        branches = [m(x, train, update_bn) for m in self.aspp_modules]
        return self.bottleneck(torch.cat(branches, dim=1), train, update_bn)


ISA_CHANNELS = 128  # ISA's query/key width
ISA_DOWN = 8  # ISA's window side
ISA_KEY_QUERY_CONVS = 2


class SelfAttentionBlock(nn.Module):
    """mmseg ISA self-attention block (JAX ``SelfAttentionBlock``): query and
    key by two stacked 1x1 ConvModules to ``ISA_CHANNELS``, value by a plain
    1x1 conv, softmax of the fp32 similarities x ISA_CHANNELS^-0.5 cast to
    the input's dtype, then an output ConvModule."""

    def __init__(self, cin: int):
        super().__init__()
        self.query_project, self.key_project = (nn.ModuleList(
            [ConvModule(cin if i == 0 else ISA_CHANNELS, ISA_CHANNELS) for i in range(ISA_KEY_QUERY_CONVS)])
            for _ in range(2))
        self.value_project = nn.Conv2d(cin, cin, 1)
        self.output_project = ConvModule(cin, cin)

    def forward(self, x: torch.Tensor, train: bool = False, update_bn: bool = False) -> torch.Tensor:
        n, c, h, w = x.shape
        q, k = x, x
        for m in self.query_project:
            q = m(q, train, update_bn)
        for m in self.key_project:
            k = m(k, train, update_bn)
        v = self.value_project(x)
        q, k, v = (t.flatten(2).transpose(1, 2) for t in (q, k, v))  # [N, HW, C]
        sim = torch.softmax(torch.bmm(q.float(), k.float().transpose(1, 2)) * ISA_CHANNELS ** -0.5,
                            dim=-1).to(x.dtype)
        ctx = torch.bmm(sim, v).transpose(1, 2).reshape(n, c, h, w)
        return self.output_project(ctx, train, update_bn)


class ISALayer(nn.Module):
    """Interlaced sparse self-attention (JAX ``ISALayer``, reference
    ``daformer_head.py:246-338``): a 1x1 in-conv, attention across the
    (gh, gw) grid of 8x8 windows at each offset inside a window (the global
    relation), then within each window (the local relation); the input is
    padded to a multiple of 8 centred, and cropped back."""

    def __init__(self, cin: int, channels: int):
        super().__init__()
        self.in_conv = ConvModule(cin, channels)
        self.global_relation = SelfAttentionBlock(channels)
        self.local_relation = SelfAttentionBlock(channels)

    def forward(self, x: torch.Tensor, train: bool = False, update_bn: bool = False) -> torch.Tensor:
        x = self.in_conv(x, train, update_bn)
        n, c, h, w = x.shape
        lh = lw = ISA_DOWN
        gh, gw = -(-h // lh), -(-w // lw)
        ph, pw = gh * lh - h, gw * lw - w
        if ph or pw:
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        # global relation: across the grid at each offset inside a window
        x = x.reshape(n, c, gh, lh, gw, lw).permute(0, 3, 5, 1, 2, 4).reshape(n * lh * lw, c, gh, gw)
        x = self.global_relation(x, train, update_bn)
        # local relation: within each window
        x = x.reshape(n, lh, lw, c, gh, gw).permute(0, 4, 5, 3, 1, 2).reshape(n * gh * gw, c, lh, lw)
        x = self.local_relation(x, train, update_bn)
        x = x.reshape(n, gh, gw, c, lh, lw).permute(0, 3, 1, 4, 2, 5).reshape(n, c, gh * lh, gw * lw)
        if ph or pw:
            x = x[:, :, ph // 2:ph // 2 + h, pw // 2:pw // 2 + w]
        return x


class MLP(nn.Module):
    """mmseg embed: a Linear over channels."""

    def __init__(self, cin: int, embed_dims: int):
        super().__init__()
        self.proj = nn.Linear(cin, embed_dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in, NCHW out (stored channels-last)."""
        return self.proj(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


HEAD_FUSIONS = ("aspp", "isa", "sep_conv", "conv")
VAE_FEAT_PROJ = (32, 64)  # final_fuse's projection: bottleneck width, output channels


class DAFormerHead(nn.Module):
    """Logits at the resolution of ``features[in_keys[0]]``."""

    def __init__(self, in_channels: Sequence[int], in_keys: Sequence[str], num_classes: int,
                 channels: int = 256, embed_dims: int = 256,
                 dilations: Sequence[int] = (1, 6, 12, 18), fusion: str = "aspp",
                 final_fuse_vae_decoder_feat: bool = False,
                 concat_attention_to_conv_seg: bool = False):
        super().__init__()
        if fusion not in HEAD_FUSIONS:
            raise ValueError(f"head fusion {fusion!r} is not one of {HEAD_FUSIONS}")
        self.in_keys = tuple(in_keys)
        self.channels, self.embed_dims, self.num_classes = channels, embed_dims, num_classes
        self.dilations = tuple(dilations)
        self.fusion = fusion
        self.final_fuse_vae_decoder_feat = final_fuse_vae_decoder_feat
        self.concat_attention_to_conv_seg = concat_attention_to_conv_seg
        self.embed_layers = nn.ModuleDict(
            {str(i): MLP(c, embed_dims) for i, c in enumerate(in_channels)}
        )
        cin = embed_dims * len(in_channels)
        if fusion == "aspp":
            self.fuse_layer = ASPPWrapper(cin, channels, dilations)
        elif fusion == "isa":
            self.fuse_layer = ISALayer(cin, channels)
        elif fusion == "sep_conv":
            self.fuse_layer = DepthwiseSeparableConvModule(cin, channels, 1)
        else:  # 'conv': the reference's fusion kernel size, 3
            self.fuse_layer = ConvModule(cin, channels, 3)
        seg_in = channels
        if concat_attention_to_conv_seg:  # the slot takes precedence (JAX daformer.py:601-612)
            seg_in += num_classes
        elif final_fuse_vae_decoder_feat:
            self.vae_decoder_feat_proj = nn.Sequential(BottleneckBlock(in_channels[0], *VAE_FEAT_PROJ))
            seg_in += VAE_FEAT_PROJ[1]
        self.conv_seg = nn.Conv2d(seg_in, num_classes, 1)

    def embeds(self, features: Dict[str, torch.Tensor]) -> list:
        """Per-scale embeds resized to the fused resolution (NCHW): the first
        key's, or half of it under ``final_fuse_vae_decoder_feat``."""
        xs = [features[k] for k in self.in_keys]
        if self.final_fuse_vae_decoder_feat:
            xs[0] = resize_bilinear(xs[0], (xs[0].shape[2] // 2, xs[0].shape[3] // 2))
        size = xs[0].shape[2:]
        return [resize_bilinear(self.embed_layers[str(i)](x), size) for i, x in enumerate(xs)]

    def forward(self, features: Dict[str, torch.Tensor], train: bool = False,
                update_bn: bool = False, dropout: Optional[torch.Tensor] = None,
                return_pre_seg: bool = False,
                cross_attention_feat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``dropout``: Dropout2d's channel multiplier [B, channels] (train
        only).  ``return_pre_seg`` returns conv_seg's input instead of the
        logits, for a caller that fuses conv_seg with the argmax.
        ``cross_attention_feat`` [B, num_classes, h, w] fills the
        ``concat_attention_to_conv_seg`` slot."""
        x = self.fuse_layer(torch.cat(self.embeds(features), dim=1), train, update_bn)
        if dropout is not None:
            x = x * dropout.to(x.dtype)[:, :, None, None]
        if self.concat_attention_to_conv_seg:
            if cross_attention_feat is None:
                raise ValueError("concat_attention_to_conv_seg needs the cross_attention_feat of its pass")
            att = resize_bilinear(cross_attention_feat, x.shape[2:])
            x = torch.cat([x, att.to(x.dtype)], dim=1)
        elif self.final_fuse_vae_decoder_feat:
            s0 = features[self.in_keys[0]]
            x = torch.cat([resize_bilinear(x, s0.shape[2:]), self.vae_decoder_feat_proj(s0)], dim=1)
        return x if return_pre_seg else self.conv_seg(x)
