"""DAFormer decode head (port of ``madm_tpu/models/daformer.py``, the
shipped sep-ASPP fusion, on the ``ASPPWrapper`` module math).

per-scale Linear embed -> bilinear resize to the largest scale -> concat ->
sep-ASPP (dilations 1/6/12/18, BN + ReLU) -> 3x3 bottleneck -> Dropout2d ->
1x1 conv_seg.  NCHW; mmseg/mmcv parameter names (``embed_layers.<i>.proj``,
``fuse_layer.aspp_modules.<i>``, ``fuse_layer.bottleneck``, ``conv_seg``).
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


def _global_batch_stats(y: torch.Tensor):
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
        y = self.conv(x)
        if not train:
            return F.relu(F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                       training=False, eps=bn.eps))
        if dist_lib.initialized():
            mean, var = _global_batch_stats(y)
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


class MLP(nn.Module):
    """mmseg embed: a Linear over channels."""

    def __init__(self, cin: int, embed_dims: int):
        super().__init__()
        self.proj = nn.Linear(cin, embed_dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in, NCHW out (stored channels-last)."""
        return self.proj(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class DAFormerHead(nn.Module):
    """Logits at the resolution of ``features[in_keys[0]]``."""

    def __init__(self, in_channels: Sequence[int], in_keys: Sequence[str], num_classes: int,
                 channels: int = 256, embed_dims: int = 256,
                 dilations: Sequence[int] = (1, 6, 12, 18)):
        super().__init__()
        self.in_keys = tuple(in_keys)
        self.channels, self.embed_dims, self.num_classes = channels, embed_dims, num_classes
        self.dilations = tuple(dilations)
        self.embed_layers = nn.ModuleDict(
            {str(i): MLP(c, embed_dims) for i, c in enumerate(in_channels)}
        )
        self.fuse_layer = ASPPWrapper(embed_dims * len(in_channels), channels, dilations)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def embeds(self, features: Dict[str, torch.Tensor]) -> list:
        """Per-scale embeds resized to the first key's resolution (NCHW)."""
        xs = [features[k] for k in self.in_keys]
        size = xs[0].shape[2:]
        return [resize_bilinear(self.embed_layers[str(i)](x), size) for i, x in enumerate(xs)]

    def forward(self, features: Dict[str, torch.Tensor], train: bool = False,
                update_bn: bool = False, dropout: Optional[torch.Tensor] = None,
                return_pre_seg: bool = False) -> torch.Tensor:
        """``dropout``: Dropout2d's channel multiplier [B, channels] (train
        only).  ``return_pre_seg`` returns conv_seg's input instead of the
        logits, for a caller that fuses conv_seg with the argmax."""
        x = self.fuse_layer(torch.cat(self.embeds(features), dim=1), train, update_bn)
        if dropout is not None:
            x = x * dropout.to(x.dtype)[:, :, None, None]
        return x if return_pre_seg else self.conv_seg(x)
