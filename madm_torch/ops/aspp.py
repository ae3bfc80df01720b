"""The fused separable-ASPP fuse layer (kernel K2), its plain twin, and the
eval DAFormer head built on it (port of ``madm_tpu/ops/aspp.py``).

``aspp_fused`` takes NHWC embeds and returns the NHWC branch concat
``[B, H, W, 4*PC]``.  A CPU tensor goes to ``aspp_fused_reference``; a CUDA
tensor launches ``csrc/aspp_fused.cu`` (which replaces
``madm_tpu/ops/aspp.py::_aspp_fused_kernel``), or raises.
``aspp_fused.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_PC = 256  # output channels per branch the kernel is built for
KERNEL_CHUNK = 32  # embed channels must be a multiple of the kernel's chunk
KERNEL_MAX_DILATION = 24  # halo of the rows the kernel stages in shared memory


def aspp_fused_reference(embeds: Sequence[torch.Tensor], dw_w, dw_s, dw_b, pw_w, pw_s, pw_b,
                         a0_w, a0_s, a0_b,
                         dilations: Tuple[int, ...] = (6, 12, 18)) -> torch.Tensor:
    """Plain twin of kernel K2, in fp32 from the same inputs.

    embeds: NHWC, same resolution; dw_w [n_dil, 3, 3, C] with its BN scale
    dw_s [n_dil, C] (folded here in fp32, as the kernel's caller folds it) and
    bias dw_b; pw_w [n_dil, C, PC], pw_s/pw_b [n_dil, PC]; a0_w [C, PC],
    a0_s/a0_b [PC].  The depthwise output is rounded to the embeds' dtype
    before the pointwise product, as the kernel does."""
    dtype = embeds[0].dtype
    x = torch.cat([e.float() for e in embeds], dim=-1)  # [B, H, W, C]
    c = x.shape[-1]
    xc = x.permute(0, 3, 1, 2)
    w_fold = dw_w.float() * dw_s.float()[:, None, None, :]
    outs = [F.relu(x @ a0_w.float() * a0_s.float() + a0_b.float())]
    for i, d in enumerate(dilations):
        k = w_fold[i].permute(2, 0, 1).unsqueeze(1)  # [C, 1, 3, 3]
        dwo = F.conv2d(xc, k, padding=d, dilation=d, groups=c).permute(0, 2, 3, 1)
        dwo = F.relu(dwo + dw_b[i].float()).to(dtype).float()
        outs.append(F.relu(dwo @ pw_w[i].float() * pw_s[i].float() + pw_b[i].float()))
    return torch.cat(outs, dim=-1).to(dtype)


def _launch(embeds, dw_w, dw_s, dw_b, pw_w, pw_s, pw_b, a0_w, a0_s, a0_b, dilations):
    e0 = embeds[0]
    dt = e0.dtype
    b, h, w, ec = e0.shape
    n = len(embeds)
    c = n * ec
    pc = pw_w.shape[-1]
    if dt not in _DTYPES:
        raise ValueError(f"aspp_fused takes float32 or bfloat16 embeds, got {dt}")
    if (not 1 <= n <= 4 or ec % KERNEL_CHUNK or len(dilations) != 3 or pc != KERNEL_PC
            or not all(1 <= d <= KERNEL_MAX_DILATION for d in dilations)):
        raise ValueError(
            f"aspp_fused kernel takes 1-4 embeds of a multiple of {KERNEL_CHUNK} channels, "
            f"3 dilations in [1, {KERNEL_MAX_DILATION}] and {KERNEL_PC} output channels per "
            f"branch; got {n} x {ec}, {tuple(dilations)}, {pc}"
        )
    if any(e.shape != e0.shape or e.dtype != dt or e.device != e0.device for e in embeds):
        raise ValueError("aspp_fused: embeds differ in shape, dtype or device")
    if not e0.is_cuda:
        raise ValueError(f"aspp_fused kernel needs CUDA tensors, got {e0.device}")
    dev = e0.device
    f32 = dict(device=dev, dtype=torch.float32)
    dw_w = (dw_w.to(**f32) * dw_s.to(**f32)[:, None, None, :]).contiguous()
    params = dict(
        dw_b=dw_b.to(**f32).contiguous(), pw_s=pw_s.to(**f32).contiguous(),
        pw_b=pw_b.to(**f32).contiguous(), a0_s=a0_s.to(**f32).contiguous(),
        a0_b=a0_b.to(**f32).contiguous(),
        pw_w=pw_w.to(device=dev, dtype=dt).contiguous(),
        a0_w=a0_w.to(device=dev, dtype=dt).contiguous(),
    )
    if tuple(dw_w.shape) != (3, 3, 3, c) or tuple(params["pw_w"].shape) != (3, c, pc) \
            or tuple(params["a0_w"].shape) != (c, pc):
        raise ValueError(f"aspp_fused weight shapes do not match C={c}, PC={pc}")
    embeds = [e.contiguous() for e in embeds]
    if any(e.data_ptr() % 16 for e in embeds):  # the kernel reads 8 channels per load
        raise ValueError("aspp_fused kernel needs 16-byte aligned embeds")
    out = torch.empty((b, h, w, 4 * pc), device=dev, dtype=dt)
    if out.numel() == 0:
        return out
    lib = kernels.load("aspp_fused")
    fn = lib.madm_aspp_fused
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
                   + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    ptrs = (ctypes.c_void_p * n)(*[e.data_ptr() for e in embeds])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[dt], ptrs, n, dw_w.data_ptr(), params["dw_b"].data_ptr(),
                 params["pw_w"].data_ptr(), params["pw_s"].data_ptr(), params["pw_b"].data_ptr(),
                 params["a0_w"].data_ptr(), params["a0_s"].data_ptr(), params["a0_b"].data_ptr(),
                 out.data_ptr(), b, h, w, ec, *[int(d) for d in dilations], stream)
    kernels.check(lib, err, "aspp_fused launch")
    aspp_fused.launches += 1
    return out


def aspp_fused(embeds: Sequence[torch.Tensor], dw_w, dw_s, dw_b, pw_w, pw_s, pw_b,
               a0_w, a0_s, a0_b, dilations: Tuple[int, ...] = (6, 12, 18)) -> torch.Tensor:
    """The whole separable-ASPP fuse layer (eval BN) on NHWC embeds; returns
    [B, H, W, (1 + n_dil) * PC] in branch order (aspp_0, then one PC block
    per dilation).  Arguments as in ``aspp_fused_reference``."""
    if embeds[0].device.type == "cpu":
        return aspp_fused_reference(embeds, dw_w, dw_s, dw_b, pw_w, pw_s, pw_b,
                                    a0_w, a0_s, a0_b, dilations)
    return _launch(embeds, dw_w, dw_s, dw_b, pw_w, pw_s, pw_b, a0_w, a0_s, a0_b, dilations)


aspp_fused.launches = 0


def _fold_bn(bn: torch.nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm -> per-channel (scale, bias) in fp32."""
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    return s, bn.bias.float() - bn.running_mean.float() * s


def fits_kernel(head) -> bool:
    """Whether ``aspp_head_forward`` serves this head: sep-ASPP with
    dilations 1/6/12/18, 256-wide embeds and branches, 4 inputs led by s0."""
    return (
        tuple(head.dilations) == (1, 6, 12, 18)
        and head.embed_dims == 256
        and head.channels == KERNEL_PC
        and len(head.in_keys) == 4
        and head.in_keys[0] == "s0"
    )


def aspp_head_forward(head, features: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Eval DAFormer head with the fuse layer's branches in ``aspp_fused``;
    returns argmax ids [B, H, W] int32 at the s0 resolution.

    Plain torch around the kernel: the embeds and their bilinear resize, the
    bottleneck 3x3 conv + BN + ReLU, conv_seg and the first-occurrence argmax.
    ``head`` is a ``models.daformer.DAFormerHead``; ``features`` NCHW."""
    from ..models.daformer import argmax_classes

    dt = head.conv_seg.weight.dtype
    embeds = [e.permute(0, 2, 3, 1).contiguous() for e in head.embeds(features)]
    fl = head.fuse_layer
    a0 = fl.aspp_modules[0]
    s_a0, b_a0 = _fold_bn(a0.bn)
    dw_w, dw_s, dw_b, pw_w, pw_s, pw_b = [], [], [], [], [], []
    for m in fl.aspp_modules[1:]:
        s, bb = _fold_bn(m.depthwise_conv.bn)
        dw_w.append(m.depthwise_conv.conv.weight[:, 0].permute(1, 2, 0).float())  # [3, 3, C]
        dw_s.append(s)
        dw_b.append(bb)
        s, bb = _fold_bn(m.pointwise_conv.bn)
        pw_w.append(m.pointwise_conv.conv.weight[:, :, 0, 0].t())  # [C, PC]
        pw_s.append(s)
        pw_b.append(bb)
    fused = aspp_fused(
        embeds, torch.stack(dw_w), torch.stack(dw_s), torch.stack(dw_b),
        torch.stack(pw_w).to(dt), torch.stack(pw_s), torch.stack(pw_b),
        a0.conv.weight[:, :, 0, 0].t().to(dt), s_a0, b_a0, tuple(head.dilations[1:]),
    )
    y = fl.bottleneck(fused.permute(0, 3, 1, 2))
    return argmax_classes(head.conv_seg(y))
