"""MADM eval pass: diffusion feature extractor + DAFormer head (port of
``madm_tpu/models/madm.py``, the single-crop eval path).

One ``nn.Module`` holds every weight under checkpoint-style names (``vae``,
``unet``, ``prompt.clip_project_rgb``, ``feature_projections``,
``sem_seg_head``) plus the constants ``uncond_inputs`` and ``shared_noise``.
Public inputs and outputs keep the JAX layout: images NHWC [B, H, W, 3] in
[0, 1], logits NHWC, ids [B, H, W] int32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..ops import aspp
from . import prompt as prompt_lib
from .daformer import DAFormerHead, argmax_classes, resize_bilinear
from .projections import MultiScaleProjection
from .sd import unet as unet_lib
from .sd import vae as vae_lib
from .sd.layers import GroupNorm
from .sd.scheduler import add_noise, shared_noise


@dataclasses.dataclass(frozen=True)
class MADMConfig:
    """The fields the eval pass reads; defaults are the flagship config
    (full SD-v1.4, 512x512, bf16, 11 classes, s0+s3/s4/s5, head 256)."""

    num_classes: int = 11
    unet_block_indices: Tuple[int, ...] = (5, 8, 11)
    out_features: Tuple[str, ...] = ("s0", "s3", "s4", "s5")
    feature_dims: Tuple[int, ...] = (3, 320, 640, 1280)
    projection_dim: Tuple[int, ...] = (128, 512, 512, 512)
    in_keys: Tuple[str, ...] = ("s0", "s3", "s4", "s5")
    head_channels: int = 256
    same_cond_params: bool = True
    compute_dtype: torch.dtype = torch.bfloat16
    unet_channels: Optional[Tuple[int, ...]] = None  # None: SD-v1.4 widths
    vae_channels: Optional[Tuple[int, ...]] = None
    crop_size: Tuple[int, int] = (512, 512)

    @property
    def latent_size(self) -> Tuple[int, int]:
        return (self.crop_size[0] // 8, self.crop_size[1] // 8)

    @property
    def use_s0(self) -> bool:
        return "s0" in self.out_features


class MADM(nn.Module):
    def __init__(self, config: MADMConfig = MADMConfig(), device: str | torch.device = "cuda"):
        super().__init__()
        cfg = self.cfg = config
        self.device = resolve_device(device)
        unet_ch = tuple(cfg.unet_channels or unet_lib.BLOCK_OUT_CHANNELS)
        vae_ch = tuple(cfg.vae_channels or vae_lib.BLOCK_OUT_CHANNELS)

        up = tuple(reversed(unet_ch))
        expected = ([3] if cfg.use_s0 else []) + [up[i // 3] for i in reversed(cfg.unet_block_indices)]
        if list(cfg.feature_dims) != expected:
            raise ValueError(f"feature_dims {tuple(cfg.feature_dims)} does not match the "
                             f"backbone's tap channels {tuple(expected)}")

        with torch.device(self.device):
            self.vae = vae_lib.AutoencoderKL(vae_ch)
            self.unet = unet_lib.UNet2DCondition(unet_ch, cfg.unet_block_indices)
            domains = ["clip_project_rgb"] + ([] if cfg.same_cond_params else ["clip_project_others"])
            self.prompt = nn.ModuleDict(
                {k: prompt_lib.ClipFeatureProject(unet_ch[0] * 4) for k in domains}
            )
            self.feature_projections = MultiScaleProjection(
                cfg.feature_dims, cfg.projection_dim, cfg.out_features)
            self.sem_seg_head = DAFormerHead(cfg.projection_dim, cfg.in_keys, cfg.num_classes,
                                             channels=cfg.head_channels)
        self.register_buffer("uncond_inputs", torch.zeros(1, 77, 768, device=self.device))
        noise = torch.from_numpy(shared_noise(*cfg.latent_size)).permute(0, 3, 1, 2)
        self.register_buffer("shared_noise", noise.contiguous().to(self.device))
        self.to(dtype=cfg.compute_dtype)
        self.eval()
        self.requires_grad_(False)

    # ---------------------------------------------------------- backbone
    def _images(self, images) -> torch.Tensor:
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"images must be NHWC [B, H, W, 3], got {tuple(x.shape)}")
        return x

    @torch.no_grad()
    def backbone_forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One diffusion feature pass (the 'others' domain, t = 0): NHWC
        images in [0, 1] -> {name: NCHW projected feature}."""
        cfg = self.cfg
        x = (self._images(images) * 2.0 - 1.0).permute(0, 3, 1, 2).to(cfg.compute_dtype)
        b = x.shape[0]
        latents = self.vae.encode(x)
        timesteps = torch.zeros(b, dtype=torch.long, device=self.device)
        noisy = add_noise(latents, self.shared_noise.expand_as(latents).to(latents.dtype), timesteps)
        cond_prompt, cond_time = prompt_lib.conditioning(
            self.prompt, self.uncond_inputs, "others", cfg.same_cond_params, b)
        eps, taps = self.unet(noisy, timesteps, cond_prompt, cond_time)
        feats: List[torch.Tensor] = []
        if cfg.use_s0:
            feats.append(self.vae.decode(eps))
        feats.extend(reversed(taps))  # taps arrive smallest-resolution first
        return self.feature_projections(feats)

    # -------------------------------------------------------------- head
    def head_ids(self, features: Dict[str, torch.Tensor], image_hw) -> torch.Tensor:
        """Argmax ids [B, H, W]: kernel K2's head where the head config fits
        it, else the module head."""
        if aspp.fits_kernel(self.sem_seg_head):  # s0 leads: the head runs at image resolution
            return aspp.aspp_head_forward(self.sem_seg_head, features)
        logits = self.sem_seg_head(features)
        if tuple(logits.shape[2:]) != tuple(image_hw):
            logits = resize_bilinear(logits.float(), image_hw)
        return argmax_classes(logits)

    # --------------------------------------------------------- eval pass
    @torch.no_grad()
    def eval_forward(self, images) -> torch.Tensor:
        """Logits [B, H, W, num_classes] fp32 through the module head."""
        x = self._images(images)
        logits = self.sem_seg_head(self.backbone_forward(x))
        return resize_bilinear(logits.float(), x.shape[1:3]).permute(0, 2, 3, 1)

    @torch.no_grad()
    def eval_forward_ids(self, images) -> torch.Tensor:
        """Argmax ids [B, H, W] int32 — the inference hot path."""
        x = self._images(images)
        return self.head_ids(self.backbone_forward(x), x.shape[1:3])


def init_random_(model: MADM, generator: torch.Generator) -> MADM:
    """Seeded random weights, for running without a checkpoint: convs and
    linears N(0, 1/fan_in) with zero bias, norms at identity, BN statistics
    (0, 1), conv_seg N(0, 0.01^2), prompt and time embeds N(0, 0.02^2),
    prompt blend weights U[0, 1), time blend weight 0.  ``generator`` must
    live on the model's device."""
    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device, dtype=torch.float32) * std)

    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                normal(m.weight, 0.01 if name.endswith("conv_seg") else fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, (nn.LayerNorm, GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, prompt_lib.ClipFeatureProject):
                normal(m.prompt_embed, 0.02)
                normal(m.time_embed, 0.02)
                for p in (m.alpha_cond_prompt, m.alpha_uncond_prompt):
                    p.copy_(torch.rand(p.shape, generator=generator, device=p.device))
                m.alpha_cond_time.zero_()
    return model

