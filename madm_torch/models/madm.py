"""MADM: diffusion feature extractor + DAFormer head (port of
``madm_tpu/models/madm.py``: the single-crop eval pass and the shipped
branches of the train-side backbone and head).

One ``nn.Module`` holds every weight under checkpoint-style names (``vae``,
``unet``, ``prompt.clip_project_rgb``, ``feature_projections``,
``sem_seg_head``) plus the constants ``uncond_inputs`` and ``shared_noise``.
Public inputs and outputs keep the JAX layout: images NHWC [B, H, W, 3] in
[0, 1], logits NHWC, ids [B, H, W] int32.

Built with ``trainable=True`` the module is what flax's ``param_dtype=fp32,
dtype=compute_dtype`` gives: fp32 master parameters (and, in the optimizer,
fp32 moments), cast to the compute dtype at each use so that convs, linears
and kernels K1/K3 run in it; the frozen VAE is kept in the compute dtype.
It also holds the EMA teacher's copies (``ema.feature_projections``,
``ema.sem_seg_head`` with its BN statistics, ``ema.clip_project_others``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..device import resolve_device
from ..ops import aspp
from . import prompt as prompt_lib
from .daformer import DAFormerHead, argmax_classes, resize_bilinear
from .projections import MultiScaleProjection
from .sd import unet as unet_lib
from .sd import vae as vae_lib
from .sd.layers import GroupNorm
from .sd.scheduler import add_noise, shared_noise

# MADMConfig fields of the JAX package whose other branches the port has not
# taken yet, with the one value it takes; setting another raises
_UNPORTED = {"finetune_unet": "all", "lora_configs": (), "ema_w_unet": False,
             "slide_training": False}


@dataclasses.dataclass(frozen=True)
class MADMConfig:
    """The fields the eval pass and the shipped train step read; defaults are
    the flagship config (full SD-v1.4, 512x512, bf16, 11 classes,
    s0+s3/s4/s5, head 256)."""

    num_classes: int = 11
    unet_block_indices: Tuple[int, ...] = (5, 8, 11)
    out_features: Tuple[str, ...] = ("s0", "s3", "s4", "s5")
    feature_dims: Tuple[int, ...] = (3, 320, 640, 1280)
    projection_dim: Tuple[int, ...] = (128, 512, 512, 512)
    in_keys: Tuple[str, ...] = ("s0", "s3", "s4", "s5")
    head_channels: int = 256
    same_cond_params: bool = True
    finetune_unet: str = "all"  # the whole UNet trains (but conv_norm_out / conv_out)
    compute_dtype: torch.dtype = torch.bfloat16
    unet_channels: Optional[Tuple[int, ...]] = None  # None: SD-v1.4 widths
    vae_channels: Optional[Tuple[int, ...]] = None
    crop_size: Tuple[int, int] = (512, 512)
    lora_configs: Tuple[str, ...] = ()
    ema_w_unet: bool = False
    slide_training: bool = False

    def __post_init__(self):
        for name, value in _UNPORTED.items():
            if getattr(self, name) != value:
                raise NotImplementedError(f"MADMConfig.{name} is not ported to madm_torch yet")

    @property
    def latent_size(self) -> Tuple[int, int]:
        return (self.crop_size[0] // 8, self.crop_size[1] // 8)

    @property
    def use_s0(self) -> bool:
        return "s0" in self.out_features


def trainable_parameters(model: "MADM") -> List[Tuple[str, nn.Parameter]]:
    """(name, parameter) of everything the optimizer updates: the UNet
    (``finetune_unet='all'``) but ``conv_norm_out``/``conv_out``, which lie
    downstream of the last tap, and the prompts, projections and head.  The
    VAE and the EMA copies are frozen (the JAX package's ``split_trainable``)."""
    frozen = ("vae.", "ema.", "unet.conv_norm_out.", "unet.conv_out.")
    return [(n, p) for n, p in model.named_parameters() if not n.startswith(frozen)]


class MADM(nn.Module):
    def __init__(self, config: MADMConfig = MADMConfig(), device: str | torch.device = "cuda",
                 trainable: bool = False):
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
            if trainable:
                self.ema = nn.ModuleDict({
                    "feature_projections": MultiScaleProjection(
                        cfg.feature_dims, cfg.projection_dim, cfg.out_features),
                    "sem_seg_head": DAFormerHead(cfg.projection_dim, cfg.in_keys, cfg.num_classes,
                                                 channels=cfg.head_channels),
                    "clip_project_others": prompt_lib.ClipFeatureProject(unet_ch[0] * 4),
                })
        self.register_buffer("uncond_inputs", torch.zeros(1, 77, 768, device=self.device))
        noise = torch.from_numpy(shared_noise(*cfg.latent_size)).permute(0, 3, 1, 2)
        self.register_buffer("shared_noise", noise.contiguous().to(self.device))
        self.eval()
        self.requires_grad_(False)
        # fp32 masters under a narrower compute dtype are cast at each use
        self._cast_params = trainable and cfg.compute_dtype != torch.float32
        if trainable:
            self.reset_ema_()
            self.vae.to(dtype=cfg.compute_dtype)  # frozen: one cast instead of one per pass
            for _, p in trainable_parameters(self):
                p.requires_grad_(True)
        else:
            self.to(dtype=cfg.compute_dtype)

    # ------------------------------------------------------------ teacher
    def student_ema_pairs(self) -> List[Tuple[nn.Module, nn.Module]]:
        """(EMA module, student module) pairs of the teacher's tree."""
        others = "clip_project_rgb" if self.cfg.same_cond_params else "clip_project_others"
        return [(self.ema["feature_projections"], self.feature_projections),
                (self.ema["sem_seg_head"], self.sem_seg_head),
                (self.ema["clip_project_others"], self.prompt[others])]

    @torch.no_grad()
    def reset_ema_(self) -> None:
        """Teacher := student, head BN statistics included (JAX ``init_ema``
        and ``ema_head_bn``)."""
        for ema, student in self.student_ema_pairs():
            ema.load_state_dict(student.state_dict())

    def _compute(self, module: nn.Module):
        """``module`` as a callable with its parameters in the compute dtype:
        the module itself when they already are, else a ``functional_call``
        on differentiable casts of the fp32 masters (its buffers, the BN
        running statistics among them, stay the module's own)."""
        if not self._cast_params:
            return module
        cast = {n: p.to(self.cfg.compute_dtype) for n, p in module.named_parameters()}
        return lambda *args, **kwargs: functional_call(module, cast, args, kwargs)

    # ---------------------------------------------------------- backbone
    def _images(self, images) -> torch.Tensor:
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"images must be NHWC [B, H, W, 3], got {tuple(x.shape)}")
        return x

    def backbone_forward(self, images, *, input_modal: str = "others", ema_forward: bool = False,
                         timesteps: Optional[torch.Tensor] = None, train: bool = False,
                         ) -> Dict[str, object]:
        """One diffusion feature pass: NHWC images in [0, 1] ->
        ``{'output_features': {name: NCHW}, 'before_vae_decoder': eps,
        'after_vae_decoder': clip(decoded eps, -1, 1)}`` (the decoder entries
        when s0 is tapped; the clipped one on train and teacher passes only,
        which read it).  ``timesteps`` [B] (default 0) noise the latent;
        ``ema_forward`` takes the teacher's prompt and projections;
        ``train`` builds the autograd graph.  The VAE runs without one: the
        encoder is frozen, and the s0 decoder reads ``eps.detach()`` (JAX
        stops the gradient at its output), so no gradient reaches the VAE's
        D=512 attention."""
        cfg = self.cfg
        vae_dtype = self.vae.quant_conv.weight.dtype
        x = (self._images(images) * 2.0 - 1.0).permute(0, 3, 1, 2).to(vae_dtype)
        b = x.shape[0]
        with torch.no_grad():
            latents = self.vae.encode(x)
        if timesteps is None:
            timesteps = torch.zeros(b, dtype=torch.long, device=self.device)
        timesteps = torch.as_tensor(timesteps, device=self.device).long().expand(b)
        noisy = add_noise(latents, self.shared_noise.expand_as(latents).to(latents.dtype), timesteps)
        with torch.set_grad_enabled(train):
            if ema_forward:
                p = self.ema["clip_project_others"]
            else:
                p = prompt_lib.select_domain_params(self.prompt, input_modal, cfg.same_cond_params)
            cond_prompt, cond_time = prompt_lib.conditioning_of(p, self.uncond_inputs, b)
            eps, taps = self._compute(self.unet)(noisy, timesteps, cond_prompt, cond_time)
            out: Dict[str, object] = {}
            feats: List[torch.Tensor] = []
            if cfg.use_s0:
                with torch.no_grad():
                    dec = self.vae.decode(eps.detach().to(vae_dtype))
                out["before_vae_decoder"] = eps
                if train or ema_forward:
                    out["after_vae_decoder"] = dec.clamp(-1.0, 1.0)
                feats.append(dec)
            feats.extend(reversed(taps))  # taps arrive smallest-resolution first
            proj = self.ema["feature_projections"] if ema_forward else self.feature_projections
            out["output_features"] = self._compute(proj)(feats)
        return out

    # -------------------------------------------------------------- head
    def head_forward(self, features: Dict[str, torch.Tensor], *, ema_forward: bool = False,
                     train: bool = False, update_bn: bool = False,
                     dropout: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Module-head logits [B, C, h, w] in the compute dtype.  ``train``
        normalises by batch statistics; ``update_bn`` then folds them into the
        running statistics (momentum 0.9, biased variance); ``dropout`` is a
        channel multiplier [B, head_channels] (0 or 1/(1-p)).  The teacher's
        head and its statistics are the EMA copies."""
        head = self.ema["sem_seg_head"] if ema_forward else self.sem_seg_head
        return self._compute(head)(features, train=train, update_bn=update_bn, dropout=dropout)

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
        logits = self.sem_seg_head(self.backbone_forward(x)["output_features"])
        return resize_bilinear(logits.float(), x.shape[1:3]).permute(0, 2, 3, 1)

    @torch.no_grad()
    def eval_forward_ids(self, images) -> torch.Tensor:
        """Argmax ids [B, H, W] int32 — the inference hot path."""
        x = self._images(images)
        return self.head_ids(self.backbone_forward(x)["output_features"], x.shape[1:3])


def init_random_(model: MADM, generator: torch.Generator) -> MADM:
    """Seeded random weights, for running without a checkpoint: convs and
    linears N(0, 1/fan_in) with zero bias, norms at identity, BN statistics
    (0, 1), conv_seg N(0, 0.01^2), prompt and time embeds N(0, 0.02^2),
    prompt blend weights U[0, 1), time blend weight 0.  A trainable model's
    teacher starts as a copy of the student.  ``generator`` must live on the
    model's device."""
    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device, dtype=torch.float32) * std)

    with torch.no_grad():
        for name, m in model.named_modules():
            if name.startswith("ema"):
                continue
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
        if hasattr(model, "ema"):
            model.reset_ema_()
    return model
