"""MADM: diffusion feature extractor + DAFormer head (port of
``madm_tpu/models/madm.py``: the eval passes, single-crop and sliding-window,
with their four eval heads, the shipped branches of the train-side backbone
and head, and LoRA adapters).

One ``nn.Module`` holds every weight under checkpoint-style names (``vae``,
``unet``, ``prompt.clip_project_rgb``, ``feature_projections``,
``sem_seg_head``, the adapters ``lora.<name>``) plus the constants
``uncond_inputs`` and ``shared_noise``.
Public inputs and outputs keep the JAX layout: images NHWC [B, H, W, 3] in
[0, 1], logits NHWC, ids [B, H, W] int32.

Built with ``trainable=True`` the module is what flax's ``param_dtype=fp32,
dtype=compute_dtype`` gives: fp32 master parameters (and, in the optimizer,
fp32 moments), cast to the compute dtype at each use so that convs, linears
and kernels K1/K3 run in it; the frozen VAE is kept in the compute dtype.
It also holds the EMA teacher's copies (``ema.feature_projections``,
``ema.sem_seg_head`` with its BN statistics, ``ema.clip_project_others``).
Eval passes read the student, never the teacher, as JAX's read ``params``.

``lora_name`` on a pass merges that adapter into the UNet's attention
projections for the pass alone (``sd.lora.merge_lora``, functionally, in
fp32, then cast as the masters are; JAX ``madm.py:703-708``).  The adapters
stay fp32 in an eval model too, whose bf16 weights are then rounded once.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..device import resolve_device
from ..ops import aspp
from . import prompt as prompt_lib
from .daformer import DAFormerHead, argmax_classes, resize_bilinear
from .projections import MultiScaleProjection
from .sd import lora as lora_lib
from .sd import unet as unet_lib
from .sd import vae as vae_lib
from .sd.layers import GroupNorm
from .sd.scheduler import add_noise, shared_noise

# MADMConfig fields of the JAX package whose other branches the port has not
# taken yet, with the one value it takes; setting another raises
_UNPORTED = {"finetune_unet": "all", "ema_w_unet": False, "slide_training": False}
# eval heads of ``eval_forward_ids`` ('auto': 'aspp' where the head fits it, else 'none')
EVAL_HEADS = ("auto", "aspp", "argmax", "full", "none")


@dataclasses.dataclass(frozen=True)
class MADMConfig:
    """The fields the eval pass and the shipped train step read; defaults are
    the flagship config (full SD-v1.4, 512x512, bf16, 11 classes,
    s0+s3/s4/s5, head 256)."""

    num_classes: int = 11
    target_modality: str = "Depth"  # the adapter that eval and the target passes take
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
    lora_configs: Tuple[str, ...] = ()  # e.g. ('default_r16_a16', 'Depth_r16_a8')
    # seed each learned prompt_embed from uncond_inputs when an SD snapshot's
    # text encoder recomputes them (madm_torch.main; reference ldm_base.py:648-650)
    init_uncond_prompt: bool = False
    ema_w_unet: bool = False
    slide_training: bool = False
    # the eval head of eval_forward_ids (the JAX package's MADM_FUSED_HEAD):
    # 'aspp' the module embeds and kernel K2 for the fuse layer; 'argmax'
    # the module head to the bottleneck, then K7; 'full' K6 for the dilated
    # depthwise convs and K7; 'none' the module head and an argmax
    eval_head: str = "auto"
    # the packed-head attention path (the JAX package's MADM_FLASH_PACK, off
    # by default as there): the UNet self-attentions that pack_group picks
    # run kernels K4/K5 in place of K1/K3
    flash_pack: bool = False

    def __post_init__(self):
        for name, value in _UNPORTED.items():
            if getattr(self, name) != value:
                raise NotImplementedError(f"MADMConfig.{name} is not ported to madm_torch yet")
        if self.eval_head not in EVAL_HEADS:
            raise ValueError(f"MADMConfig.eval_head {self.eval_head!r} is not one of {EVAL_HEADS}")
        lora_lib.parse_lora_configs(self.lora_configs)

    @property
    def latent_size(self) -> Tuple[int, int]:
        return (self.crop_size[0] // 8, self.crop_size[1] // 8)

    @property
    def use_s0(self) -> bool:
        return "s0" in self.out_features


def trainable_parameters(model: "MADM") -> List[Tuple[str, nn.Parameter]]:
    """(name, parameter) of everything the optimizer updates: the UNet
    (``finetune_unet='all'``) but ``conv_norm_out``/``conv_out``, which lie
    downstream of the last tap, the LoRA adapters, and the prompts,
    projections and head.  The VAE and the EMA copies are frozen (the JAX
    package's ``split_trainable``)."""
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
            self.unet = unet_lib.UNet2DCondition(unet_ch, cfg.unet_block_indices, cfg.flash_pack)
            domains = ["clip_project_rgb"] + ([] if cfg.same_cond_params else ["clip_project_others"])
            self.prompt = nn.ModuleDict(
                {k: prompt_lib.ClipFeatureProject(unet_ch[0] * 4) for k in domains}
            )
            self.feature_projections = MultiScaleProjection(
                cfg.feature_dims, cfg.projection_dim, cfg.out_features)
            self.sem_seg_head = DAFormerHead(cfg.projection_dim, cfg.in_keys, cfg.num_classes,
                                             channels=cfg.head_channels)
            self.lora_specs = lora_lib.parse_lora_configs(cfg.lora_configs)
            if self.lora_specs:
                self.lora = nn.ModuleDict({name: lora_lib.LoRAAdapter(self.unet, spec["rank"])
                                           for name, spec in self.lora_specs.items()})
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
            if self.lora_specs:
                self.lora.float()  # merged in fp32 into the bf16 weights, rounded once

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

    def _compute(self, module: nn.Module, weights: Optional[Dict[str, torch.Tensor]] = None):
        """``module`` as a callable with its parameters in the compute dtype:
        the module itself when they already are and ``weights`` is empty,
        else a ``functional_call`` on differentiable casts of the fp32
        masters, with ``weights`` (name -> tensor, e.g. merged LoRA sites)
        in place of the module's own; its buffers, the BN running statistics
        among them, stay the module's own."""
        weights = dict(weights or {})
        if self._cast_params:
            weights = {n: weights.get(n, p).to(self.cfg.compute_dtype)
                       for n, p in module.named_parameters()}
        if not weights:
            return module
        return lambda *args, **kwargs: functional_call(module, weights, args, kwargs)

    def lora_weights(self, lora_name: Optional[str]) -> Dict[str, torch.Tensor]:
        """The UNet weights that adapter ``lora_name`` changes, merged at
        scale alpha / rank (empty for ``None`` or a name the model does not
        hold, as JAX ``backbone_forward`` skips the merge)."""
        if lora_name is None or lora_name not in self.lora_specs:
            return {}
        spec = self.lora_specs[lora_name]
        adapter = self.lora[lora_name]
        sites = {f"{path}.weight" for path, _ in adapter.sites()}
        base = {n: p for n, p in self.unet.named_parameters() if n in sites}
        return lora_lib.merge_lora(base, adapter, spec["alpha"] / spec["rank"])

    # ---------------------------------------------------------- backbone
    def _images(self, images) -> torch.Tensor:
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"images must be NHWC [B, H, W, 3], got {tuple(x.shape)}")
        return x

    def backbone_forward(self, images, *, input_modal: str = "others",
                         lora_name: Optional[str] = None, ema_forward: bool = False,
                         timesteps: Optional[torch.Tensor] = None, train: bool = False,
                         ) -> Dict[str, object]:
        """One diffusion feature pass: NHWC images in [0, 1] ->
        ``{'output_features': {name: NCHW}, 'before_vae_decoder': eps,
        'after_vae_decoder': clip(decoded eps, -1, 1)}`` (the decoder entries
        when s0 is tapped; the clipped one on train and teacher passes only,
        which read it).  ``timesteps`` [B] (default 0) noise the latent;
        ``lora_name`` merges that adapter into the UNet for this pass;
        ``ema_forward`` takes the teacher's prompt and projections (and the
        student's UNet and adapter, as JAX does without ``ema_w_unet``);
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
            unet = self._compute(self.unet, self.lora_weights(lora_name))
            eps, taps = unet(noisy, timesteps, cond_prompt, cond_time)
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

    def _eval_head(self) -> DAFormerHead:
        """The student head for eval passes in the compute dtype: the head
        itself, or, over fp32 masters, a copy whose convs and linears hold
        compute-dtype casts while BN keeps its fp32 affine and statistics
        (eval BN then normalises in fp32, as flax promotes it, and the
        kernel heads fold BN in fp32)."""
        head = self.sem_seg_head
        if not self._cast_params:
            return head
        head = copy.deepcopy(head)
        for m in head.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(self.cfg.compute_dtype)
        return head

    def eval_head_mode(self, eval_head: Optional[str] = None) -> str:
        """The eval head ``eval_forward_ids`` runs: ``eval_head``, else the
        config's.  The kernel heads give ids at the first feature's
        resolution, so they need the head to lead with s0 on 4 inputs;
        'aspp' and 'full' also need dilations 1/6/12/18 and 256-wide embeds
        and branches (JAX ``_eval_head_mode``, without its TPU tiling
        rules).  'auto' takes 'aspp' where the head fits it, else 'none'; a
        head asked for by name that the model does not fit raises."""
        mode = eval_head or self.cfg.eval_head
        if mode not in EVAL_HEADS:
            raise ValueError(f"eval head {mode!r} is not one of {EVAL_HEADS}")
        head = self.sem_seg_head
        at_image_res = len(head.in_keys) == 4 and head.in_keys[0] == "s0"
        fits = {"aspp": aspp.fits_kernel(head), "full": aspp.fits_kernel(head),
                "argmax": at_image_res, "none": True}
        if mode == "auto":
            return "aspp" if fits["aspp"] else "none"
        if not fits[mode]:
            raise ValueError(
                f"eval head {mode!r} does not fit this head (in_keys {head.in_keys}, dilations "
                f"{head.dilations}, embed_dims {head.embed_dims}, channels {head.channels})")
        return mode

    @torch.no_grad()
    def head_ids(self, features: Dict[str, torch.Tensor], image_hw,
                 eval_head: Optional[str] = None) -> torch.Tensor:
        """Argmax ids [B, H, W] int32 from NCHW features, through the eval
        head that ``eval_head_mode`` picks (shared by the single-crop and
        the sliding-window passes)."""
        mode = self.eval_head_mode(eval_head)
        head = self._eval_head()
        if mode == "aspp":
            return _chunk_over_batch(lambda f: aspp.aspp_head_forward(head, f), features,
                                     _head_chunk(image_hw))
        if mode == "full":
            return aspp.fused_head_forward(head, features)
        if mode == "argmax":
            return aspp.argmax_head_forward(head, features)
        return _ids_from_logits(head(features), image_hw)

    # -------------------------------------------------------- eval passes
    def _eval_timesteps(self, b: int, eval_with_noise: Optional[int]) -> Optional[torch.Tensor]:
        """``eval_with_noise``: a fixed noise timestep for every image of a
        test batch (reference ``mtmadise.py:681-682``), else t = 0."""
        if eval_with_noise is None:
            return None
        return torch.full((b,), int(eval_with_noise), dtype=torch.long, device=self.device)

    @torch.no_grad()
    def eval_forward(self, images, eval_with_noise: Optional[int] = None,
                     lora_name: Optional[str] = None) -> torch.Tensor:
        """Logits [B, H, W, num_classes] fp32 through the module head."""
        x = self._images(images)
        feats = self.backbone_forward(
            x, lora_name=lora_name,
            timesteps=self._eval_timesteps(x.shape[0], eval_with_noise))["output_features"]
        logits = self._eval_head()(feats)
        return resize_bilinear(logits.float(), x.shape[1:3]).permute(0, 2, 3, 1)

    @torch.no_grad()
    def eval_forward_ids(self, images, eval_with_noise: Optional[int] = None,
                         eval_head: Optional[str] = None,
                         lora_name: Optional[str] = None) -> torch.Tensor:
        """Argmax ids [B, H, W] int32 — the inference hot path.
        ``eval_head`` overrides ``MADMConfig.eval_head`` for this call;
        ``lora_name`` picks the adapter (JAX: the target modality's)."""
        x = self._images(images)
        feats = self.backbone_forward(
            x, lora_name=lora_name,
            timesteps=self._eval_timesteps(x.shape[0], eval_with_noise))["output_features"]
        return self.head_ids(feats, x.shape[1:3], eval_head)

    # ------------------------------------------------- sliding-window pass
    def slide_windows(self, h: int, w: int) -> Tuple[Tuple[int, int, int, int], ...]:
        """(y1, y2, x1, x2) crops covering (h, w) at half-crop stride; for
        512x1024 exactly the reference's three, ``feature_extractor.py:75``."""
        ch, cw = self.cfg.crop_size
        ys = sorted({min(y, h - ch) for y in range(0, max(h - ch, 0) + 1, max(ch // 2, 1))})
        xs = sorted({min(x, w - cw) for x in range(0, max(w - cw, 0) + 1, max(cw // 2, 1))})
        return tuple((y, y + ch, x, x + cw) for y in ys for x in xs)

    @torch.no_grad()
    def slide_backbone_forward(self, images, *, windows=None,
                               timesteps: Optional[torch.Tensor] = None, form: str = "batch",
                               lora_name: Optional[str] = None,
                               ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Sliding-window backbone (JAX ``slide_backbone_forward``, reference
        ``slide_forward``, ``feature_extractor.py:199-278``): each window's
        features added into canvases of the feature dtype and scaled by the
        reciprocal of the overlap counts.  ``form='window'`` runs one
        backbone pass a window, so only one window's features live at a
        time; ``form='batch'`` runs all windows as one pass of B * n_win
        crops, with fewer launches.  ``timesteps`` [B] and ``lora_name`` go
        to every window.
        Returns ``{'output_features': {name: NCHW}}`` at image resolution
        over each stride."""
        x = self._images(images)
        b, h, w, _ = x.shape
        windows = tuple(windows or self.slide_windows(h, w))
        if form == "window":
            per_window = ((win, self.backbone_forward(x[:, win[0]:win[1], win[2]:win[3]],
                                                      lora_name=lora_name,
                                                      timesteps=timesteps)["output_features"])
                          for win in windows)
        elif form == "batch":
            crops = torch.cat([x[:, y1:y2, x1:x2] for y1, y2, x1, x2 in windows], dim=0)
            if timesteps is not None:
                timesteps = torch.as_tensor(timesteps, device=self.device).expand(b).repeat(len(windows))
            feats = self.backbone_forward(crops, lora_name=lora_name,
                                          timesteps=timesteps)["output_features"]
            per_window = ((win, {k: f[i * b:(i + 1) * b] for k, f in feats.items()})
                          for i, win in enumerate(windows))
        else:
            raise ValueError(f"slide form {form!r} is not 'window' or 'batch'")
        strides = {name: 2 ** int(name[1]) for name in self.cfg.out_features}
        canvases: Dict[str, torch.Tensor] = {}
        counts = {name: np.zeros((h // s, w // s), np.float32) for name, s in strides.items()}
        for (y1, y2, x1, x2), window_feats in per_window:
            for name, s in strides.items():
                f = window_feats[name]
                if name not in canvases:
                    canvases[name] = f.new_zeros((b, f.shape[1], h // s, w // s))
                canvases[name][:, :, y1 // s:y2 // s, x1 // s:x2 // s] += f
                counts[name][y1 // s:y2 // s, x1 // s:x2 // s] += 1.0
        return {"output_features": {
            name: canvas * torch.from_numpy(1.0 / counts[name]).to(canvas.device, canvas.dtype)
            for name, canvas in canvases.items()}}


def _chunk_over_batch(fn: Callable, feats: Dict[str, torch.Tensor], chunk: int) -> torch.Tensor:
    """A per-image-independent ``fn`` over batch chunks of ``feats``, its
    outputs concatenated: bounds the head's full-resolution intermediates,
    which scale with B*H*W."""
    b = next(iter(feats.values())).shape[0]
    if b <= chunk:
        return fn(feats)
    return torch.cat([fn({k: v[i:i + chunk] for k, v in feats.items()})
                      for i in range(0, b, chunk)], dim=0)


def _head_chunk(image_hw) -> int:
    """Images per 'aspp' head call (JAX ``head_ids``): one where the image is
    wider than 512 pixels (the sliding window's stitched features), else up
    to eight 512x512 crops' worth of pixels."""
    h, w = (int(v) for v in image_hw)
    return 1 if w > 512 else max(1, (8 * 512 * 512) // (h * w))


def _ids_from_logits(logits: torch.Tensor, hw) -> torch.Tensor:
    """Argmax ids at image resolution from NCHW logits; the resize (in fp32)
    only where the head ran below it."""
    if tuple(logits.shape[2:]) != tuple(hw):
        logits = resize_bilinear(logits.float(), hw)
    return argmax_classes(logits)


def init_random_(model: MADM, generator: torch.Generator) -> MADM:
    """Seeded random weights, for running without a checkpoint: convs and
    linears N(0, 1/fan_in) with zero bias, norms at identity, BN statistics
    (0, 1), conv_seg N(0, 0.01^2), prompt and time embeds N(0, 0.02^2),
    prompt blend weights U[0, 1), time blend weight 0, LoRA adapters at
    peft's init (A ~ N(0, 1) / rank, B = 0).  A trainable model's
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
            elif isinstance(m, lora_lib.LoRAAdapter):
                lora_lib.reset_lora_(m, generator)
        if hasattr(model, "ema"):
            model.reset_ema_()
    return model
