"""MADM: diffusion feature extractor + DAFormer head (port of
``madm_tpu/models/madm.py``: the eval passes, single-crop and sliding-window,
with their four eval heads, the train-side backbone and head with the UDA
step's ablation knobs, LoRA adapters, the model variants: attention
capture, the head's fusions, the second head, conv_in surgery and the
prompt structures, and the CLIP image prefix).

One ``nn.Module`` holds every weight under checkpoint-style names (``vae``,
``unet``, ``prompt.clip_project_rgb``, ``feature_projections``,
``sem_seg_head``, the adapters ``lora.<name>``, and where configured
``sem_seg_head_sec_modal``, ``pixel_unshuffle`` and the CLIP tower
``clip_vision``) plus the constants
``uncond_inputs`` and ``shared_noise``.
Public inputs and outputs keep the JAX layout: images NHWC [B, H, W, 3] in
[0, 1], logits NHWC, ids [B, H, W] int32.

Built with ``trainable=True`` the module is what flax's ``param_dtype=fp32,
dtype=compute_dtype`` gives: fp32 master parameters (and, in the optimizer,
fp32 moments), cast to the compute dtype at each use so that convs, linears
and kernels K1/K3 run in it; the frozen VAE is kept in the compute dtype.
It also holds the EMA teacher's copies (``ema.feature_projections``,
``ema.sem_seg_head`` with its BN statistics, ``ema.clip_project_others``,
under ``ema_w_unet`` ``ema.unet`` and ``ema.lora``, and under
'learnable_clip' ``ema.clip_vision``, which the teacher's passes then
run).  Eval passes read the student, never the teacher, as JAX's read
``params``.

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
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..device import resolve_device
from ..ops import aspp
from ..parallel import dist as dist_lib
from . import clip_image
from . import prompt as prompt_lib
from .daformer import HEAD_FUSIONS, DAFormerHead, argmax_classes, global_batch_stats, resize_bilinear
from .projections import MultiScaleProjection
from .sd import lora as lora_lib
from .sd import unet as unet_lib
from .sd import vae as vae_lib
from .sd.layers import GroupNorm
from .sd.scheduler import add_noise, shared_noise

# which UNet weights train (JAX ``unet_trainable_mask``, reference
# ``ldm_diffusers.py:101-121``)
FINETUNE_UNET = ("all", "no", "attention", "without cross-attention")
# eval heads of ``eval_forward_ids`` ('auto': 'aspp' where the head fits it, else 'none')
EVAL_HEADS = ("auto", "aspp", "argmax", "full", "none")
# the CLIP image prefix (reference --with_clip, ldm_base.py:740-760,844-853)
CLIP_STATES = ("no", "no_learnable_clip", "learnable_clip")


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
    finetune_unet: str = "all"  # one of FINETUNE_UNET (see trainable_parameters)
    compute_dtype: torch.dtype = torch.bfloat16
    unet_channels: Optional[Tuple[int, ...]] = None  # None: SD-v1.4 widths
    vae_channels: Optional[Tuple[int, ...]] = None
    crop_size: Tuple[int, int] = (512, 512)
    lora_configs: Tuple[str, ...] = ()  # e.g. ('default_r16_a16', 'Depth_r16_a8')
    # seed each learned prompt_embed from uncond_inputs when an SD snapshot's
    # text encoder recomputes them (madm_torch.main; reference ldm_base.py:648-650)
    init_uncond_prompt: bool = False
    # the teacher keeps EMA copies of the UNet and its adapters and its passes
    # run them (reference --ema_w_unet, cmdise.py:318-321)
    ema_w_unet: bool = False
    # train-time sliding window: a train-step input larger than crop_size
    # goes through slide_backbone_forward (feature_extractor.py:199-278)
    slide_training: bool = False
    # up-block taps after the resnet (+ attention) or, 'in', the concat that
    # enters it
    unet_block_indices_type: str = "after"
    # the head's fuse layer (daformer.HEAD_FUSIONS) and its conv_seg inputs
    # (daformer_head.py:52-88, 608-643)
    head_fusion: str = "aspp"
    final_fuse_vae_decoder_feat: bool = False
    concat_attention_to_conv_seg: bool = False
    # a second head for the target-modality passes and eval (cmdise.py:154-157)
    sem_seg_head_sec_modal: bool = False
    # prompt structure (ldm_base.py:635-673): one prompt per UNet
    # cross-attention layer; no learned prompt and time embed; the prompt
    # without its blend weights
    multi_layer_prompt: bool = False
    without_prompt: bool = False
    without_prompt_alpha: bool = False
    # cross-attention capture (res in the 512-input naming: 64/32/16 down and
    # up, 8 the mid block; location 'down'|'mid'|'up') and its consumers:
    # the target-attention consistency loss, fd on the up-block maps, and the
    # head's conv_seg concat of the maps at attention_select_index's tokens
    # at the largest captured res
    attention_features_res: Tuple[int, ...] = ()
    attention_features_location: Tuple[str, ...] = ()
    target_attention_loss: bool = False
    attention_select_index: Optional[Tuple[int, ...]] = None
    fd_attention: float = 0.0
    # conv_in surgery (ldm_diffusers.py:60-99): mask_diff's per-modality
    # constant channels ('rgb=0_Depth=1'; 'circle' takes 2) and a
    # pixel-unshuffle tower of the grayscale image (64 channels)
    input_channel_plus: int = 0
    mask_diff: Optional[str] = None
    concat_pixel_shuffle: bool = False
    # prompt ablations of backbone_forward's prompt_mode (reference
    # ldm_base.py:893-924): token-row dropout, its detach, gaussian
    # perturbation (always detached), the random prompt's scale
    mask_prompt_ratio: float = 0.0
    detach_mask_prompt: bool = False
    prompt_perturbation: float = 0.0
    rand_prompt_scale: float = 0.5
    prompt_seq_len: Optional[int] = None  # the learned prompts' length (None: 77)
    # the decoder-regression targets' palette: None (the train palette) or
    # 'discrete' (ops.palette.DISCRETE_PALETTE)
    reg_target_palette: Optional[str] = None
    # extra N(0, add_latent_noise^2) on the mixed pass's noisy latent (-1:
    # off), and the noisy latent normalised by its global mean and
    # population std on every pass (ldm_diffusers.py:165-168)
    add_latent_noise: float = -1.0
    norm_latent_noise: bool = False
    # the eval head of eval_forward_ids (the JAX package's MADM_FUSED_HEAD):
    # 'aspp' the module embeds and kernel K2 for the fuse layer; 'argmax'
    # the module head to the bottleneck, then K7; 'full' K6 for the dilated
    # depthwise convs and K7; 'none' the module head and an argmax
    eval_head: str = "auto"
    # the packed-head attention path (the JAX package's MADM_FLASH_PACK, off
    # by default as there): the UNet self-attentions that pack_group picks
    # run kernels K4/K5 in place of K1/K3
    flash_pack: bool = False
    # the CLIP image prefix: 'no' (shipped configs), 'no_learnable_clip' (a
    # frozen tower) or 'learnable_clip' (trained, with an EMA copy for the
    # teacher's passes); the prompt and time embedding are then lifted from
    # the tower's image embedding.  clip_vision: the tower's shape (ViT-L/14-336)
    clip_state: str = "no"
    clip_vision: clip_image.VisionConfig = clip_image.VisionConfig()

    def __post_init__(self):
        if self.finetune_unet not in FINETUNE_UNET:
            raise ValueError(f"MADMConfig.finetune_unet {self.finetune_unet!r} is not one of "
                             f"{FINETUNE_UNET}")
        if self.unet_block_indices_type not in ("in", "after"):
            raise ValueError(f"MADMConfig.unet_block_indices_type {self.unet_block_indices_type!r} "
                             "is not 'in' or 'after'")
        if self.head_fusion not in HEAD_FUSIONS:
            raise ValueError(f"MADMConfig.head_fusion {self.head_fusion!r} is not one of {HEAD_FUSIONS}")
        if self.eval_head not in EVAL_HEADS:
            raise ValueError(f"MADMConfig.eval_head {self.eval_head!r} is not one of {EVAL_HEADS}")
        if self.clip_state not in CLIP_STATES:
            raise ValueError(f"MADMConfig.clip_state {self.clip_state!r} is not one of {CLIP_STATES}")
        lora_lib.parse_lora_configs(self.lora_configs)

    @property
    def latent_size(self) -> Tuple[int, int]:
        return (self.crop_size[0] // 8, self.crop_size[1] // 8)

    @property
    def use_s0(self) -> bool:
        return "s0" in self.out_features

    @property
    def unet_in_channels(self) -> int:
        """conv_in's input channels after surgery (ldm_diffusers.py:60-99)."""
        return 4 + self.input_channel_plus + (64 if self.concat_pixel_shuffle else 0)

    @property
    def mask_values(self) -> Dict[str, float]:
        """mask_diff's per-modality constants, 'rgb=0_Depth=1' (mtmadise.py:66-75)."""
        if not self.mask_diff or self.mask_diff == "circle":
            return {}
        return {name: float(val) for name, val in (part.split("=") for part in self.mask_diff.split("_"))}


def _unet_trains(name: str, mode: str) -> bool:
    """Whether UNet parameter ``name`` (relative to the UNet) trains under
    ``finetune_unet=mode`` (JAX ``unet_trainable_mask``): never
    ``conv_norm_out``/``conv_out``, which lie downstream of the last tap;
    'attention' only the transformer blocks' weights; 'without
    cross-attention' all but the cross-attentions ('attn2')."""
    parts = name.split(".")
    if mode == "no" or parts[0] in ("conv_norm_out", "conv_out"):
        return False
    in_attn = "attentions" in parts
    if mode == "attention":
        return in_attn
    if mode == "without cross-attention":
        return not (in_attn and "attn2" in parts)
    return True


def trainable_parameters(model: "MADM") -> List[Tuple[str, nn.Parameter]]:
    """(name, parameter) of everything the optimizer updates: the UNet
    weights that ``finetune_unet`` trains, the LoRA adapters, the prompts,
    projections and head, and the CLIP tower under 'learnable_clip'.  The
    VAE, a 'no_learnable_clip' tower and the EMA copies are frozen (the JAX
    package's ``split_trainable``)."""
    mode = model.cfg.finetune_unet
    frozen = ("vae.", "ema.") + (() if model.cfg.clip_state == "learnable_clip" else ("clip_vision.",))
    return [(n, p) for n, p in model.named_parameters()
            if not n.startswith(frozen)
            and (not n.startswith("unet.") or _unet_trains(n[len("unet."):], mode))]


class PixelUnshuffleTower(nn.Module):
    """PixelUnshuffle(8) of the grayscale image, then conv 3x3 -> BN -> SiLU
    -> conv 3x3 -> BN: a 64-channel latent-resolution map concatenated to
    the noisy latent under ``concat_pixel_shuffle`` (JAX
    ``PixelUnshuffleTower``, reference ``ldm_diffusers.py:83-99,170-173``).
    BN normalises by the batch statistics in every mode (the reference
    builds the tower after freezing, so its BN stays in train mode), in
    fp32, over the global batch under a process group; it keeps no running
    statistics.  Parameter names are the JAX leaves' (``bn1_scale``, ...)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(64, 64, 3, padding=1)
        self.bn1_scale = nn.Parameter(torch.ones(64))
        self.bn1_bias = nn.Parameter(torch.zeros(64))
        self.conv2 = nn.Conv2d(64, 64, 3, padding=1)
        self.bn2_scale = nn.Parameter(torch.ones(64))
        self.bn2_bias = nn.Parameter(torch.zeros(64))

    @staticmethod
    def _bn(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        yf = y.float()
        if dist_lib.initialized():
            mean, var = global_batch_stats(yf)
        else:
            mean, var = yf.mean(dim=(0, 2, 3)), yf.var(dim=(0, 2, 3), correction=0)
        out = (yf - mean[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None]
        return (out * scale.float()[:, None, None] + bias.float()[:, None, None]).to(y.dtype)

    def forward(self, gray: torch.Tensor) -> torch.Tensor:
        """gray [B, 1, H, W] -> [B, 64, H/8, W/8] (channel dy * 8 + dx)."""
        x = F.pixel_unshuffle(gray.to(self.conv1.weight.dtype), 8)
        x = F.silu(self._bn(self.conv1(x), self.bn1_scale, self.bn1_bias))
        return self._bn(self.conv2(x), self.bn2_scale, self.bn2_bias)


class MADM(nn.Module):
    def __init__(self, config: MADMConfig = MADMConfig(), device: str | torch.device = "cuda",
                 trainable: bool = False):
        super().__init__()
        cfg = self.cfg = config
        self.device = resolve_device(device)
        unet_ch = tuple(cfg.unet_channels or unet_lib.BLOCK_OUT_CHANNELS)
        vae_ch = tuple(cfg.vae_channels or vae_lib.BLOCK_OUT_CHANNELS)

        # JAX checks feature_dims against the 'after' taps' channels whatever
        # unet_block_indices_type is (madm.py:344-352, ROADMAP §C)
        up = tuple(reversed(unet_ch))
        expected = ([3] if cfg.use_s0 else []) + [up[i // 3] for i in reversed(cfg.unet_block_indices)]
        if list(cfg.feature_dims) != expected:
            raise ValueError(f"feature_dims {tuple(cfg.feature_dims)} does not match the "
                             f"backbone's tap channels {tuple(expected)} "
                             f"(unet_block_indices={tuple(cfg.unet_block_indices)}, use_s0={cfg.use_s0})")
        # the construction checks of JAX MADM.__init__ (madm.py:290-301, 477-483)
        if (cfg.concat_attention_to_conv_seg or cfg.target_attention_loss or cfg.fd_attention) \
                and not cfg.attention_features_res:
            raise ValueError("attention consumers need attention_features_res/location set "
                             "(reference main.py:545-548 sets res={16,32}, location=['up'])")
        if cfg.concat_attention_to_conv_seg and (cfg.attention_select_index is None
                                                 or len(cfg.attention_select_index) != cfg.num_classes):
            raise ValueError("concat_attention_to_conv_seg needs attention_select_index with "
                             "num_classes entries (daformer_head.py:575)")
        if cfg.input_channel_plus and not cfg.mask_diff:
            raise ValueError("input_channel_plus needs mask_diff values")

        def unet():
            return unet_lib.UNet2DCondition(unet_ch, cfg.unet_block_indices, cfg.flash_pack,
                                            cfg.unet_in_channels, cfg.unet_block_indices_type)

        def head():
            return DAFormerHead(cfg.projection_dim, cfg.in_keys, cfg.num_classes,
                                channels=cfg.head_channels, fusion=cfg.head_fusion,
                                final_fuse_vae_decoder_feat=cfg.final_fuse_vae_decoder_feat,
                                concat_attention_to_conv_seg=cfg.concat_attention_to_conv_seg)

        seq_len = cfg.prompt_seq_len or prompt_lib.PROMPT_SEQ_LEN

        def prompt():
            return prompt_lib.ClipFeatureProject(
                unet_ch[0] * 4, seq_len, cfg.multi_layer_prompt, learnable=not cfg.without_prompt,
                alpha=not cfg.without_prompt_alpha,
                in_features=cfg.clip_vision.out_dim if cfg.clip_state != "no" else None)

        with torch.device(self.device):
            self.vae = vae_lib.AutoencoderKL(vae_ch)
            self.unet = unet()
            domains = ["clip_project_rgb"] + ([] if cfg.same_cond_params else ["clip_project_others"])
            self.prompt = nn.ModuleDict({k: prompt() for k in domains})
            self.feature_projections = MultiScaleProjection(
                cfg.feature_dims, cfg.projection_dim, cfg.out_features)
            self.sem_seg_head = head()
            if cfg.sem_seg_head_sec_modal:
                self.sem_seg_head_sec_modal = head()
            if cfg.concat_pixel_shuffle:
                self.pixel_unshuffle = PixelUnshuffleTower()
            if cfg.clip_state != "no":
                self.clip_vision = clip_image.CLIPVisionTransformer(cfg.clip_vision)
            self.lora_specs = lora_lib.parse_lora_configs(cfg.lora_configs)
            if self.lora_specs:
                self.lora = nn.ModuleDict({name: lora_lib.LoRAAdapter(self.unet, spec["rank"])
                                           for name, spec in self.lora_specs.items()})
            if trainable:
                self.ema = nn.ModuleDict({
                    "feature_projections": MultiScaleProjection(
                        cfg.feature_dims, cfg.projection_dim, cfg.out_features),
                    "sem_seg_head": head(),
                    "clip_project_others": prompt(),
                })
                if cfg.clip_state == "learnable_clip":
                    self.ema["clip_vision"] = clip_image.CLIPVisionTransformer(cfg.clip_vision)
                if cfg.ema_w_unet:
                    self.ema["unet"] = unet()
                    if self.lora_specs:
                        self.ema["lora"] = nn.ModuleDict({
                            name: lora_lib.LoRAAdapter(self.unet, spec["rank"])
                            for name, spec in self.lora_specs.items()})
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
            if cfg.clip_state == "no_learnable_clip":
                self.clip_vision.to(dtype=cfg.compute_dtype)
            for _, p in trainable_parameters(self):
                p.requires_grad_(True)
        else:
            self.to(dtype=cfg.compute_dtype)
            if self.lora_specs:
                self.lora.float()  # merged in fp32 into the bf16 weights, rounded once

    # ------------------------------------------------------------ teacher
    def student_ema_pairs(self) -> List[Tuple[nn.Module, nn.Module]]:
        """(EMA module, student module) pairs of the teacher's tree (JAX
        ``student_subtree``): projections, head, the target domain's prompt,
        under 'learnable_clip' the CLIP tower, and under ``ema_w_unet`` the
        UNet and the adapters."""
        others = "clip_project_rgb" if self.cfg.same_cond_params else "clip_project_others"
        pairs = [(self.ema["feature_projections"], self.feature_projections),
                 (self.ema["sem_seg_head"], self.sem_seg_head),
                 (self.ema["clip_project_others"], self.prompt[others])]
        if self.cfg.clip_state == "learnable_clip":
            pairs.append((self.ema["clip_vision"], self.clip_vision))
        if self.cfg.ema_w_unet:
            pairs.append((self.ema["unet"], self.unet))
            if self.lora_specs:
                pairs.append((self.ema["lora"], self.lora))
        return pairs

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

    def lora_weights(self, lora_name: Optional[str], ema: bool = False) -> Dict[str, torch.Tensor]:
        """The UNet weights that adapter ``lora_name`` changes, merged at
        scale alpha / rank (empty for ``None`` or a name the model does not
        hold, as JAX ``backbone_forward`` skips the merge); ``ema``: the
        teacher's adapter into the teacher's UNet (``ema_w_unet``)."""
        if lora_name is None or lora_name not in self.lora_specs:
            return {}
        spec = self.lora_specs[lora_name]
        unet, adapters = (self.ema["unet"], self.ema["lora"]) if ema else (self.unet, self.lora)
        adapter = adapters[lora_name]
        sites = {f"{path}.weight" for path, _ in adapter.sites()}
        base = {n: p for n, p in unet.named_parameters() if n in sites}
        return lora_lib.merge_lora(base, adapter, spec["alpha"] / spec["rank"])

    def prompt_ablation(self, mode: Optional[str], draw: Optional[torch.Tensor]) -> Optional[Callable]:
        """The map of the unbatched prompt under ``prompt_mode`` (JAX
        ``conditioning``, ``madm.py:547-558``): 'masked_prompt' drops token
        rows (detached under ``detach_mask_prompt``), 'prompt_perturbation'
        adds noise and detaches, 'rand_prompt' replaces the prompt; the
        first two only where their config value is set.  ``draw``: the
        values of ``prompt_lib.draw_prompt_ablation``."""
        cfg = self.cfg
        if mode is None:
            return None
        if draw is None:
            raise ValueError(f"prompt_mode {mode!r} needs its draw")
        draw = draw.to(self.device)
        if mode == "masked_prompt" and cfg.mask_prompt_ratio:
            def masked(cp):
                cp = prompt_lib.mask_prompt(cp, draw, cfg.mask_prompt_ratio)
                return cp.detach() if cfg.detach_mask_prompt else cp
            return masked
        if mode == "prompt_perturbation" and cfg.prompt_perturbation:
            return lambda cp: prompt_lib.perturb_prompt(cp, draw, cfg.prompt_perturbation).detach()
        if mode == "rand_prompt":
            return lambda cp: prompt_lib.rand_prompt(cp, draw, cfg.rand_prompt_scale)
        return None

    def clip_prefix(self, images: torch.Tensor, ema_forward: bool = False) -> Optional[torch.Tensor]:
        """The CLIP image embedding [B, D] of NHWC ``images`` in [0, 1] that
        lifts the prompt and time embedding (None under clip_state 'no'):
        the teacher's passes read the EMA tower under 'learnable_clip'; the
        prefix is detached under 'no_learnable_clip' and on the teacher's
        passes (JAX ``conditioning``, ``madm.py:533-545``)."""
        cfg = self.cfg
        if cfg.clip_state == "no":
            return None
        learnable = cfg.clip_state == "learnable_clip"
        tower = self.ema["clip_vision"] if ema_forward and learnable else self.clip_vision
        prefix = self._compute(tower)(clip_image.preprocess(images, cfg.clip_vision.image_size))
        return prefix.detach() if ema_forward or not learnable else prefix

    # ---------------------------------------------------------- backbone
    def _images(self, images) -> torch.Tensor:
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"images must be NHWC [B, H, W, 3], got {tuple(x.shape)}")
        return x

    def modality_mask(self, images, modal_name: str) -> Optional[torch.Tensor]:
        """mask_diff's constant input channels of ``modal_name`` at latent
        resolution, [B, input_channel_plus, H/8, W/8] fp32 (JAX
        ``modality_mask``; mtmadise.py:245-247), or None without them."""
        cfg = self.cfg
        if not cfg.input_channel_plus:
            return None
        b, h, w = images.shape[:3]
        return torch.full((b, cfg.input_channel_plus, h // 8, w // 8), cfg.mask_values[modal_name],
                          device=self.device)

    def mixed_modality_mask(self, mix_mask: torch.Tensor, modal_name: str) -> Optional[torch.Tensor]:
        """The mixed pass's mask: the 'rgb' value where the DACS mask
        ``mix_mask`` [B, H, W] (1 = source) pastes source, the target's
        elsewhere, taken at every 8th pixel (JAX ``mixed_modality_mask``;
        mtmadise.py:291-296)."""
        cfg = self.cfg
        if not cfg.input_channel_plus:
            return None
        vals = cfg.mask_values
        m = mix_mask[:, ::8, ::8].to(self.device, torch.float32)[:, None]
        out = vals["rgb"] * m + vals[modal_name] * (1.0 - m)
        return out.expand(-1, cfg.input_channel_plus, -1, -1)

    def collect_attention(self, entries, batch: int, lh: int, lw: int) -> Dict[str, object]:
        """A capture pass's probabilities -> JAX ``_collect_attention``'s
        surface: ``attention_features`` {res: [B, h, w, S] fp32}, the mean of
        the layers captured at each res (ascending res); ``up_cross``, the
        'up' maps in the order the pass ran them; ``cross_attention_feat``
        [B, num_classes, h, w], the largest res's map at the tokens of
        ``attention_select_index`` (when set), channels-first for the head's
        concat slot.  ``lh``, ``lw``: the latent's size."""
        nb = len(self.unet.boc)
        maps = []
        for location, res, p in entries:  # level: the latent's halvings at that res
            level = {"down": (64 // res).bit_length() - 1, "mid": nb - 1,
                     "up": nb - (res // 8).bit_length()}[location]
            maps.append((location, res, p.reshape(batch, lh >> level, lw >> level, p.shape[-1])))
        by_res: Dict[int, list] = {}
        for _, res, p in maps:
            by_res.setdefault(res, []).append(p)
        features = {res: sum(ps) / len(ps) for res, ps in sorted(by_res.items())}
        out: Dict[str, object] = {"attention_features": features,
                                  "up_cross": [p for loc, _, p in maps if loc == "up"]}
        if self.cfg.attention_select_index is not None and features:
            idx = torch.tensor(self.cfg.attention_select_index, device=self.device)
            out["cross_attention_feat"] = features[max(features)][..., idx].permute(0, 3, 1, 2)
        return out

    def backbone_forward(self, images, *, input_modal: str = "others",
                         lora_name: Optional[str] = None, ema_forward: bool = False,
                         timesteps: Optional[torch.Tensor] = None, train: bool = False,
                         prompt_mode: Optional[str] = None,
                         prompt_draw: Optional[torch.Tensor] = None,
                         latent_noise: Optional[torch.Tensor] = None,
                         modality_mask: Optional[torch.Tensor] = None,
                         capture_attention: bool = False,
                         unet: Optional[nn.Module] = None,
                         prompt: Optional[nn.ModuleDict] = None,
                         features: bool = True) -> Dict[str, object]:
        """One diffusion feature pass: NHWC images in [0, 1] ->
        ``{'output_features': {name: NCHW}, 'unet_taps': [NCHW, smallest
        resolution first], 'before_vae_decoder': eps, 'after_vae_decoder':
        clip(decoded eps, -1, 1)}`` (the decoder entries when s0 is tapped;
        the clipped one on train and teacher passes only, which read it).
        ``timesteps`` [B] (default 0) noise the latent; ``lora_name`` merges
        that adapter into the UNet for this pass; ``ema_forward`` takes the
        teacher's prompt and projections, and its UNet and adapter under
        ``ema_w_unet`` (else the student's, as in JAX); ``train`` builds the
        autograd graph.  ``prompt_mode`` and ``prompt_draw`` apply a prompt
        ablation (``prompt_ablation``); ``latent_noise`` [B, 4, h, w] N(0, 1)
        is the ``add_latent_noise`` draw, added on 'mixed' passes only.
        ``modality_mask`` [B, N, h, w] (``modality_mask`` /
        ``mixed_modality_mask``) fills mask_diff's conv_in channels after the
        latent (and the pixel-unshuffle tower's, under
        ``concat_pixel_shuffle``).  ``capture_attention`` runs the
        cross-attentions of ``attention_features_res/location`` in plain
        torch and adds ``collect_attention``'s entries.
        ``unet`` and ``prompt`` replace the student's UNet and prompt sets
        (the ``fd`` baseline); ``features=False`` stops after the UNet
        (``unet_taps``, ``before_vae_decoder`` and the captured maps only:
        the passes whose losses read no head).  The VAE runs without a
        graph: the encoder is frozen, and the s0 decoder reads
        ``eps.detach()`` (JAX stops the gradient at its output), so no
        gradient reaches the VAE's D=512 attention."""
        cfg = self.cfg
        vae_dtype = self.vae.quant_conv.weight.dtype
        images = self._images(images)
        x01 = images * 2.0 - 1.0
        x = x01.permute(0, 3, 1, 2).to(vae_dtype)
        b = x.shape[0]
        with torch.no_grad():
            latents = self.vae.encode(x)
        if timesteps is None:
            timesteps = torch.zeros(b, dtype=torch.long, device=self.device)
        timesteps = torch.as_tensor(timesteps, device=self.device).long().expand(b)
        noisy = add_noise(latents, self.shared_noise.expand_as(latents).to(latents.dtype), timesteps)
        if cfg.add_latent_noise != -1.0 and input_modal == "mixed":
            if latent_noise is None:
                raise ValueError("add_latent_noise needs the latent_noise draw on a 'mixed' pass")
            noisy = noisy + latent_noise.to(self.device, noisy.dtype) * cfg.add_latent_noise
        if cfg.norm_latent_noise:  # global mean and population std (jnp.std)
            noisy = (noisy - noisy.mean()) / noisy.std(correction=0)
        if cfg.input_channel_plus and modality_mask is None:
            raise ValueError("mask_diff needs the pass's modality_mask")
        with torch.set_grad_enabled(train):
            if cfg.concat_pixel_shuffle:
                tower = self._compute(self.pixel_unshuffle)(x01.mean(dim=-1)[:, None])
                noisy = torch.cat([noisy, tower.to(noisy.dtype)], dim=1)
            if cfg.input_channel_plus:
                noisy = torch.cat([noisy, modality_mask.to(self.device, noisy.dtype)], dim=1)
            if ema_forward:
                p = self.ema["clip_project_others"]
            else:
                p = prompt_lib.select_domain_params(self.prompt if prompt is None else prompt,
                                                    input_modal, cfg.same_cond_params)
            cond_prompt, cond_time = prompt_lib.conditioning_of(
                p, self.uncond_inputs, b, self.prompt_ablation(prompt_mode, prompt_draw),
                self.clip_prefix(images, ema_forward))
            teacher_unet = ema_forward and cfg.ema_w_unet
            if unet is None:
                unet = self.ema["unet"] if teacher_unet else self.unet
                weights = self.lora_weights(lora_name, ema=teacher_unet)
            else:
                weights = {}
            capture = None
            if capture_attention:
                if not cfg.attention_features_res:
                    raise ValueError("capture_attention needs attention_features_res/location")
                capture = unet_lib.AttentionCapture(cfg.attention_features_res,
                                                    cfg.attention_features_location)
            eps, taps = self._compute(unet, weights)(noisy, timesteps, cond_prompt, cond_time,
                                                     capture=capture)
            out: Dict[str, object] = {"unet_taps": taps}
            if capture is not None:
                out.update(self.collect_attention(capture.entries, b, *noisy.shape[2:]))
            if not features:
                out["before_vae_decoder"] = eps
                return out
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
    def _head_module(self, ema_forward: bool = False, use_sec_modal: bool = False) -> DAFormerHead:
        """The teacher's head, the second head under ``use_sec_modal`` (where
        the model has one, JAX ``head_forward``), else the student's."""
        if ema_forward:
            return self.ema["sem_seg_head"]
        if use_sec_modal and self.cfg.sem_seg_head_sec_modal:
            return self.sem_seg_head_sec_modal
        return self.sem_seg_head

    def head_forward(self, features: Dict[str, torch.Tensor], *, ema_forward: bool = False,
                     train: bool = False, update_bn: bool = False,
                     dropout: Optional[torch.Tensor] = None, use_sec_modal: bool = False,
                     cross_attention_feat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Module-head logits [B, C, h, w] in the compute dtype.  ``train``
        normalises by batch statistics; ``update_bn`` then folds them into the
        running statistics (momentum 0.9, biased variance); ``dropout`` is a
        channel multiplier [B, head_channels] (0 or 1/(1-p)).  The teacher's
        head and its statistics are the EMA copies; ``use_sec_modal`` takes
        ``sem_seg_head_sec_modal`` where the model has it;
        ``cross_attention_feat`` fills the concat slot."""
        head = self._head_module(ema_forward, use_sec_modal)
        return self._compute(head)(features, train=train, update_bn=update_bn, dropout=dropout,
                                   cross_attention_feat=cross_attention_feat)

    def _eval_head(self) -> DAFormerHead:
        """The eval passes' head (the second head where the model has one) in
        the compute dtype: the head itself, or, over fp32 masters, a copy
        whose convs and linears hold compute-dtype casts while BN keeps its
        fp32 affine and statistics (eval BN then normalises in fp32, as flax
        promotes it, and the kernel heads fold BN in fp32)."""
        head = self._head_module(use_sec_modal=True)
        if not self._cast_params:
            return head
        head = copy.deepcopy(head)
        for m in head.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(self.cfg.compute_dtype)
        return head

    def eval_head_mode(self, eval_head: Optional[str] = None) -> str:
        """The eval head ``eval_forward_ids`` runs: ``eval_head``, else the
        config's.  The kernel heads serve only the sep-ASPP fuse layer
        without ``final_fuse_vae_decoder_feat`` or the concat slot, and give
        ids at the first feature's resolution, so they need the head to lead
        with s0 on 4 inputs; 'aspp' and 'full' also need dilations 1/6/12/18
        and 256-wide embeds and branches (JAX ``_eval_head_mode`` and
        ``head_ids``, without their TPU tiling rules).  'auto' takes 'aspp'
        where the head fits it, else 'none'; a head asked for by name that
        the model does not fit raises."""
        mode = eval_head or self.cfg.eval_head
        if mode not in EVAL_HEADS:
            raise ValueError(f"eval head {mode!r} is not one of {EVAL_HEADS}")
        head = self._head_module(use_sec_modal=True)
        plain = (head.fusion == "aspp" and not head.final_fuse_vae_decoder_feat
                 and not head.concat_attention_to_conv_seg)
        at_image_res = plain and len(head.in_keys) == 4 and head.in_keys[0] == "s0"
        fits = {"aspp": aspp.fits_kernel(head), "full": aspp.fits_kernel(head),
                "argmax": at_image_res, "none": True}
        if mode == "auto":
            return "aspp" if fits["aspp"] else "none"
        if not fits[mode]:
            raise ValueError(
                f"eval head {mode!r} does not fit this head (fusion {head.fusion!r}, final_fuse "
                f"{head.final_fuse_vae_decoder_feat}, concat slot {head.concat_attention_to_conv_seg}, "
                f"in_keys {head.in_keys}, dilations {head.dilations}, embed_dims {head.embed_dims}, "
                f"channels {head.channels})")
        return mode

    @torch.no_grad()
    def head_ids(self, features: Dict[str, torch.Tensor], image_hw,
                 eval_head: Optional[str] = None,
                 cross_attention_feat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Argmax ids [B, H, W] int32 from NCHW features, through the eval
        head that ``eval_head_mode`` picks (shared by the single-crop and
        the sliding-window passes); ``cross_attention_feat`` fills the
        concat slot."""
        mode = self.eval_head_mode(eval_head)
        head = self._eval_head()
        if mode == "aspp":
            return _chunk_over_batch(lambda f: aspp.aspp_head_forward(head, f), features,
                                     _head_chunk(image_hw))
        if mode == "full":
            return aspp.fused_head_forward(head, features)
        if mode == "argmax":
            return aspp.argmax_head_forward(head, features)
        return _ids_from_logits(head(features, cross_attention_feat=cross_attention_feat), image_hw)

    # -------------------------------------------------------- eval passes
    def _eval_timesteps(self, b: int, eval_with_noise: Optional[int]) -> Optional[torch.Tensor]:
        """``eval_with_noise``: a fixed noise timestep for every image of a
        test batch (reference ``mtmadise.py:681-682``), else t = 0."""
        if eval_with_noise is None:
            return None
        return torch.full((b,), int(eval_with_noise), dtype=torch.long, device=self.device)

    def _eval_backbone(self, x: torch.Tensor, eval_with_noise: Optional[int],
                       lora_name: Optional[str]) -> Dict[str, object]:
        """The eval passes' backbone: 'others' prompt, the target modality's
        mask_diff channels, the cross-attention maps under the concat slot."""
        return self.backbone_forward(
            x, lora_name=lora_name, timesteps=self._eval_timesteps(x.shape[0], eval_with_noise),
            modality_mask=self.modality_mask(x, self.cfg.target_modality),
            capture_attention=self.cfg.concat_attention_to_conv_seg)

    @torch.no_grad()
    def eval_forward(self, images, eval_with_noise: Optional[int] = None,
                     lora_name: Optional[str] = None) -> torch.Tensor:
        """Logits [B, H, W, num_classes] fp32 through the module head."""
        x = self._images(images)
        out = self._eval_backbone(x, eval_with_noise, lora_name)
        logits = self._eval_head()(out["output_features"],
                                   cross_attention_feat=out.get("cross_attention_feat"))
        return resize_bilinear(logits.float(), x.shape[1:3]).permute(0, 2, 3, 1)

    @torch.no_grad()
    def eval_forward_ids(self, images, eval_with_noise: Optional[int] = None,
                         eval_head: Optional[str] = None,
                         lora_name: Optional[str] = None) -> torch.Tensor:
        """Argmax ids [B, H, W] int32 — the inference hot path.
        ``eval_head`` overrides ``MADMConfig.eval_head`` for this call;
        ``lora_name`` picks the adapter (JAX: the target modality's)."""
        x = self._images(images)
        out = self._eval_backbone(x, eval_with_noise, lora_name)
        return self.head_ids(out["output_features"], x.shape[1:3], eval_head,
                             out.get("cross_attention_feat"))

    # ------------------------------------------------- sliding-window pass
    def slide_windows(self, h: int, w: int) -> Tuple[Tuple[int, int, int, int], ...]:
        """(y1, y2, x1, x2) crops covering (h, w) at half-crop stride; for
        512x1024 exactly the reference's three, ``feature_extractor.py:75``."""
        ch, cw = self.cfg.crop_size
        ys = sorted({min(y, h - ch) for y in range(0, max(h - ch, 0) + 1, max(ch // 2, 1))})
        xs = sorted({min(x, w - cw) for x in range(0, max(w - cw, 0) + 1, max(cw // 2, 1))})
        return tuple((y, y + ch, x, x + cw) for y in ys for x in xs)

    def slide_backbone_forward(self, images, *, windows=None,
                               timesteps: Optional[torch.Tensor] = None, form: str = "batch",
                               **kw) -> Dict[str, Dict[str, torch.Tensor]]:
        """Sliding-window backbone (JAX ``slide_backbone_forward``, reference
        ``slide_forward``, ``feature_extractor.py:199-278``): each window's
        features added into canvases of the feature dtype and scaled by the
        reciprocal of the overlap counts; differentiable under ``train=True``
        (``slide_training``).  ``form='window'`` runs one backbone pass a
        window, so only one window's features live at a time;
        ``form='batch'`` runs all windows as one pass of B * n_win crops,
        with fewer launches.  ``timesteps`` [B] and the other keywords of
        ``backbone_forward`` (``lora_name``, ``input_modal``, ``train``, ...)
        go to every window.
        Returns ``{'output_features': {name: NCHW}}`` at image resolution
        over each stride."""
        if self.cfg.input_channel_plus:
            raise ValueError("the slide path does not compose with mask_diff conv_in surgery")
        x = self._images(images)
        b, h, w, _ = x.shape
        windows = tuple(windows or self.slide_windows(h, w))
        if form == "window":
            per_window = ((win, self.backbone_forward(x[:, win[0]:win[1], win[2]:win[3]],
                                                      timesteps=timesteps, **kw)["output_features"])
                          for win in windows)
        elif form == "batch":
            crops = torch.cat([x[:, y1:y2, x1:x2] for y1, y2, x1, x2 in windows], dim=0)
            if timesteps is not None:
                timesteps = torch.as_tensor(timesteps, device=self.device).expand(b).repeat(len(windows))
            feats = self.backbone_forward(crops, timesteps=timesteps, **kw)["output_features"]
            per_window = ((win, {k: f[i * b:(i + 1) * b] for k, f in feats.items()})
                          for i, win in enumerate(windows))
        else:
            raise ValueError(f"slide form {form!r} is not 'window' or 'batch'")
        strides = {name: 2 ** int(name[1]) for name in self.cfg.out_features}
        canvases: Dict[str, torch.Tensor] = {}
        counts = {name: np.zeros((h // s, w // s), np.float32) for name, s in strides.items()}
        with torch.set_grad_enabled(bool(kw.get("train"))):
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


def init_modules_(root: nn.Module, generator: torch.Generator) -> None:
    """``init_random_``'s draws over every module of ``root`` outside its
    ``ema`` tree, in module order (``madm_torch.models.ldm_extractor``'s
    seeded init takes them too)."""
    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device, dtype=torch.float32) * std)

    with torch.no_grad():
        for name, m in root.named_modules():
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
                for p in (m.prompt_embed, m.time_embed):
                    if p is not None:
                        normal(p, 0.02)
                for p in (m.alpha_cond_prompt, m.alpha_uncond_prompt):
                    if p is not None:
                        p.copy_(torch.rand(p.shape, generator=generator, device=p.device))
                if m.alpha_cond_time is not None:
                    m.alpha_cond_time.zero_()
            elif isinstance(m, prompt_lib.PositionalLinear):
                normal(m.positional_embedding, 0.02)
            elif isinstance(m, clip_image.CLIPVisionEmbeddings):
                normal(m.class_embedding, 0.02)
                normal(m.position_embedding.weight, 0.02)
            elif isinstance(m, PixelUnshuffleTower):
                for p in (m.bn1_scale, m.bn2_scale):
                    p.fill_(1.0)
                for p in (m.bn1_bias, m.bn2_bias):
                    p.zero_()
            elif isinstance(m, lora_lib.LoRAAdapter):
                lora_lib.reset_lora_(m, generator)


def init_random_(model: MADM, generator: torch.Generator) -> MADM:
    """Seeded random weights, for running without a checkpoint: convs and
    linears N(0, 1/fan_in) with zero bias, norms at identity, BN statistics
    (0, 1), conv_seg N(0, 0.01^2), prompt and time embeds N(0, 0.02^2),
    prompt blend weights U[0, 1), time blend weight 0, the prefix lifts'
    and the CLIP tower's positional tables and class token N(0, 0.02^2),
    the pixel-unshuffle tower's BN at identity, LoRA adapters at peft's
    init (A ~ N(0, 1) / rank, B = 0).  The second head and a trainable
    model's teacher start as copies of the student's.  ``generator`` must
    live on the model's device."""
    init_modules_(model, generator)
    with torch.no_grad():
        if model.cfg.sem_seg_head_sec_modal:  # the second head starts as a copy (JAX init_params)
            model.sem_seg_head_sec_modal.load_state_dict(model.sem_seg_head.state_dict())
        if hasattr(model, "ema"):
            model.reset_ema_()
    return model
