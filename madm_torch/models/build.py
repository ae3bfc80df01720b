"""Config-facing model builder (port of ``madm_tpu/models/build.py``).

Maps the config surface (the knobs set by
``madm_torch/configs/common/models/mtmadise_multi_lora.py`` and the experiment
configs) onto ``MADMConfig``/``MADM``, with the JAX builder's keyword
surface.  UDA knobs live on the model node as in the reference's
``MTMADISE``/``CMDISE`` constructor arguments (``mtmadise.py:28-48``);
``madm_torch.train.build_train_config`` reads them from there, so the
builder only checks that it knows them.  Unknown keys raise.  A value whose
branch the port has not taken raises ``NotImplementedError`` naming it.

Two keywords are the port's own: ``device`` (the model is built on it) and
``trainable`` (fp32 masters and the EMA teacher, for the train state); and
the port's ``MADMConfig`` fields ``flash_pack`` and ``eval_head`` pass
through as keywords.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import torch

from .madm import MADM, MADMConfig

logger = logging.getLogger(__name__)

# reference model-node keys accepted and deliberately ignored (the JAX
# builder's list): panoptic/instance plumbing MADM never uses, d2 metadata,
# and torch-DDP workarounds
_IGNORED_REFERENCE_KEYS = frozenset({
    "num_queries", "object_mask_threshold", "overlap_threshold", "metadata",
    "size_divisibility", "sem_seg_postprocess_before_inference",
    "pixel_mean", "pixel_std", "semantic_on", "instance_on", "panoptic_on",
    "test_topk_per_image", "class_names", "max_iter",
    "add_zero_grad", "wo_lora", "w_rgb_lora", "ema_w_unet",
})

# UDA knobs (the JAX builder's list, with MIC_reg_wo_pl_val's spelling)
_UDA_KEYS = frozenset({
    "ema_alpha", "pseudo_threshold", "blur", "color_jitter_strength",
    "color_jitter_probability", "enable_mixup", "pl_crop",
    "psweight_ignore_top", "mic", "mask_ratio", "mic_reg",
    "mic_reg_wo_pl_val", "MIC_reg_wo_pl_val", "fd", "denoise_supervise",
    "denoise_timestep_range", "rev_noise_sup", "rev_noise_end_iter",
    "rev_noise_gradually", "noise_reg", "vae_decoder_loss_type",
    "vae_decoder_loss_weight", "reg_uncertain", "pseudo_weight_scope",
    "eval_with_noise", "mask_prompt_ratio", "detach_mask_prompt",
    "prompt_perturbation", "prompt_confidence", "rand_prompt_scale",
    "without_prompt", "without_prompt_alpha", "prompt_seq_len",
    "init_uncond_prompt", "denoise_interval", "merge_with_pl_data",
    "pl_merge_val", "fd_attention", "target_attention_loss",
    "reg_target_palette",
})


def _refuse(name: str, value, ported) -> None:
    if value != ported:
        raise NotImplementedError(
            f"build_madm: {name}={value!r} is not ported to madm_torch yet (it takes {ported!r})")


def build_madm(
    *,
    num_classes: int,
    target_modality: str = "Depth",
    lora_configs: Sequence[str] = (),
    feature_dims: Sequence[int] = (3, 320, 640, 1280),
    projection_dim: Sequence[int] = (128, 512, 512, 512),
    out_features: Sequence[str] = ("s0", "s3", "s4", "s5"),
    in_keys: Sequence[str] = ("s0", "s3", "s4", "s5"),
    unet_block_indices: Sequence[int] = (5, 8, 11),
    unet_block_indices_type: str = "after",
    head_channels: int = 256,
    head_fusion: str = "aspp",
    final_fuse_vae_decoder_feat: bool = False,
    concat_attention_to_conv_seg: bool = False,
    same_cond_params: bool = True,
    clip_state: str = "no",
    vae_decoder_loss: str = "st",
    train_palette: Sequence[int] = (),
    crop_size: Sequence[int] = (512, 512),
    compute_dtype: str = "bfloat16",
    unet_channels: Optional[Sequence[int]] = None,
    vae_channels: Optional[Sequence[int]] = None,
    remat: bool = False,
    sem_seg_head_sec_modal: bool = False,
    finetune_unet: str = "all",
    slide_training: bool = False,
    input_channel_plus: int = 0,
    mask_diff: Optional[str] = None,
    concat_pixel_shuffle: bool = False,
    add_latent_noise: float = -1.0,
    norm_latent_noise: bool = False,
    multi_layer_prompt: bool = False,
    attention_features_res: Sequence[int] = (),
    attention_features_location: Sequence[str] = (),
    attention_select_index: Optional[Sequence[int]] = None,
    flash_pack: bool = False,
    eval_head: str = "auto",
    device: str | torch.device = "cuda",
    trainable: bool = False,
    **extra,
) -> MADM:
    unknown = set(extra) - _UDA_KEYS - _IGNORED_REFERENCE_KEYS
    if unknown:
        raise ValueError(f"build_madm: unknown config keys {sorted(unknown)} "
                         f"(valid UDA knobs: {sorted(_UDA_KEYS)})")
    if extra.get("ema_w_unet"):
        raise NotImplementedError("build_madm: ema_w_unet=True is not ported to madm_torch yet "
                                  "(ROADMAP §A1)")
    for name, value, ported in (
            ("unet_block_indices_type", unet_block_indices_type, "after"),
            ("head_fusion", head_fusion, "aspp"),
            ("final_fuse_vae_decoder_feat", final_fuse_vae_decoder_feat, False),
            ("concat_attention_to_conv_seg", concat_attention_to_conv_seg, False),
            ("clip_state", clip_state, "no"),
            ("sem_seg_head_sec_modal", sem_seg_head_sec_modal, False),
            ("input_channel_plus", input_channel_plus, 0),
            ("mask_diff", mask_diff, None),
            ("concat_pixel_shuffle", concat_pixel_shuffle, False),
            ("add_latent_noise", add_latent_noise, -1.0),
            ("norm_latent_noise", norm_latent_noise, False),
            ("multi_layer_prompt", multi_layer_prompt, False),
            ("attention_features_res", tuple(attention_features_res or ()), ()),
            ("attention_features_location", tuple(attention_features_location or ()), ()),
            ("attention_select_index", attention_select_index, None)):
        _refuse(name, value, ported)
    if remat:
        # JAX's UNet rematerialisation changes memory, not results; the
        # port's step fits one 80 GB card without it (PERF.md §4)
        logger.info("build_madm: remat=True is a memory option of the JAX package; "
                    "madm_torch trains without rematerialisation")
    cfg = MADMConfig(
        num_classes=num_classes,
        target_modality=target_modality,
        unet_block_indices=tuple(unet_block_indices),
        out_features=tuple(out_features),
        feature_dims=tuple(feature_dims),
        projection_dim=tuple(projection_dim),
        in_keys=tuple(in_keys),
        head_channels=head_channels,
        same_cond_params=same_cond_params,
        finetune_unet=finetune_unet,
        compute_dtype=getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype,
        unet_channels=tuple(unet_channels) if unet_channels else None,
        vae_channels=tuple(vae_channels) if vae_channels else None,
        crop_size=tuple(crop_size),
        lora_configs=tuple(lora_configs),
        init_uncond_prompt=bool(extra.get("init_uncond_prompt", False)),
        slide_training=slide_training,
        eval_head=eval_head,
        flash_pack=flash_pack,
    )
    return MADM(cfg, device=device, trainable=trainable)
