"""The MADM UDA train step in the shipped configuration (port of
``madm_tpu/train/train_step.py::make_train_step``'s ``step_fn`` with the
flags of ``config_files/SemSeg/MTMADISE/mtmadise_cityscapes_rgb_to_depth_11.py``).

    state = make_train_state(model, TrainConfig())
    metrics = train_step(state, batch, generator)

Order, as in the JAX step:
1. EMA teacher update (step 0 copies the student);
2. DACS class mask, mix of source into target, strong transform;
3. teacher pass at the rev-noise timestep t_pl -> pseudo-label, its
   probability and the per-sample confident fraction (pseudo-weight);
4. mixed labels and pixel weights; the ``reg_uncertain`` palette-distance
   probability (a metric only); palette latents of the source labels and of
   the mixed labels through the frozen VAE encoder;
5. grad pass 1 (source, 'rgb' prompt): CE + palette regression, backward;
6. grad pass 2 (mixed, 'mixed' prompt): weighted CE + palette regression,
   backward into the same ``.grad``: the sum is JAX's grads_src + grads_mix,
   and only one pass's activations are alive at a time;
7. the head's BN statistics chain source -> mixed in place; the teacher's
   come from its own pass;
8. global-norm clip, AdamW at the scheduled learning rate, step + 1.

With LoRA adapters (``MADMConfig.lora_configs``), the source pass takes
the ``default`` adapter and the teacher and mixed passes the target
modality's, each where the model holds it (JAX ``train_step.py:290-292``).

``batch``: {'source_rgb' [B,H,W,3] in [0,1], 'source_label' [B,H,W] int
(255 ignored), 'target_second_modality' [B,H,W,3] in [0,1]}.  The random
values come from ``sample_draws`` with an explicit generator, or from a
``draws`` dict of the same keys (tests hand in the JAX package's values).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.daformer import DROPOUT_RATIO, argmax_classes
from ..models.madm import MADM, trainable_parameters
from ..ops import dacs, palette
from . import criterion
from .ema import ema_alpha, update_ema
from .optimizer import clip_by_global_norm_, lr_schedule, make_optimizer

# settings of the JAX step whose other branches the port has not taken yet
# (ablations, and alternatives no shipped config uses), with the one value
# it takes; TrainConfig raises for any other
_UNPORTED: Dict[str, Any] = {
    "enable_mixup": True, "rev_noise_sup": True, "rev_noise_gradually": True,
    "vae_decoder_loss_type": "L1", "reg_uncertain": True, "pseudo_weight_scope": "sample",
    "pl_crop": False, "mic": False, "mic_reg": 0.0, "remove_texture": False,
    "denoise_supervise": 0.0, "fd": 0.0, "fd_attention": 0.0,
    "target_attention_loss": False, "noise_reg": 0.0, "mask_prompt_ratio": 0.0,
    "prompt_perturbation": 0.0, "prompt_confidence": None, "merge_with_pl_data": None,
    "reg_target_palette": None,
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The shipped configs' UDA and optimizer settings (defaults: Cityscapes
    RGB -> DELIVER Depth, 11 classes)."""

    max_iter: int = 10000
    ema_alpha: float = 0.999
    pseudo_threshold: float = 0.968
    color_jitter_strength: float = 0.2
    color_jitter_probability: float = 0.2
    blur: bool = True
    enable_mixup: bool = True
    rev_noise_sup: bool = True
    rev_noise_end_iter: int = 5000
    rev_noise_gradually: bool = True
    denoise_timestep_range: Tuple[int, int] = (60, 61)
    vae_decoder_loss: str = "st"  # palette regression on 's' source, 't' mixed, or both
    vae_decoder_loss_type: str = "L1"
    vae_decoder_loss_weight: Tuple[float, float] = (1.0, 1.0)
    reg_uncertain: bool = True
    pseudo_weight_scope: str = "sample"  # the confident fraction of each sample
    train_palette: Tuple[int, ...] = palette.DELIVER_11_PALETTE
    lr: float = 5e-6
    weight_decay: float = 0.05
    grad_clip: float = 0.01
    # accepted only at the values in _UNPORTED
    pl_crop: bool = False
    mic: bool = False
    mic_reg: float = 0.0
    remove_texture: bool = False
    denoise_supervise: float = 0.0
    fd: float = 0.0
    fd_attention: float = 0.0
    target_attention_loss: bool = False
    noise_reg: float = 0.0
    mask_prompt_ratio: float = 0.0
    prompt_perturbation: float = 0.0
    prompt_confidence: Optional[float] = None
    merge_with_pl_data: Optional[str] = None
    reg_target_palette: Optional[str] = None

    def __post_init__(self):
        for name, off in _UNPORTED.items():
            if getattr(self, name) != off:
                raise NotImplementedError(f"TrainConfig.{name} is not ported to madm_torch yet")
        if not self.vae_decoder_loss or set(self.vae_decoder_loss) - set("st"):
            raise ValueError(f"vae_decoder_loss {self.vae_decoder_loss!r}")


@dataclasses.dataclass
class TrainState:
    model: MADM
    tc: TrainConfig
    optimizer: torch.optim.AdamW
    params: Sequence[torch.nn.Parameter]  # what the optimizer updates
    schedule: Any  # update count -> learning rate
    step: int = 0


# defaults of the knobs build_train_config reads from the model node: the
# JAX package's MADMConfig fields, used where a config does not set them
_KNOB_DEFAULTS: Dict[str, Any] = {
    "ema_alpha": 0.999, "pseudo_threshold": 0.968, "blur": True, "color_jitter_strength": 0.2,
    "color_jitter_probability": 0.2, "enable_mixup": True, "rev_noise_sup": False,
    "rev_noise_end_iter": None, "rev_noise_gradually": False, "denoise_timestep_range": None,
    "vae_decoder_loss": "st", "vae_decoder_loss_type": "L1", "vae_decoder_loss_weight": (1.0, 1.0),
    "reg_uncertain": False, "pseudo_weight_scope": "sample", "train_palette": (),
    "pl_crop": False, "mic": False, "mic_reg": 0.0, "remove_texture": False,
    "denoise_supervise": 0.0, "fd": 0.0, "fd_attention": 0.0, "target_attention_loss": False,
    "noise_reg": 0.0, "mask_prompt_ratio": 0.0, "prompt_perturbation": 0.0,
    "prompt_confidence": None, "merge_with_pl_data": None, "reg_target_palette": None,
}
# optimizer-node values the port takes (the shipped AdamW); others raise
_OPTIMIZER_PORTED: Dict[str, Any] = {
    "name": "adamw", "schedule": "multistep", "unet_lr": None, "betas": (0.9, 0.999),
    "eps": 1e-8, "weight_decay_norm": 0.0, "weight_decay_bias": 0.0, "no_momentum": None,
    "mu_dtype": None,
}


def build_train_config(cfg) -> TrainConfig:
    """TrainConfig from a loaded LazyConfig tree (the JAX package's
    ``build_train_config``): the UDA knobs from the model node, where an
    optional ``cfg.uda`` namespace overrides them; ``max_iter`` and the clip
    from ``cfg.train``; lr and weight decay from ``cfg.optimizer``, whose
    other settings must be the shipped AdamW's."""
    uda = dict(cfg.get("uda", {}) or {})
    model = cfg.model

    def knob(name):
        if uda.get(name) is not None:
            return uda[name]
        return model.get(name, _KNOB_DEFAULTS[name])

    opt = cfg.optimizer
    for name, ported in _OPTIMIZER_PORTED.items():
        value = opt.get(name, ported)
        if (tuple(value) if isinstance(value, list) else value) != ported:
            raise NotImplementedError(f"optimizer.{name}={value!r} is not ported to madm_torch yet "
                                      f"(it takes {ported!r})")
    return TrainConfig(
        max_iter=cfg.train.max_iter,
        ema_alpha=knob("ema_alpha"),
        pseudo_threshold=knob("pseudo_threshold"),
        color_jitter_strength=knob("color_jitter_strength"),
        color_jitter_probability=knob("color_jitter_probability"),
        blur=knob("blur"),
        enable_mixup=knob("enable_mixup"),
        rev_noise_sup=knob("rev_noise_sup"),
        rev_noise_end_iter=knob("rev_noise_end_iter") or cfg.train.max_iter,
        rev_noise_gradually=knob("rev_noise_gradually"),
        denoise_timestep_range=tuple(knob("denoise_timestep_range") or (0, 0)),
        vae_decoder_loss=uda.get("vae_decoder_loss") or model.get("vae_decoder_loss", "st") or "",
        vae_decoder_loss_type=knob("vae_decoder_loss_type"),
        vae_decoder_loss_weight=tuple(list(knob("vae_decoder_loss_weight")) + [1.0])[:2],
        reg_uncertain=knob("reg_uncertain"),
        pseudo_weight_scope=knob("pseudo_weight_scope"),
        train_palette=tuple(knob("train_palette")),
        lr=opt["lr"],
        weight_decay=opt["weight_decay"],
        grad_clip=cfg.train.get("grad_clip") or 0.01,
        pl_crop=knob("pl_crop"),
        mic=knob("mic"),
        mic_reg=float(knob("mic_reg")),
        remove_texture=knob("remove_texture"),
        denoise_supervise=float(knob("denoise_supervise")),
        fd=float(knob("fd")),
        fd_attention=float(knob("fd_attention") or 0.0),
        target_attention_loss=bool(knob("target_attention_loss")),
        noise_reg=float(knob("noise_reg") or 0.0),
        mask_prompt_ratio=float(knob("mask_prompt_ratio") or 0.0),
        prompt_perturbation=float(knob("prompt_perturbation") or 0.0),
        prompt_confidence=knob("prompt_confidence"),
        merge_with_pl_data=knob("merge_with_pl_data"),
        reg_target_palette=knob("reg_target_palette"),
    )


def make_train_state(model: MADM, tc: TrainConfig) -> TrainState:
    named = trainable_parameters(model)
    return TrainState(model=model, tc=tc,
                      optimizer=make_optimizer(model, named, tc.lr, tc.weight_decay),
                      params=[p for _, p in named], schedule=lr_schedule(tc.lr, tc.max_iter))


def rev_noise_timestep(draw: int, step: int, tc: TrainConfig) -> int:
    """The teacher's timestep: the drawn t scaled by (1 - step/end_iter) in
    fp32, 0 past end_iter (JAX ``rev_noise_timestep``)."""
    if step > tc.rev_noise_end_iter:
        return 0
    f = np.float32(1.0) - np.float32(step) / np.float32(tc.rev_noise_end_iter)
    return int(np.float32(draw) * f)


def sample_draws(generator: torch.Generator, tc: TrainConfig, labels: torch.Tensor,
                 num_classes: int, head: torch.nn.Module) -> Dict[str, Any]:
    """Every random value of one step: the DACS mask, the jitter and blur
    draws, the teacher timestep draw and the three heads' Dropout2d channel
    multipliers (source, mixed, teacher)."""
    b = labels.shape[0]
    scores = dacs.draw_class_scores(generator, b, num_classes)
    lo, hi = tc.denoise_timestep_range
    keep = torch.rand(3, b, head.channels, generator=generator, device=generator.device) >= DROPOUT_RATIO
    return {
        "mix_mask": dacs.class_masks(labels, scores, num_classes),
        "jitter": dacs.draw_color_jitter(generator, tc.color_jitter_strength,
                                         tc.color_jitter_probability),
        "blur": dacs.draw_gaussian_blur(generator) if tc.blur else None,
        "t_pl": int(torch.randint(lo, hi + 1, (1,), generator=generator,
                                  device=generator.device).item()),
        "dropout": list(keep.float() / (1.0 - DROPOUT_RATIO)),
    }


def pass_adapters(model: MADM) -> Tuple[Optional[str], Optional[str]]:
    """(source pass's adapter, target passes' adapter): ``default`` and the
    target modality's, each ``None`` where the model does not hold it."""
    names = set(model.lora_specs)
    modality = model.cfg.target_modality
    return ("default" if "default" in names else None), (modality if modality in names else None)


def _encode_palette(model: MADM, labels: torch.Tensor, table: torch.Tensor):
    """labels -> palette colours in [-1, 1] -> frozen VAE latent; + valid mask."""
    rgb, valid = palette.label_to_rgb(labels, table)
    with torch.no_grad():
        lat = model.vae.encode(rgb.permute(0, 3, 1, 2).to(model.vae.quant_conv.weight.dtype))
    return lat, valid


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
    """One UDA step on ``state`` in place; returns the step's metrics (every
    loss, ``total_loss``, ``pseudo_val``, ``reg_prob_mean``, ``grad_norm``)."""
    model, tc = state.model, state.tc
    cfg = model.cfg
    dev = model.device
    source = batch["source_rgb"].to(dev, torch.float32)
    target = batch["target_second_modality"].to(dev, torch.float32)
    gt = batch["source_label"].to(dev).long()
    b = source.shape[0]
    if draws is None:
        if generator is None:
            raise ValueError("train_step needs a generator or draws")
        draws = sample_draws(generator, tc, gt, cfg.num_classes, model.sem_seg_head)
    drop_src, drop_mix, drop_tch = (None if d is None else d.to(dev) for d in draws["dropout"])
    src_lora, tgt_lora = pass_adapters(model)
    step = state.step

    # 1. EMA teacher
    update_ema(model.student_ema_pairs(), ema_alpha(step, tc.ema_alpha))

    table = torch.from_numpy(palette.palette_table(tc.train_palette))
    class_table = table[: cfg.num_classes]
    with torch.no_grad():
        # 2. DACS mix inputs
        mix_mask = draws["mix_mask"].to(dev, torch.float32)
        mixed_img = dacs.one_mix(mix_mask[..., None], source, target)
        mixed_img = dacs.strong_transform(mixed_img, draws["jitter"], draws["blur"] if tc.blur else None)

        # 3. teacher pseudo-labels (the EMA head in train mode: batch-stat BN,
        # dropout on, its running statistics updated)
        t_pl = rev_noise_timestep(draws["t_pl"], step, tc)
        tch = model.backbone_forward(target, input_modal="others", lora_name=tgt_lora,
                                     ema_forward=True, timesteps=torch.full((b,), t_pl, device=dev))
        ema_logits = model.head_forward(tch["output_features"], ema_forward=True, train=True,
                                        update_bn=True, dropout=drop_tch)
        ema_sm = torch.softmax(criterion.resize_logits(ema_logits.float(), target.shape[1:3]), dim=1)
        pseudo_prob = ema_sm.amax(dim=1)
        pseudo_label = argmax_classes(ema_sm)
        pseudo_val = (pseudo_prob >= tc.pseudo_threshold).float().mean(dim=(1, 2))
        pseudo_weight = pseudo_val[:, None, None].expand_as(pseudo_prob)  # per sample

        # 4. mixed labels / weights, reg_uncertain metric, palette latents
        mixed_lbl = dacs.one_mix(mix_mask, gt.float(), pseudo_label.float()).long()
        mixed_w = dacs.one_mix(mix_mask, torch.ones_like(pseudo_weight), pseudo_weight)
        dec01 = (tch["after_vae_decoder"].float().permute(0, 2, 3, 1) + 1) / 2
        reg_prob = palette.palette_distance_pseudo_label(dec01, class_table)[0]
        del tch, ema_logits, ema_sm
        if "s" in tc.vae_decoder_loss:
            src_gt_lat, src_valid = _encode_palette(model, gt, table)
        if "t" in tc.vae_decoder_loss:
            tgt_gt_lat, tgt_valid = _encode_palette(model, mixed_lbl, table)
            tgt_mask = tgt_valid * pseudo_weight[..., None]

    state.optimizer.zero_grad(set_to_none=True)
    losses: Dict[str, torch.Tensor] = {}

    # 5. grad pass 1: source
    out = model.backbone_forward(source, input_modal="rgb", lora_name=src_lora, train=True)
    logits = model.head_forward(out["output_features"], train=True, update_bn=True, dropout=drop_src)
    part = {"source_loss": criterion.cross_entropy(logits, gt)}
    if "s" in tc.vae_decoder_loss:
        part["vae_decoder_source_loss"] = criterion.vae_decoder_loss(
            out["before_vae_decoder"], src_gt_lat, src_valid, tc.vae_decoder_loss_weight[0])
    sum(part.values()).backward()
    losses.update(part)
    del out, logits, part

    # 6. grad pass 2: mixed
    out = model.backbone_forward(mixed_img, input_modal="mixed", lora_name=tgt_lora, train=True)
    logits = model.head_forward(out["output_features"], train=True, update_bn=True, dropout=drop_mix)
    part = {"target_loss": criterion.cross_entropy(logits, mixed_lbl, pixel_weight=mixed_w)}
    if "t" in tc.vae_decoder_loss:
        part["vae_decoder_target_loss"] = criterion.vae_decoder_loss(
            out["before_vae_decoder"], tgt_gt_lat, tgt_mask, tc.vae_decoder_loss_weight[1])
    sum(part.values()).backward()
    losses.update(part)
    del out, logits, part

    # 8. clip, AdamW, step + 1
    grad_norm = clip_by_global_norm_(state.params, tc.grad_clip)
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(step)
    state.optimizer.step()
    state.step = step + 1

    names = list(losses) + ["total_loss", "pseudo_val", "reg_prob_mean", "grad_norm"]
    values = [v.detach().float() for v in losses.values()]
    values += [sum(values), pseudo_val.mean(), reg_prob.mean(), grad_norm.float()]
    return dict(zip(names, torch.stack(values).tolist()))
