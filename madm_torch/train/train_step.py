"""The MADM UDA train step (port of ``madm_tpu/train/train_step.py::
make_train_step``'s ``step_fn``, the shipped configuration and the ablation
branches).

    state = make_train_state(model, TrainConfig())
    metrics = train_step(state, batch, generator)

Order, as in the JAX step:
1. EMA teacher update (step 0 copies the student);
2. ``merge_with_pl_data``: the source image mixed with the stage-1 pl data;
3. DACS class mask, mix of source into target, strong transform;
4. teacher pass at the rev-noise timestep t_pl -> pseudo-label, its
   probability and the confident fraction (pseudo-weight, per sample or
   over the batch); ``prompt_confidence`` scales it by the teacher's
   agreement with a random-prompt teacher pass, ``pl_crop`` zeroes its top
   rows; the ``noise_reg`` teacher pass at a drawn timestep gives its own
   pseudo-label.  The two eval-mode teacher heads run before the pseudo-label
   head, whose BN update they must not see (JAX reads ``ts.state``);
5. mixed labels and pixel weights (or the pseudo-labels alone without
   ``enable_mixup``); the ``reg_uncertain`` palette-distance probability (a
   metric only); palette latents (train palette, or 'discrete') of the
   source labels, the mixed labels and, for the decoder consistency losses,
   the pseudo-labels;
6. grad pass 1 (source, 'rgb' prompt): CE + palette regression, and the
   ``fd`` distance of the UNet taps to those of the frozen initial UNet and
   prompt, backward;
7. grad pass 2 (mixed, 'mixed' prompt): weighted CE + palette regression;
   then each extra student pass of the JAX ``loss_mix``, each with its own
   backward into the same ``.grad`` (gradients are linear: the sum is JAX's
   grads_src + grads_mix, and only one pass's activations are alive at a
   time): MIC (CE on the masked target, ``mic_reg`` its decoder latent
   against the pseudo-label's palette latent), ``remove_texture`` (CE on the
   edge map), the masked or perturbed prompt (CE; the perturbed pass trains
   the head alone), ``denoise_supervise`` (decoder latent at a drawn
   timestep) and ``noise_reg`` (decoder latent of the strong-augmented
   target against the noise-reg pseudo-label's palette latent);
8. the head's BN statistics chain source -> mixed -> MIC in place; the
   teacher's come from its own pass;
9. under a process group, the trained gradients averaged
   over the ranks (once, after the last backward); global-norm clip, the
   optimizer (AdamW, or with ``optimizer='adafactor'`` Adafactor) at the
   scheduled learning rate (``unet_lr`` scales the UNet's and the adapters'
   updates), step + 1.

Data parallel (``madm_torch.parallel``): each rank steps on its rows of the
global batch, and the step is the single-process step on the global batch,
as the JAX package's GSPMD step is: ``sample_draws`` draws for the global
batch on every rank from the same generator and keeps this rank's rows of
the per-sample draws; the head's train-mode BatchNorm takes global
statistics; the batch means that weigh losses ('batch' pseudo-weight,
``prompt_confidence``'s agreement, the decoder losses' ``pv``) and the
returned metrics are means over the ranks; the optimizer state is sharded
(ZeRO-1) and the parameters stay bit-identical across ranks.  The losses'
denominators are pixel counts fixed by the shapes, equal on every rank
(``criterion.label_smooth_cross_entropy`` divides by a count of valid
pixels, but no step uses it).

With LoRA adapters (``MADMConfig.lora_configs``), the source pass takes
the ``default`` adapter and the teacher and target passes the target
modality's, each where the model holds it (JAX ``train_step.py:290-292``).

``batch``: {'source_rgb' [B,H,W,3] in [0,1], 'source_label' [B,H,W] int
(255 ignored), 'target_second_modality' [B,H,W,3] in [0,1]}, plus
'source_pl_data' for ``merge_with_pl_data`` and 'target_second_modality_pha'
for ``remove_texture``.  The random values come from ``sample_draws`` with
an explicit generator, or from a ``draws`` dict of the same keys (tests hand
in the JAX package's values).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models import prompt as prompt_lib
from ..models.daformer import DROPOUT_RATIO, argmax_classes
from ..models.madm import MADM, MADMConfig, trainable_parameters
from ..ops import dacs, palette
from ..parallel import dist as dist_lib
from . import criterion
from .ema import ema_alpha, update_ema
from .optimizer import clip_by_global_norm_, get_lr_schedule, make_optimizer, set_lr

PL_MERGE_MODES = ("only_pl_data", "linear_mix", "gradual_linear_mix", "anti_gradual_linear_mix",
                  "random_choice")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The UDA step's settings: every field of the JAX ``TrainConfig``, and
    the port's optimizer values (defaults: the shipped Cityscapes RGB ->
    DELIVER Depth config, 11 classes)."""

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
    vae_decoder_loss: str = "st"  # palette regression on 's' source, 't' mixed, both, or none ('')
    vae_decoder_loss_type: str = "L1"  # or 'L2'
    vae_decoder_loss_weight: Tuple[float, float] = (1.0, 1.0)
    reg_uncertain: bool = True
    pl_crop: bool = False  # pseudo-weight 0 on the top psweight_ignore_top rows
    psweight_ignore_top: int = 15
    pseudo_weight_scope: str = "sample"  # confident fraction per 'sample' or over the 'batch'
    mic: bool = False  # masked-image consistency (CE on the block-masked target)
    mask_ratio: float = 0.7
    mic_reg: float = 0.0  # MIC decoder latent against the pseudo-label's palette latent
    mic_reg_wo_pl_val: bool = False
    remove_texture: bool = False  # the MIC loss slot on the target's edge map
    denoise_supervise: float = 0.0  # decoder latent at a drawn timestep
    fd: float = 0.0  # UNet taps against the initial UNet's (add_feature_distance_baseline)
    fd_attention: float = 0.0  # fd on the up-block cross-attention maps (fd takes precedence)
    target_attention_loss: bool = False  # student's target maps against the teacher's
    noise_reg: float = 0.0  # strong-augmented target against the noise-reg teacher
    mask_prompt_ratio: float = 0.0  # the MIC loss slot with a token-masked prompt
    detach_mask_prompt: bool = False
    prompt_perturbation: float = 0.0  # the MIC loss slot with a perturbed prompt, head only
    prompt_confidence: Optional[float] = None  # set: agreement with a random-prompt teacher
    rand_prompt_scale: float = 0.5
    denoise_interval: int = 0  # added to denoise_supervise's timestep
    merge_with_pl_data: Optional[str] = None  # one of PL_MERGE_MODES
    pl_merge_val: float = 0.5
    train_palette: Tuple[int, ...] = palette.DELIVER_11_PALETTE
    lr: float = 5e-6
    weight_decay: float = 0.05
    grad_clip: float = 0.01
    unet_lr: Optional[float] = None  # the UNet's and the adapters' lr (None: lr)
    schedule: str = "multistep"  # or 'linear' (--warmup_lr)
    optimizer: str = "adamw"  # or 'adafactor' (the JAX package's single-chip memory reducer)
    b1: Optional[float] = 0.9  # None (optimizer.no_momentum, adafactor only): no first moment
    b2: float = 0.999  # adamw's
    eps: float = 1e-8  # adamw's
    mu_dtype: Optional[str] = None  # first-moment storage: 'bfloat16' (adafactor's default) or fp32

    def __post_init__(self):
        if set(self.vae_decoder_loss) - set("st"):
            raise ValueError(f"vae_decoder_loss {self.vae_decoder_loss!r}")
        if self.vae_decoder_loss_type not in ("L1", "L2"):
            raise ValueError(f"vae_decoder_loss_type {self.vae_decoder_loss_type!r}")
        if self.optimizer not in ("adamw", "adafactor"):
            raise ValueError(f"optimizer {self.optimizer!r} is not 'adamw' or 'adafactor'")
        if self.b1 is None and self.optimizer != "adafactor":
            raise ValueError("optimizer.no_momentum (b1=None) only applies to name='adafactor'; "
                             f"adamw requires a first-moment beta (got name={self.optimizer!r})")
        if self.mu_dtype not in (None, "bfloat16", "float32"):
            raise ValueError(f"mu_dtype {self.mu_dtype!r}")
        if self.pseudo_weight_scope not in ("sample", "batch"):
            raise ValueError(f"pseudo_weight_scope {self.pseudo_weight_scope!r}")
        if self.merge_with_pl_data not in (None,) + PL_MERGE_MODES:
            raise ValueError(f"merge_with_pl_data {self.merge_with_pl_data!r}")
        # the reference allows one of them (cmdise.py:184; remove_texture
        # shares the loss slot, cmdise.py:567-576)
        if (bool(self.mask_prompt_ratio) + bool(self.prompt_perturbation) + bool(self.mic)
                + bool(self.remove_texture)) > 1:
            raise ValueError("mask_prompt/prompt_perturbation/mic/remove_texture are exclusive")


@dataclasses.dataclass
class TrainState:
    model: MADM
    tc: TrainConfig
    optimizer: torch.optim.Optimizer
    params: Sequence[torch.nn.Parameter]  # what the optimizer updates
    schedule: Any  # update count -> learning rate
    step: int = 0
    # the fd baseline (``add_feature_distance_baseline``): frozen copies of
    # the initial UNet ('ori_unet') and prompt sets ('ori_prompt')
    consts: Dict[str, nn.Module] = dataclasses.field(default_factory=dict)


# defaults of the knobs build_train_config reads from the model node: the
# JAX package's MADMConfig fields, used where a config does not set them
_KNOB_DEFAULTS: Dict[str, Any] = {
    "ema_alpha": 0.999, "pseudo_threshold": 0.968, "blur": True, "color_jitter_strength": 0.2,
    "color_jitter_probability": 0.2, "enable_mixup": True, "rev_noise_sup": False,
    "rev_noise_end_iter": None, "rev_noise_gradually": False, "denoise_timestep_range": None,
    "vae_decoder_loss": "st", "vae_decoder_loss_type": "L1", "vae_decoder_loss_weight": (1.0, 1.0),
    "reg_uncertain": False, "pseudo_weight_scope": "sample", "train_palette": (),
    "pl_crop": False, "psweight_ignore_top": 15, "mic": False, "mask_ratio": 0.7, "mic_reg": 0.0,
    "mic_reg_wo_pl_val": False, "remove_texture": False, "denoise_supervise": 0.0, "fd": 0.0,
    "fd_attention": 0.0, "target_attention_loss": False, "noise_reg": 0.0,
    "mask_prompt_ratio": 0.0, "detach_mask_prompt": False, "prompt_perturbation": 0.0,
    "prompt_confidence": None, "rand_prompt_scale": 0.5, "denoise_interval": 0,
    "merge_with_pl_data": None, "pl_merge_val": 0.5,
}
# optimizer-node values the port takes; others raise.  The JAX package reads
# neither: its wd mask fixes the norms' and biases' decay at 0
_OPTIMIZER_PORTED: Dict[str, Any] = {"weight_decay_norm": (0.0,), "weight_decay_bias": (0.0,)}


def build_train_config(cfg) -> TrainConfig:
    """TrainConfig from a loaded LazyConfig tree (the JAX package's
    ``build_train_config``): the UDA knobs from the model node, where an
    optional ``cfg.uda`` namespace overrides them; ``max_iter`` and the clip
    from ``cfg.train``; the rule (``name``), lr, weight decay, betas (b1 None
    with ``no_momentum``), eps, ``mu_dtype``, ``unet_lr`` and the schedule
    from ``cfg.optimizer``, as JAX ``main.py:458-473`` passes them."""
    uda = dict(cfg.get("uda", {}) or {})
    model = cfg.model

    def knob(name):
        if uda.get(name) is not None:
            return uda[name]
        if name == "mic_reg_wo_pl_val" and model.get("MIC_reg_wo_pl_val") is not None:
            return model["MIC_reg_wo_pl_val"]  # the reference's spelling, mtmadise.py:44
        value = model.get(name, _KNOB_DEFAULTS[name])
        return _KNOB_DEFAULTS[name] if value is None else value

    opt = cfg.optimizer
    for name, ported in _OPTIMIZER_PORTED.items():
        value = opt.get(name, ported[0])
        if (tuple(value) if isinstance(value, list) else value) not in ported:
            raise NotImplementedError(f"optimizer.{name}={value!r} is not ported to madm_torch yet "
                                      f"(it takes {' or '.join(map(repr, ported))})")
    betas = tuple(opt.get("betas", (0.9, 0.999)))
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
        pl_crop=knob("pl_crop"),
        psweight_ignore_top=knob("psweight_ignore_top"),
        pseudo_weight_scope=knob("pseudo_weight_scope"),
        mic=knob("mic"),
        mask_ratio=knob("mask_ratio"),
        mic_reg=float(knob("mic_reg")),
        mic_reg_wo_pl_val=knob("mic_reg_wo_pl_val"),
        remove_texture=knob("remove_texture"),
        denoise_supervise=float(knob("denoise_supervise")),
        fd=float(knob("fd")),
        fd_attention=float(knob("fd_attention")),
        target_attention_loss=bool(knob("target_attention_loss")),
        noise_reg=float(knob("noise_reg")),
        mask_prompt_ratio=float(knob("mask_prompt_ratio")),
        detach_mask_prompt=knob("detach_mask_prompt"),
        prompt_perturbation=float(knob("prompt_perturbation")),
        prompt_confidence=knob("prompt_confidence"),
        rand_prompt_scale=knob("rand_prompt_scale"),
        denoise_interval=int(knob("denoise_interval")),
        merge_with_pl_data=knob("merge_with_pl_data"),
        pl_merge_val=float(knob("pl_merge_val")),
        train_palette=tuple(knob("train_palette")),
        lr=opt["lr"],
        weight_decay=opt["weight_decay"],
        grad_clip=cfg.train.get("grad_clip") or 0.01,
        unet_lr=opt.get("unet_lr"),
        schedule=opt.get("schedule", "multistep"),
        optimizer=opt.get("name", "adamw"),
        b1=None if opt.get("no_momentum") else float(betas[0]),
        b2=float(betas[1]),
        eps=float(opt.get("eps", 1e-8)),
        mu_dtype=opt.get("mu_dtype"),
    )


def check_composition(cfg: MADMConfig, tc: TrainConfig) -> None:
    """The step's composition rules of JAX ``make_train_step``
    (``train_step.py:246-276``): the concat slot is wired through the
    source, mixed and teacher passes only, and the slide path gives no
    decoder outputs."""
    if cfg.concat_attention_to_conv_seg and (tc.mic or tc.mask_prompt_ratio or tc.prompt_perturbation
                                             or tc.noise_reg or tc.prompt_confidence is not None):
        raise ValueError("concat_attention_to_conv_seg does not compose with the aux-pass ablations "
                         "(mic/mask_prompt/prompt_perturbation/noise_reg/prompt_confidence): their "
                         "extra head calls are not wired for the concat slot")
    if cfg.slide_training and (tc.vae_decoder_loss or tc.mic_reg or tc.denoise_supervise
                               or tc.noise_reg or tc.reg_uncertain):
        raise ValueError("slide_training is incompatible with decoder-output losses "
                         "(vae_decoder_loss/mic_reg/denoise_supervise/noise_reg/reg_uncertain): set "
                         "them off, as the reference requires")
    if (tc.fd_attention or tc.target_attention_loss) and not cfg.attention_features_res:
        raise ValueError("fd_attention and target_attention_loss need the model's "
                         "attention_features_res/location")


def make_train_state(model: MADM, tc: TrainConfig) -> TrainState:
    """The optimizer state of ``model`` (sharded over the ranks under a
    process group), after ``check_composition``; with ``tc.fd`` or
    ``tc.fd_attention`` the caller adds the baseline
    (``add_feature_distance_baseline``) once the weights it starts from are
    loaded."""
    check_composition(model.cfg, tc)
    named = trainable_parameters(model)
    return TrainState(model=model, tc=tc,
                      optimizer=make_optimizer(model, named, tc.lr, tc.weight_decay,
                                               betas=(tc.b1, tc.b2), eps=tc.eps, unet_lr=tc.unet_lr,
                                               name=tc.optimizer, mu_dtype=tc.mu_dtype),
                      params=[p for _, p in named],
                      schedule=get_lr_schedule(tc.lr, tc.max_iter, tc.schedule))


def add_feature_distance_baseline(state: TrainState) -> TrainState:
    """Frozen copies of the model's UNet and prompt sets, the ``fd`` target
    (JAX ``add_feature_distance_baseline``; reference ``ori_unet =
    deepcopy(...)``, cmdise.py:332-335): copies, so that training the
    student leaves them as they were."""
    model = state.model
    for name, module in (("ori_unet", model.unet), ("ori_prompt", model.prompt)):
        frozen = copy.deepcopy(module)
        frozen.requires_grad_(False)
        state.consts[name] = frozen
    return state


def rev_noise_timestep(draw: int, step: int, tc: TrainConfig) -> int:
    """The teacher's timestep (JAX ``rev_noise_timestep``): 0 without
    ``rev_noise_sup`` or past end_iter; else the drawn t, scaled by
    (1 - step/end_iter) in fp32 when ``rev_noise_gradually``."""
    if not tc.rev_noise_sup or step > tc.rev_noise_end_iter:
        return 0
    if not tc.rev_noise_gradually:
        return int(draw)
    f = np.float32(1.0) - np.float32(step) / np.float32(tc.rev_noise_end_iter)
    return int(np.float32(draw) * f)


def sample_draws(generator: torch.Generator, tc: TrainConfig, labels: torch.Tensor,
                 num_classes: int, head: torch.nn.Module,
                 cfg: Optional[MADMConfig] = None) -> Dict[str, Any]:
    """Every random value of one step: the DACS mask, the jitter and blur
    draws, the teacher timestep draw and three heads' Dropout2d channel
    multipliers (source, mixed, teacher); then those of the branches ``tc``
    (and the model config ``cfg``) turn on: the MIC slot's head dropout, the
    MIC strong transform and block-mask scores, the denoise and noise-reg
    timesteps, the noise-reg strong transform, the mixed pass's latent
    noise, the prompt ablations' values and the random_choice uniform.

    Under a process group, ``labels`` are this rank's rows:
    every rank draws for the global batch from the same generator and keeps
    its rows of the per-sample draws (per-step draws, such as the teacher's
    timestep, are the whole draw); the DACS mask's present classes are the
    global batch's."""
    b, h, w = labels.shape
    rows = dist_lib.local_rows(b * dist_lib.world())
    b *= dist_lib.world()
    dev = generator.device
    scores = dacs.draw_class_scores(generator, b, num_classes)[rows]
    lo, hi = tc.denoise_timestep_range

    def dropout(n):
        keep = torch.rand(n, b, head.channels, generator=generator, device=dev)[:, rows] >= DROPOUT_RATIO
        return list(keep.float() / (1.0 - DROPOUT_RATIO))

    def timesteps():
        return torch.randint(lo, hi + 1, (b,), generator=generator, device=dev)[rows]

    keep = dropout(3)  # drawn before the jitter, blur and timestep, the shipped order

    def strong():
        return (dacs.draw_color_jitter(generator, tc.color_jitter_strength, tc.color_jitter_probability),
                dacs.draw_gaussian_blur(generator) if tc.blur else None)

    draws: Dict[str, Any] = {
        "mix_mask": dacs.class_masks(labels, scores, num_classes,
                                     dist_lib.any_over_ranks(dacs.present_classes(labels, num_classes))),
        "jitter": dacs.draw_color_jitter(generator, tc.color_jitter_strength,
                                         tc.color_jitter_probability),
        "blur": dacs.draw_gaussian_blur(generator) if tc.blur else None,
        "t_pl": int(torch.randint(lo, hi + 1, (1,), generator=generator, device=dev).item()),
        "dropout": keep,
    }
    if tc.mic or tc.remove_texture or tc.mask_prompt_ratio or tc.prompt_perturbation:
        draws["dropout"] += dropout(1)
    if tc.mic or tc.mic_reg or tc.remove_texture:
        draws["mic_jitter"], draws["mic_blur"] = strong()
    if tc.mic or tc.mic_reg:
        draws["mic_mask"] = dacs.draw_block_mask(generator, b, h, w)[rows]
    if tc.denoise_supervise:
        draws["t_ds"] = timesteps()
    if tc.noise_reg:
        draws["nr_jitter"], draws["nr_blur"] = strong()
        draws["t_nr"] = timesteps()
    seq_len = (cfg.prompt_seq_len if cfg is not None else None) or prompt_lib.PROMPT_SEQ_LEN
    lead = (prompt_lib.NUM_UNET_LAYERS,) if cfg is not None and cfg.multi_layer_prompt else ()
    if cfg is not None and cfg.add_latent_noise != -1.0:
        draws["latent_noise"] = torch.randn(b, 4, h // 8, w // 8, generator=generator, device=dev)[rows]
    batch = b if cfg is not None and cfg.clip_state != "no" else 1  # a prefix prompt is per image

    def prompt_draw(mode):
        draw = prompt_lib.draw_prompt_ablation(generator, mode, seq_len, lead, batch)
        return draw[rows] if batch != 1 else draw

    if tc.mask_prompt_ratio:
        draws["prompt"] = prompt_draw("masked_prompt")
    elif tc.prompt_perturbation:
        draws["prompt"] = prompt_draw("prompt_perturbation")
    if tc.prompt_confidence is not None:
        draws["rand_prompt"] = prompt_draw("rand_prompt")
    if tc.merge_with_pl_data == "random_choice":
        draws["pl_choice"] = float(torch.rand((), generator=generator, device=dev).item())
    return draws


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


def merge_pl_data(source: torch.Tensor, pl: torch.Tensor, tc: TrainConfig, step: int,
                  draws: Dict[str, Any]) -> torch.Tensor:
    """The source image mixed with stage-1 pl data (JAX ``train_step.py:
    323-346``, reference ``cmdise.py:392-408``)."""
    mode = tc.merge_with_pl_data
    if mode == "only_pl_data":
        return pl
    if mode == "random_choice":
        return pl if draws["pl_choice"] > 1 - tc.pl_merge_val else source
    if mode == "linear_mix":
        v = tc.pl_merge_val
    elif mode == "gradual_linear_mix":
        v = float(np.float32(step) / np.float32(tc.max_iter))
    else:  # anti_gradual_linear_mix
        v = float(max(np.float32(0.0), np.float32(1.0) - np.float32(step) / np.float32(tc.max_iter * 0.5)))
    return (1 - v) * source + v * pl


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
    hw = target.shape[1:3]
    if draws is None:
        if generator is None:
            raise ValueError("train_step needs a generator or draws")
        draws = sample_draws(generator, tc, gt, cfg.num_classes, model.sem_seg_head, cfg)
    drop_src, drop_mix, drop_tch, *drop_aux = (None if d is None else d.to(dev) for d in draws["dropout"])
    src_lora, tgt_lora = pass_adapters(model)
    modality = cfg.target_modality
    concat = cfg.concat_attention_to_conv_seg
    step = state.step
    if (tc.fd or tc.fd_attention) and "ori_unet" not in state.consts:
        raise ValueError("TrainConfig.fd and fd_attention need add_feature_distance_baseline(state)")

    def backbone(images, **kw):
        """A pass; under ``slide_training`` an input larger than the crop
        takes the sliding window (JAX's 'auto' form: a pass a window at
        B=1 or past 8 crops), which gives ``output_features`` alone."""
        if cfg.slide_training and tuple(images.shape[1:3]) != tuple(cfg.crop_size):
            n = len(model.slide_windows(*images.shape[1:3]))
            form = "window" if images.shape[0] == 1 or images.shape[0] * n > 8 else "batch"
            return model.slide_backbone_forward(images, form=form, **kw)
        return model.backbone_forward(images, **kw)

    # 1. EMA teacher
    update_ema(model.student_ema_pairs(), ema_alpha(step, tc.ema_alpha))

    # 2. two-stage pl data
    if tc.merge_with_pl_data is not None:
        source = merge_pl_data(source, batch["source_pl_data"].to(dev, torch.float32), tc, step,
                               draws)

    table = torch.from_numpy(palette.reg_target_table(tc.train_palette, cfg.reg_target_palette))
    class_table = torch.from_numpy(palette.palette_table(tc.train_palette)[: cfg.num_classes])
    tgt_mask_diff = model.modality_mask(target, modality)
    with torch.no_grad():
        # 3. DACS mix inputs
        mix_mask = draws["mix_mask"].to(dev, torch.float32)
        mixed_img = dacs.one_mix(mix_mask[..., None], source, target)
        mixed_img = dacs.strong_transform(mixed_img, draws["jitter"], draws["blur"] if tc.blur else None)

        # 4. teacher pseudo-labels (the EMA head in train mode: batch-stat BN,
        # dropout on, its running statistics updated); its attention maps
        # for target_attention_loss and the concat slot
        t_pl = rev_noise_timestep(draws["t_pl"], step, tc)
        tch = backbone(target, input_modal="others", lora_name=tgt_lora, ema_forward=True,
                       timesteps=torch.full((b,), t_pl, device=dev), modality_mask=tgt_mask_diff,
                       capture_attention=tc.target_attention_loss or concat)

        def teacher_label(**kw):
            """An extra teacher pass's argmax through the eval-mode EMA head."""
            out = backbone(target, input_modal="others", lora_name=tgt_lora, ema_forward=True,
                           modality_mask=tgt_mask_diff, **kw)
            logits = model.head_forward(out["output_features"], ema_forward=True)
            return argmax_classes(criterion.resize_logits(logits.float(), hw))

        if tc.prompt_confidence is not None:
            rp_label = teacher_label(prompt_mode="rand_prompt", prompt_draw=draws["rand_prompt"])
        if tc.noise_reg:
            nr_label = teacher_label(timesteps=draws["t_nr"].to(dev))
        ema_logits = model.head_forward(tch["output_features"], ema_forward=True, train=True,
                                        update_bn=True, dropout=drop_tch,
                                        cross_attention_feat=tch.get("cross_attention_feat"))
        ema_sm = torch.softmax(criterion.resize_logits(ema_logits.float(), hw), dim=1)
        pseudo_prob = ema_sm.amax(dim=1)
        pseudo_label = argmax_classes(ema_sm)
        pseudo_val = (pseudo_prob >= tc.pseudo_threshold).float().mean(dim=(1, 2))
        if tc.pseudo_weight_scope == "batch":
            pseudo_weight = dist_lib.all_reduce_mean(pseudo_val.mean()).expand_as(pseudo_prob)
        else:
            pseudo_weight = pseudo_val[:, None, None].expand_as(pseudo_prob)
        if tc.prompt_confidence is not None:
            pseudo_weight = pseudo_weight * dist_lib.all_reduce_mean((pseudo_label == rp_label).float().mean())
        if tc.pl_crop:
            pseudo_weight = pseudo_weight.clone()
            pseudo_weight[:, : tc.psweight_ignore_top, :] = 0.0

        # 5. mixed labels / weights, reg_uncertain metric, palette latents
        if tc.enable_mixup:
            mixed_lbl = dacs.one_mix(mix_mask, gt.float(), pseudo_label.float()).long()
            mixed_w = dacs.one_mix(mix_mask, torch.ones_like(pseudo_weight), pseudo_weight)
        else:
            mixed_lbl, mixed_w = pseudo_label.long(), pseudo_weight
        if tc.reg_uncertain and cfg.use_s0:
            dec01 = (tch["after_vae_decoder"].float().permute(0, 2, 3, 1) + 1) / 2
            reg_prob = palette.palette_distance_pseudo_label(dec01, class_table)[0]
        else:
            reg_prob = torch.zeros((), device=dev)
        teacher_maps = list(tch.get("attention_features", {}).values())
        del tch, ema_logits, ema_sm
        if "s" in tc.vae_decoder_loss:
            src_gt_lat, src_valid = _encode_palette(model, gt, table)
        if "t" in tc.vae_decoder_loss:
            tgt_gt_lat, tgt_valid = _encode_palette(model, mixed_lbl, table)
            tgt_mask = tgt_valid * pseudo_weight[..., None]
        if tc.mic_reg or tc.denoise_supervise:
            pl_color_lat = _encode_palette(model, pseudo_label, table)[0]
            pv = dist_lib.all_reduce_mean(pseudo_val.mean())
        if tc.noise_reg:
            nr_color_lat = _encode_palette(model, nr_label, table)[0]

    state.optimizer.zero_grad(set_to_none=True)
    losses: Dict[str, torch.Tensor] = {}

    def backward(part: Dict[str, torch.Tensor]) -> None:
        sum(part.values()).backward()
        losses.update(part)

    def target_pass(images, **kw):
        return backbone(images, input_modal="others", lora_name=tgt_lora, train=True,
                        modality_mask=tgt_mask_diff, **kw)

    def slot_loss(out, update_bn=False):
        """The MIC loss slot: CE of a train-mode head pass (the second head
        where the model has one) against the pseudo-labels, pseudo-weighted."""
        logits = model.head_forward(out["output_features"], train=True, update_bn=update_bn,
                                    dropout=drop_aux[0], use_sec_modal=True)
        return criterion.cross_entropy(logits, pseudo_label, pixel_weight=pseudo_weight)

    # 6. grad pass 1: source (its maps for fd_attention and the concat slot)
    src_mask_diff = model.modality_mask(source, "rgb")
    out = backbone(source, input_modal="rgb", lora_name=src_lora, train=True,
                   modality_mask=src_mask_diff, capture_attention=bool(tc.fd_attention) or concat)
    logits = model.head_forward(out["output_features"], train=True, update_bn=True, dropout=drop_src,
                                cross_attention_feat=out.get("cross_attention_feat"))
    part = {"source_loss": criterion.cross_entropy(logits, gt)}
    if tc.fd or tc.fd_attention:  # one loss slot; fd takes precedence (mtmadise.py:533-546)
        with torch.no_grad():
            ori = backbone(source, input_modal="rgb", unet=state.consts["ori_unet"],
                           prompt=state.consts["ori_prompt"], modality_mask=src_mask_diff,
                           capture_attention=bool(tc.fd_attention) and not tc.fd, features=False)
        key = "unet_taps" if tc.fd else "up_cross"
        part["feature_distance_loss"] = criterion.feature_distance_loss(
            out[key], ori[key], tc.fd or tc.fd_attention)
        del ori
    if "s" in tc.vae_decoder_loss:
        part["vae_decoder_source_loss"] = criterion.vae_decoder_loss(
            out["before_vae_decoder"], src_gt_lat, src_valid, tc.vae_decoder_loss_weight[0],
            tc.vae_decoder_loss_type)
    backward(part)
    del out, logits, part

    # 7. grad pass 2: mixed, then the extra student passes of JAX's loss_mix
    out = backbone(mixed_img, input_modal="mixed", lora_name=tgt_lora, train=True,
                   latent_noise=draws.get("latent_noise"),
                   modality_mask=model.mixed_modality_mask(mix_mask, modality),
                   capture_attention=concat)
    logits = model.head_forward(out["output_features"], train=True, update_bn=True, dropout=drop_mix,
                                use_sec_modal=True, cross_attention_feat=out.get("cross_attention_feat"))
    part = {"target_loss": criterion.cross_entropy(logits, mixed_lbl, pixel_weight=mixed_w)}
    if "t" in tc.vae_decoder_loss:
        part["vae_decoder_target_loss"] = criterion.vae_decoder_loss(
            out["before_vae_decoder"], tgt_gt_lat, tgt_mask, tc.vae_decoder_loss_weight[1],
            tc.vae_decoder_loss_type)
    backward(part)
    del out, logits, part
    mic_blur = draws.get("mic_blur") if tc.blur else None
    if tc.mic or tc.mic_reg:
        with torch.no_grad():
            masked = dacs.strong_transform(target, draws["mic_jitter"], mic_blur)
            masked = dacs.mask_image(masked, draws["mic_mask"], tc.mask_ratio)
        out = target_pass(masked, features=tc.mic)
        part = {}
        if tc.mic:  # the head's BN statistics chain source -> mixed -> masked
            part["masked_prompt_consistency_loss"] = slot_loss(out, update_bn=True)
        if tc.mic_reg:
            part["mic_vae_decoder_loss"] = criterion.denoise_consistency_loss(
                out["before_vae_decoder"], pl_color_lat, 1.0 if tc.mic_reg_wo_pl_val else pv,
                tc.vae_decoder_loss_type, tc.mic_reg)
        backward(part)
        del out, part
    if tc.remove_texture:  # strong transform only, no block mask (cmdise.py:573-576)
        with torch.no_grad():
            edges = dacs.strong_transform(batch["target_second_modality_pha"].to(dev, torch.float32),
                                          draws["mic_jitter"], mic_blur)
        backward({"masked_prompt_consistency_loss": slot_loss(target_pass(edges))})
    if tc.mask_prompt_ratio:
        out = target_pass(target, prompt_mode="masked_prompt", prompt_draw=draws["prompt"])
        backward({"masked_prompt_consistency_loss": slot_loss(out)})
        del out
    elif tc.prompt_perturbation:
        # the backbone runs without a graph (reference ldm_base.py:920-924);
        # only the head trains
        out = backbone(target, input_modal="others", lora_name=tgt_lora,
                       prompt_mode="prompt_perturbation", prompt_draw=draws["prompt"],
                       modality_mask=tgt_mask_diff)
        backward({"masked_prompt_consistency_loss": slot_loss(out)})
        del out
    if tc.target_attention_loss:
        # the student's maps on the target against the teacher's (its pass
        # above); the loss reads the maps alone, so the pass stops after the UNet
        out = target_pass(target, capture_attention=True, features=False)
        backward({"target_attention_loss": criterion.feature_distance_loss(
            list(out["attention_features"].values()), teacher_maps, 1.0)})
        del out
    if tc.denoise_supervise:
        t_ds = draws["t_ds"].to(dev) + tc.denoise_interval
        out = target_pass(target, timesteps=t_ds, features=False)
        backward({"denoise_consistency_loss": criterion.denoise_consistency_loss(
            out["before_vae_decoder"], pl_color_lat, pv, tc.vae_decoder_loss_type,
            tc.denoise_supervise)})
        del out
    if tc.noise_reg:
        with torch.no_grad():
            aug = dacs.strong_transform(target, draws["nr_jitter"],
                                        draws["nr_blur"] if tc.blur else None)
        out = target_pass(aug, features=False)
        backward({"noise_reg_loss": criterion.denoise_consistency_loss(
            out["before_vae_decoder"], nr_color_lat, 1.0, tc.vae_decoder_loss_type, tc.noise_reg)})
        del out

    # 9. gradients averaged over the ranks, clip, the optimizer, step + 1
    dist_lib.all_reduce_mean_([p.grad for p in state.params if p.grad is not None])
    grad_norm = clip_by_global_norm_(state.params, tc.grad_clip)
    set_lr(state.optimizer, state.schedule(step))
    state.optimizer.step()
    state.step = step + 1

    names = list(losses) + ["total_loss", "pseudo_val", "reg_prob_mean", "grad_norm"]
    values = [v.detach().float() for v in losses.values()]
    values += [sum(values), pseudo_val.mean(), reg_prob.mean(), grad_norm.float()]
    return dict(zip(names, dist_lib.all_reduce_mean(torch.stack(values)).tolist()))
