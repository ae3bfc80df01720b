"""Training-vis data collection (port of ``madm_tpu/train/vis.py``; reference
``mtmadise.py:551-653``).

Re-derives the step's no-grad intermediates (DACS mix, teacher pseudo-labels,
decoder RGB outputs, reg-uncertain maps) from the SAME random draws the train
step used (``sample_draws``), plus plain student passes for the prediction
panels; called every ``vis_period`` iterations, after the step.

Panels (``mtmadise.py:559-569`` and the conditionals of the shipped branch):

- source_rgb / source_pred / source_label
- target_sec_modal / target_sec_modal_pl (+ ``_{t}_t`` while rev-noise is on)
- mixup_modal / mixup_pred / mixup_label
- source_vae_decoder_out / target_vae_decoder_out (``'s'``/``'t'`` in
  vae_decoder_loss; ``:590-598``)
- masked_image / masked_image_pred (``mic``, ``mic_reg``; ``:572-576``)
- pl_reg / pl_prob_reg / pl_prob_{pseudo_val} (``reg_uncertain``; ``:599-604``)

The passes take the train step's adapters (``pass_adapters``; JAX
``vis.py:44-46``).  The attention overlays belong to attention capture,
which the port has not taken (ROADMAP §A3).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..models.madm import MADM
from ..ops import dacs, palette
from . import criterion
from .train_step import TrainConfig, pass_adapters, rev_noise_timestep


def make_vis_fn(model: MADM, tc: TrainConfig) -> Callable[..., Dict[str, np.ndarray]]:
    """Collector: (batch, draws, step) -> dict of host arrays.  ``draws`` must
    be the ones the train step of that iteration used, so that the mix,
    jitter and rev-noise timestep reproduce its inputs."""
    cfg = model.cfg
    src_lora, tgt_lora = pass_adapters(model)
    class_table = torch.from_numpy(palette.palette_table(tc.train_palette)[: cfg.num_classes])

    def decoded01(eps: torch.Tensor) -> torch.Tensor:
        """The s0 branch's decoder output in [0, 1], NHWC fp32."""
        dec = model.vae.decode(eps.to(model.vae.quant_conv.weight.dtype)).clamp(-1.0, 1.0)
        return (dec.float().permute(0, 2, 3, 1) + 1) / 2

    def logits_at(out, hw, **kw) -> torch.Tensor:
        lg = model.head_forward(out["output_features"], **kw)
        return criterion.resize_logits(lg.float(), hw).permute(0, 2, 3, 1)

    @torch.no_grad()
    def vis_fn(batch: Dict[str, torch.Tensor], draws: Dict[str, Any], step: int) -> Dict[str, np.ndarray]:
        dev = model.device
        source = batch["source_rgb"].to(dev, torch.float32)
        target = batch["target_second_modality"].to(dev, torch.float32)
        gt = batch["source_label"].to(dev).long()
        b = source.shape[0]
        mix_mask = draws["mix_mask"].to(dev, torch.float32)
        mixed_img = dacs.one_mix(mix_mask[..., None], source, target)
        mixed_img = dacs.strong_transform(mixed_img, draws["jitter"], draws["blur"] if tc.blur else None)
        t_pl = rev_noise_timestep(draws["t_pl"], step, tc)
        out: Dict[str, torch.Tensor] = {"source_rgb": source, "source_label": gt,
                                        "target_sec_modal": target, "mixup_modal": mixed_img}

        # teacher pseudo-label pass (eval-mode head)
        tch = model.backbone_forward(target, input_modal="others", lora_name=tgt_lora,
                                     ema_forward=True, timesteps=torch.full((b,), t_pl, device=dev))
        ema_logits = logits_at(tch, target.shape[1:3], ema_forward=True)
        out["target_sec_modal_pl"] = ema_logits
        ema_sm = torch.softmax(ema_logits, dim=-1)
        pseudo_prob, pseudo_label = ema_sm.max(dim=-1)
        out["pl_prob"] = pseudo_prob
        out["pseudo_val"] = (pseudo_prob >= tc.pseudo_threshold).float().mean()
        out["mixup_label"] = dacs.one_mix(mix_mask, gt.float(), pseudo_label.float()).long()

        # student source and mixed prediction panels
        src = model.backbone_forward(source, input_modal="rgb", lora_name=src_lora)
        out["source_pred"] = logits_at(src, source.shape[1:3])
        if "s" in tc.vae_decoder_loss and cfg.use_s0:
            out["source_vae_decoder_out"] = decoded01(src["before_vae_decoder"])
        mix = model.backbone_forward(mixed_img, input_modal="mixed", lora_name=tgt_lora,
                                     latent_noise=draws.get("latent_noise"))
        out["mixup_pred"] = logits_at(mix, mixed_img.shape[1:3])
        if "t" in tc.vae_decoder_loss and cfg.use_s0:
            out["target_vae_decoder_out"] = decoded01(mix["before_vae_decoder"])

        # MIC masked panel: the step's masked target and its prediction
        if tc.mic or tc.mic_reg:
            masked = dacs.strong_transform(target, draws["mic_jitter"],
                                           draws["mic_blur"] if tc.blur else None)
            masked = dacs.mask_image(masked, draws["mic_mask"], tc.mask_ratio)
            out["masked_image"] = masked
            if tc.mic:
                mic = model.backbone_forward(masked, input_modal="others", lora_name=tgt_lora)
                out["masked_image_pred"] = logits_at(mic, target.shape[1:3])

        # reg_uncertain palette-distance panels
        if tc.reg_uncertain and cfg.use_s0:
            dec01 = (tch["after_vae_decoder"].float().permute(0, 2, 3, 1) + 1) / 2
            reg_p, _, reg_sm = palette.palette_distance_pseudo_label(dec01, class_table)
            out["pl_reg"] = reg_sm
            out["pl_prob_reg"] = reg_p
        host = {k: v.cpu().numpy() for k, v in out.items()}
        host["rev_noise_t"] = np.asarray(t_pl)
        return host

    return vis_fn


def build_vis_data(host: Dict[str, np.ndarray], tc: TrainConfig, iteration: int) -> List[Dict]:
    """vis_fn outputs -> the reference's ordered vis_data panel list
    (``mtmadise.py:559-604``)."""
    pl_info = "target_sec_modal_pl"
    t = int(np.asarray(host["rev_noise_t"]))
    if tc.rev_noise_sup and iteration <= tc.rev_noise_end_iter and t > 0:
        pl_info += f"_{t}_t"

    def p(dtype, info, key):
        return {"data_type": dtype, "info": info, "data": np.asarray(host[key])}

    vis = [
        p("image", "source_rgb", "source_rgb"),
        p("logits", "source_pred", "source_pred"),
        p("label", "source_label", "source_label"),
        p("image", "target_sec_modal", "target_sec_modal"),
        p("logits", pl_info, "target_sec_modal_pl"),
        p("image", "mixup_modal", "mixup_modal"),
        p("logits", "mixup_pred", "mixup_pred"),
        p("label", "mixup_label", "mixup_label"),
    ]
    if "masked_image" in host:
        vis.append(p("image", "masked_image", "masked_image"))
    if "masked_image_pred" in host:
        vis.append(p("logits", "masked_image_pred", "masked_image_pred"))
    if "source_vae_decoder_out" in host:
        vis.append(p("image", "source_vae_decoder_out", "source_vae_decoder_out"))
    if "target_vae_decoder_out" in host:
        vis.append(p("image", "target_vae_decoder_out", "target_vae_decoder_out"))
    if "pl_reg" in host:
        pv = float(np.asarray(host["pseudo_val"]))
        vis.append(p("logits", "pl_reg", "pl_reg"))
        vis.append(p("heatmap", "pl_prob_reg", "pl_prob_reg"))
        vis.append({"data_type": "heatmap", "info": f"pl_prob_{pv:.3f}", "data": np.asarray(host["pl_prob"])})
    return vis
