"""UDA losses (port of ``madm_tpu/train/criterion.py``), on NCHW model outputs.

- Cross-entropy is a plain mean over *all* pixels: ignored pixels add 0 to
  the sum and still count in the denominator.
- The palette-regression loss is sum(d * mask) / numel * weight, d = |pred -
  gt| ('L1', the shipped type) or (pred - gt)^2 ('L2'), with the mask
  nearest-resized to the latent grid.
- The denoise / MIC decoder losses are plain means of d times a scalar pixel
  weight; the feature distance is the mean of the per-tap MSEs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

IGNORE_LABEL = 255


def resize_logits(logits: torch.Tensor, hw) -> torch.Tensor:
    """NCHW bilinear resize, align_corners=False, no antialias."""
    if tuple(logits.shape[2:]) == tuple(hw):
        return logits
    return F.interpolate(logits, size=tuple(hw), mode="bilinear", align_corners=False,
                         antialias=False)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  pixel_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [B, C, h, w] (resized to the labels), labels [B, H, W],
    pixel_weight [B, H, W] or None."""
    logits = resize_logits(logits.float(), labels.shape[1:3])
    nll = F.cross_entropy(logits, labels.long(), ignore_index=IGNORE_LABEL, reduction="none")
    if pixel_weight is not None:
        nll = nll * pixel_weight
    return nll.mean()


def _distance(pred: torch.Tensor, gt: torch.Tensor, loss_type: str) -> torch.Tensor:
    if loss_type == "L1":
        return (pred - gt).abs().float()
    if loss_type == "L2":
        return ((pred - gt) ** 2).float()
    raise ValueError(f"loss type {loss_type!r} is not 'L1' or 'L2'")


def vae_decoder_loss(pred_latent: torch.Tensor, gt_latent: torch.Tensor, mask: torch.Tensor,
                     loss_weight: float = 1.0, loss_type: str = "L1") -> torch.Tensor:
    """pred/gt latents [B, 4, h, w]; mask [B, H, W, 1] at image resolution."""
    diff = _distance(pred_latent, gt_latent, loss_type)
    m = F.interpolate(mask.permute(0, 3, 1, 2).float(), size=tuple(diff.shape[2:]),
                      mode="nearest-exact")  # jax.image.resize 'nearest' samples pixel centres
    return (diff * m).sum() / diff.numel() * loss_weight


def denoise_consistency_loss(pred_latent: torch.Tensor, gt_latent: torch.Tensor, pixel_weight,
                             loss_type: str = "L1", loss_weight: float = 1.0) -> torch.Tensor:
    """mean(d) * scalar pixel weight * weight (reference ``criterion.py:223-235``)."""
    return _distance(pred_latent, gt_latent, loss_type).mean() * pixel_weight * loss_weight


def label_smooth_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, lb_smooth: float = 0.1,
                               pixel_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Label-smoothing CE (reference ``criterion.py:8-54``, a variant no
    config uses): one-hot targets smoothed to (1 - s) + s / C and s / C,
    mean over the valid pixels."""
    logits = resize_logits(logits.float(), labels.shape[1:3])
    num_classes = logits.shape[1]
    valid = labels != IGNORE_LABEL
    safe = torch.where(valid, labels.long(), torch.zeros_like(labels.long()))
    logp = F.log_softmax(logits, dim=1)
    pos, neg = 1.0 - lb_smooth, lb_smooth / num_classes
    target = F.one_hot(safe, num_classes).permute(0, 3, 1, 2).float() * (pos - neg) + neg
    loss = torch.where(valid, -(target * logp).sum(dim=1), torch.zeros_like(logp[:, 0]))
    if pixel_weight is not None:
        loss = loss * pixel_weight
    return loss.sum() / valid.sum().clamp_min(1)


def feature_distance_loss(feats, ori_feats, loss_weight: float = 1.0) -> torch.Tensor:
    """Mean over the taps of each tap's MSE (reference ``criterion.py:144-152``)."""
    losses = [torch.mean((a.float() - b.float()) ** 2) for a, b in zip(feats, ori_feats)]
    return sum(losses) / len(losses) * loss_weight
