"""UDA losses (port of ``madm_tpu/train/criterion.py``), on NCHW model outputs.

- Cross-entropy is a plain mean over *all* pixels: ignored pixels add 0 to
  the sum and still count in the denominator.
- The palette-regression loss (L1, the only type the shipped configs use)
  is sum(|pred - gt| * mask) / numel * weight, with the mask
  nearest-resized to the latent grid.
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


def vae_decoder_loss(pred_latent: torch.Tensor, gt_latent: torch.Tensor, mask: torch.Tensor,
                     loss_weight: float = 1.0) -> torch.Tensor:
    """pred/gt latents [B, 4, h, w]; mask [B, H, W, 1] at image resolution."""
    diff = (pred_latent - gt_latent).abs().float()
    m = F.interpolate(mask.permute(0, 3, 1, 2).float(), size=tuple(diff.shape[2:]),
                      mode="nearest-exact")  # jax.image.resize 'nearest' samples pixel centres
    return (diff * m).sum() / diff.numel() * loss_weight
