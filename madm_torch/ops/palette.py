"""Label <-> palette colours and palette-distance pseudo-labels (port of
``madm_tpu/ops/palette.py``).  Labels [B, H, W] with 255 ignored; colours
NHWC."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

IGNORE_LABEL = 255

# The 11-class palette of the Cityscapes-RGB -> DELIVER-Depth evaluator
# (sky, building, fence, person, pole, road, sidewalk, vegetation, car,
# wall, traffic sign): the shipped config's ``train_palette``
DELIVER_11_PALETTE = (
    70, 130, 180, 70, 70, 70, 190, 153, 153, 220, 20, 60, 153, 153, 153,
    128, 64, 128, 244, 35, 232, 107, 142, 35, 0, 0, 142, 102, 102, 156,
    250, 170, 30,
)


# The fixed high-contrast palette of ``reg_target_palette='discrete'``
# (reference ``mtmadise.py:86-91``): the decoder-regression targets only;
# reg_uncertain's distance table stays the train palette (``mtmadise.py:92-94``)
DISCRETE_PALETTE = (
    255, 0, 255, 0, 255, 0, 127, 255, 127, 255, 127, 127, 0, 255, 255,
    255, 255, 0, 0, 0, 255, 255, 0, 0, 127, 0, 127, 255, 255, 255, 0, 0, 0,
)


def reg_target_table(train_palette: Sequence[int], reg_target_palette=None) -> np.ndarray:
    """[256, 3] colour table of the decoder-regression targets: the train
    palette's, or for 'discrete' the fixed ``DISCRETE_PALETTE``'s (the only
    other value the reference accepts, ``mtmadise.py:83-86``)."""
    if reg_target_palette is None:
        return palette_table(train_palette)
    if reg_target_palette != "discrete":
        raise ValueError(f"reg_target_palette must be None or 'discrete', got {reg_target_palette!r}")
    return palette_table(DISCRETE_PALETTE)


def palette_table(palette: Sequence[int], num_entries: int = 256) -> np.ndarray:
    """Flat [r0, g0, b0, r1, ...] -> [256, 3] float table in [0, 1]; entries
    past the palette (255 among them) are black, as PIL pads a 'P' palette."""
    table = np.zeros((num_entries, 3), np.float32)
    flat = np.asarray(palette, np.float32).reshape(-1, 3) / 255.0
    table[: flat.shape[0]] = flat
    return table


def label_to_rgb(labels: torch.Tensor, table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W] labels -> (NHWC colours in [-1, 1], valid mask [B, H, W, 1])."""
    valid = (labels != IGNORE_LABEL).float()[..., None]
    rgb01 = table.to(labels.device)[labels.long()]
    return (rgb01 - 0.5) / 0.5, valid


def palette_distance_pseudo_label(decoded01: torch.Tensor, class_table: torch.Tensor,
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distance-to-palette pseudo-label of NHWC colours in [0, 1]:
    prob = softmax(1 / (||pixel - palette_c|| + 1e-3)) over the classes.
    Returns (max prob [B, H, W], label [B, H, W] int32, softmax [B, H, W, C])."""
    d = torch.linalg.vector_norm(decoded01[..., None, :] - class_table.to(decoded01.device), dim=-1)
    sm = torch.softmax(1.0 / (d + 1e-3), dim=-1)
    p, lbl = sm.max(dim=-1)
    return p, lbl.int(), sm
