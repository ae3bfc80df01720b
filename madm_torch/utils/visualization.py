"""Visualization utilities (port of ``madm_tpu/utils/visualization.py``;
reference ``utils/visualization.py`` + ``cmdise.py:238-305`` training-vis grids).

Host-side only: palette colorization and a grid of images, colorized
predictions and labels, heatmaps and attention overlays, saved as the per-iteration PNG the
reference writes every ``vis_period``.  The grid is drawn with PIL (the
JAX package draws it with matplotlib, which the GPU machine lacks): one cell
per panel, its title above it, one row block per sample.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

CITYSCAPES_PALETTE = [
    128, 64, 128, 244, 35, 232, 70, 70, 70, 102, 102, 156, 190, 153, 153,
    153, 153, 153, 250, 170, 30, 220, 220, 0, 107, 142, 35, 152, 251, 152,
    70, 130, 180, 220, 20, 60, 255, 0, 0, 0, 0, 142, 0, 0, 70,
    0, 60, 100, 0, 80, 100, 0, 0, 230, 119, 11, 32,
]
_TITLE = 14  # pixels above each cell for its title


def colorize_mask(mask: np.ndarray, palette: Sequence[int]) -> np.ndarray:
    """[H, W] int ids -> [H, W, 3] uint8 palette colors (255 -> black)."""
    table = np.zeros((256, 3), np.uint8)
    flat = np.asarray(palette, np.uint8).reshape(-1, 3)
    table[: flat.shape[0]] = flat
    return table[np.clip(mask, 0, 255)]


def jet(x: np.ndarray) -> np.ndarray:
    """[H, W] values -> [H, W, 3] uint8 through the jet colormap over the
    values' range (the reference's cv2.COLORMAP_JET heatmaps)."""
    x = np.asarray(x, np.float32)
    span = float(x.max() - x.min())
    return (_jet01((x - x.min()) / (span if span > 0 else 1.0)) * 255).astype(np.uint8)


def _jet01(t: np.ndarray) -> np.ndarray:
    """[...] values in [0, 1] -> [..., 3] float jet colours in [0, 1]."""
    return np.clip(1.5 - np.abs(4.0 * t[..., None] - np.array([3.0, 2.0, 1.0], np.float32)), 0, 1)


def attention_overlay(attn: np.ndarray, image: np.ndarray) -> np.ndarray:
    """A jet heatmap of ``attn`` [h, w] (bilinearly resized, clipped to
    [0, 1]) added to ``image`` [H, W, 3] (min-max normalised) and scaled by
    the sum's maximum (JAX ``attention_overlay``; reference
    ``show_cam_on_image``).  Returns [H, W, 3] float in [0, 1]."""
    from PIL import Image

    h, w = image.shape[:2]
    a = np.asarray(Image.fromarray(np.asarray(attn, np.float32)).resize((w, h), Image.BILINEAR),
                   np.float32)
    img = np.asarray(image, np.float32)
    span = float(img.max() - img.min())
    img = (img - img.min()) / (span if span > 0 else 1.0)
    cam = _jet01(np.clip(a, 0.0, 1.0)) + img
    return cam / max(float(cam.max()), 1e-6)


def _panel(item: Dict, j: int, palette: Sequence[int]) -> np.ndarray:
    d = np.asarray(item["data"][j])
    kind = item["data_type"]
    if kind == "image":
        return (np.clip(d, 0, 1) * 255).astype(np.uint8)
    if kind == "logits":
        return colorize_mask(d.argmax(-1), palette)
    if kind == "label":
        return colorize_mask(d.astype(np.int32), palette)
    if kind == "heatmap":
        return jet(d)
    if kind == "attention_maps":
        return (attention_overlay(d, np.asarray(item["image"][j])) * 255).astype(np.uint8)
    raise ValueError(f"vis panel type {kind!r} is not one of image, logits, label, heatmap, "
                     "attention_maps")


def save_vis_grid(
    vis_data: List[Dict],
    save_path: str,
    iter_index: int,
    palette: Sequence[int],
    max_cols: int = 5,
    rank: int = 0,
) -> Optional[str]:
    """Save a prediction grid like the reference's ``vis_results``.

    vis_data entries: {'data_type': 'image'|'logits'|'label'|'heatmap'|
    'attention_maps', 'info': str, 'data': np [B,H,W,C] / [B,H,W]};
    'attention_maps' entries also carry 'image' [B,H,W,3] to overlay onto.  Returns the written path
    (``<save_path>/vis_results/<iter:06d>_rank<rank>.png``)."""
    from PIL import Image, ImageDraw

    batch = vis_data[0]["data"].shape[0]
    n = len(vis_data)
    cols = min(max_cols, n)
    rows_per_sample = -(-n // cols)
    h, w = np.asarray(vis_data[0]["data"][0]).shape[:2]
    ch = h + _TITLE
    grid = Image.new("RGB", (cols * w, batch * rows_per_sample * ch), "white")
    draw = ImageDraw.Draw(grid)
    for i, item in enumerate(vis_data):
        for j in range(batch):
            x, y = (i % cols) * w, (j * rows_per_sample + i // cols) * ch
            cell = Image.fromarray(_panel(item, j, palette))
            if cell.size != (w, h):
                cell = cell.resize((w, h), Image.NEAREST)
            grid.paste(cell, (x, y + _TITLE))
            draw.text((x + 2, y + 1), item["info"], fill="black")
    out_dir = os.path.join(save_path, "vis_results")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{iter_index:06d}_rank{rank}.png")
    grid.save(path)
    return path
