"""FDA amplitude removal and edge-texture extraction, the dataset ablations
``remove_amp`` and ``remove_texture`` (the port's copy of
``madm_tpu/ops/fda.py``; reference ``data/dataset/cross_modality_dataset.py``).

- ``remove_array_amp`` (:13-84,112-126): flatten (or blend toward its mean)
  the low-frequency FFT amplitude of an image, keeping its phase;
- ``extract_edge_info`` (:320-350): the ``Diff`` difference filter, kernel
  [[3, -1], [-1, -1]] on a reflect-padded image;
- ``extract_edge_info_local``: that filter per local region, each clamped and
  normalised on its own.

Host-side numpy, run inside the data pipeline.
"""

from __future__ import annotations

import numpy as np


def remove_array_amp(img_chw: np.ndarray, L: float, fusion_val=None) -> np.ndarray:
    """Flatten the lowest-frequency amplitude band of an image.

    ``img_chw``: [C, H, W] float 0..255.  ``L``: relative size of the
    centred low-frequency window whose amplitude is replaced by its mean
    (or blended with it by ``fusion_val``)."""
    out = np.empty_like(img_chw)
    c, h, w = img_chw.shape
    b = max(1, int(np.floor(min(h, w) * L)))
    for ch in range(c):
        f = np.fft.fft2(img_chw[ch])
        amp, pha = np.abs(f), np.angle(f)
        amp_shift = np.fft.fftshift(amp)
        ch_, cw_ = h // 2, w // 2
        region = amp_shift[ch_ - b : ch_ + b, cw_ - b : cw_ + b]
        mean = region.mean()
        if fusion_val is None:
            amp_shift[ch_ - b : ch_ + b, cw_ - b : cw_ + b] = mean
        else:
            amp_shift[ch_ - b : ch_ + b, cw_ - b : cw_ + b] = (
                fusion_val * mean + (1 - fusion_val) * region
            )
        amp = np.fft.ifftshift(amp_shift)
        out[ch] = np.real(np.fft.ifft2(amp * np.exp(1j * pha)))
    return np.clip(out, 0, 255)


_DIFF_KERNEL = np.array([[3.0, -1.0], [-1.0, -1.0]], np.float32)


def extract_edge_info(img_hw: np.ndarray) -> np.ndarray:
    """Difference-kernel edge map of a [H, W] grayscale 0..1 image
    (reference ``Diff`` module, reflect-padded 2x2 conv)."""
    h, w = img_hw.shape
    padded = np.pad(img_hw, ((1, 1), (1, 1)), mode="reflect")
    out = np.zeros((h, w), np.float32)
    for dy in range(2):
        for dx in range(2):
            out += _DIFF_KERNEL[dy, dx] * padded[dy : dy + h, dx : dx + w]
    return out


EDGES_MIN_CLIP = 0.02
EDGES_MAX_CLIP = 0.95


def _edge_region(gray01: np.ndarray) -> np.ndarray:
    """One region's pipeline (reference ``extract_edge_info``, :320-335):
    difference filter, small magnitudes zeroed, clamp to the 0.95 quantile of
    the positive responses and normalise, rescale to 0..255."""
    e = extract_edge_info(gray01)
    e[np.abs(e) < EDGES_MIN_CLIP] = 0.0
    pos = e[e > 0]
    if pos.size:
        thr = np.max(e) if EDGES_MAX_CLIP == 1 else np.quantile(pos, EDGES_MAX_CLIP)
        e = np.clip(e, -thr, thr) / thr
    else:
        e[:] = 0.0
    return (e + 1.0) * 127.5


def extract_edge_info_local(img_chw: np.ndarray, regions: int = 10) -> np.ndarray:
    """Per-local-region edge texture (reference ``:337-350``): the channel
    mean, filtered and normalised region by region over a regions x regions
    grid; [3, H, W] in 0..255 (the map repeated over 3 channels)."""
    c, h, w = img_chw.shape
    gray = (img_chw / 255.0).mean(axis=0)
    out = np.empty_like(gray)
    hs = h / regions
    ws = w / regions
    for yi in range(regions):
        y0, y1 = round(yi * hs), round((yi + 1) * hs)
        for xi in range(regions):
            x0, x1 = round(xi * ws), round((xi + 1) * ws)
            out[y0:y1, x0:x1] = _edge_region(gray[y0:y1, x0:x1])
    return np.repeat(out[None], 3, axis=0)
