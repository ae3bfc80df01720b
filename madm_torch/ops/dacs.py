"""DACS class mix, strong augmentations and MIC block masking (port of
``madm_tpu/ops/dacs.py``).

Each random transform is two functions: ``draw_*`` takes its random values
from an explicit ``torch.Generator`` and returns them; the transform applies
given values.  A test can so hand the port the values the JAX package drew.
Images are NHWC in [0, 1] (the JAX layout); labels [B, H, W] with 255 ignored.

Reference semantics kept, as in the JAX package:
- the class set is drawn from the *batch-wide* present labels, and each
  sample takes ceil(n/2) of them;
- colour jitter (brightness, contrast, saturation, hue, in a random order,
  factors shared by the batch) applies when U > p, so p = 1 never applies it;
- gaussian blur applies when U > 0.5, sigma ~ U(0.15, 1.15), kornia's kernel
  size formula, zero padding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

IGNORE_LABEL = 255


# --------------------------------------------------------------- class mix
def draw_class_scores(generator: torch.Generator, batch: int, num_classes: int) -> torch.Tensor:
    """U[0, 1) scores [B, C] that order the present classes of each sample."""
    return torch.rand(batch, num_classes, generator=generator, device=generator.device)


def present_classes(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[C] bool: the classes present anywhere in the batch (the JAX
    package's batch-wide presence, a reference quirk)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.reshape(labels.shape[0], -1, 1) == classes).any(dim=1).any(dim=0)


def class_masks(labels: torch.Tensor, scores: torch.Tensor, num_classes: int,
                present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample masks [B, H, W] float: 1 where the pixel's class is among
    the ceil(n/2) present classes with the highest scores; 0 at ignored
    pixels.  ``present`` ([C] bool, by default ``present_classes(labels)``)
    is the batch's: a rank of a data-parallel step passes the global one."""
    b = labels.shape[0]
    if present is None:
        present = present_classes(labels, num_classes)  # [C]
    n_present = int(present.sum())
    n_take = (n_present + n_present % 2) // 2
    s = torch.where(present, scores.to(labels.device), torch.tensor(-math.inf, device=labels.device))
    ranks = torch.argsort(torch.argsort(-s, dim=1, stable=True), dim=1, stable=True)
    selected = ((ranks < n_take) & present).float()  # [B, C]
    safe = labels.clamp(0, num_classes - 1).reshape(b, -1).long()
    mask = torch.gather(selected, 1, safe).reshape(labels.shape)
    return torch.where(labels == IGNORE_LABEL, torch.zeros_like(mask), mask)


def one_mix(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask * a + (1 - mask) * b; pass mask [B, H, W, 1] for NHWC images."""
    return mask * a + (1.0 - mask) * b


# ------------------------------------------------------------ colour jitter
@dataclasses.dataclass(frozen=True)
class JitterDraw:
    apply: bool
    brightness: float
    contrast: float
    saturation: float
    hue: float
    order: Tuple[int, ...]  # permutation of (brightness, contrast, saturation, hue)


def draw_color_jitter(generator: torch.Generator, strength: float = 0.2,
                      probability: float = 0.2) -> JitterDraw:
    u = torch.rand(6, generator=generator, device=generator.device).tolist()
    order = torch.randperm(4, generator=generator, device=generator.device).tolist()
    s = strength
    return JitterDraw(apply=u[0] > probability, brightness=1 - s + 2 * s * u[1],
                      contrast=1 - s + 2 * s * u[2], saturation=1 - s + 2 * s * u[3],
                      hue=-s + 2 * s * u[4], order=tuple(order))


def _gray(x: torch.Tensor) -> torch.Tensor:
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb.unbind(-1)
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-8), torch.zeros_like(maxc))
    safe = delta.clamp_min(1e-8)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, torch.zeros_like(h), torch.remainder(h / 6.0, 1.0))
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.long(), 6)[..., None]
    choices = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = torch.zeros_like(hsv)
    for k, c in enumerate(choices):
        out = torch.where(i == k, torch.stack(c, dim=-1), out)
    return out


def color_jitter(images: torch.Tensor, draw: JitterDraw) -> torch.Tensor:
    """kornia-style ColorJitter with the drawn factors and order."""
    if not draw.apply:
        return images

    def brightness(x):
        return (x * draw.brightness).clamp(0.0, 1.0)

    def contrast(x):
        mean = _gray(x).mean(dim=(1, 2), keepdim=True)[..., None]
        return ((x - mean) * draw.contrast + mean).clamp(0.0, 1.0)

    def saturation(x):
        gray = _gray(x)[..., None]
        return (gray + (x - gray) * draw.saturation).clamp(0.0, 1.0)

    def hue(x):
        hsv = _rgb_to_hsv(x)
        hsv = torch.cat([torch.remainder(hsv[..., :1] + draw.hue, 1.0), hsv[..., 1:]], dim=-1)
        return _hsv_to_rgb(hsv).clamp(0.0, 1.0)

    ops = (brightness, contrast, saturation, hue)
    for k in draw.order:
        images = ops[k](images)
    return images


# ----------------------------------------------------------- gaussian blur
@dataclasses.dataclass(frozen=True)
class BlurDraw:
    apply: bool
    sigma: float


def kornia_kernel_size(n: int) -> int:
    """kornia/DACS kernel-size formula."""
    c = math.ceil(0.1 * n)
    return int(math.floor(c - 0.5 + c % 2))


def draw_gaussian_blur(generator: torch.Generator) -> BlurDraw:
    u = torch.rand(2, generator=generator, device=generator.device).tolist()
    return BlurDraw(apply=u[0] > 0.5, sigma=0.15 + u[1])


def gaussian_blur(images: torch.Tensor, draw: BlurDraw) -> torch.Tensor:
    """Separable gaussian blur of NHWC images (rows, then columns)."""
    if not draw.apply:
        return images
    _, h, w, c = images.shape

    def kernel_1d(size):
        xs = torch.arange(size, dtype=torch.float32, device=images.device) - (size - 1) / 2.0
        k = torch.exp(-0.5 * (xs / draw.sigma) ** 2)
        return (k / k.sum()).to(images.dtype)

    ky, kx = max(kornia_kernel_size(h), 3), max(kornia_kernel_size(w), 3)
    x = images.permute(0, 3, 1, 2)
    x = F.conv2d(x, kernel_1d(ky).view(1, 1, ky, 1).expand(c, 1, ky, 1), padding=(ky // 2, 0), groups=c)
    x = F.conv2d(x, kernel_1d(kx).view(1, 1, 1, kx).expand(c, 1, 1, kx), padding=(0, kx // 2), groups=c)
    return x.permute(0, 2, 3, 1)


def strong_transform(images: torch.Tensor, jitter: JitterDraw,
                     blur: Optional[BlurDraw]) -> torch.Tensor:
    """colour jitter, then gaussian blur when ``blur`` is drawn."""
    x = color_jitter(images, jitter)
    return x if blur is None else gaussian_blur(x, blur)


# ------------------------------------------------------------ block masking
def draw_block_mask(generator: torch.Generator, batch: int, h: int, w: int,
                    block_size: int = 32) -> torch.Tensor:
    """U[0, 1) scores [B, mh, mw, 1] of the MIC mask's blocks, mh =
    round(h / block_size) (Python's round: half to even, as in the JAX
    package)."""
    mh, mw = round(h / block_size), round(w / block_size)
    return torch.rand(batch, mh, mw, 1, generator=generator, device=generator.device)


def block_mask(scores: torch.Tensor, hw, mask_ratio: float = 0.7) -> torch.Tensor:
    """[B, H, W, 1] float mask, 1 = keep, where a block's score exceeds
    ``mask_ratio``; blocks are nearest-resized to (H, W) sampling at pixel
    centres (``jax.image.resize(..., 'nearest')`` is torch's 'nearest-exact')."""
    keep = (scores > mask_ratio).float().permute(0, 3, 1, 2)
    return F.interpolate(keep, size=tuple(hw), mode="nearest-exact").permute(0, 2, 3, 1)


def mask_image(images: torch.Tensor, scores: torch.Tensor, mask_ratio: float = 0.7,
               fill: float = 0.5) -> torch.Tensor:
    """MIC block masking of NHWC images in [0, 1]: masked pixels -> ``fill``."""
    m = block_mask(scores.to(images.device), images.shape[1:3], mask_ratio)
    return images * m + fill * (1.0 - m)
