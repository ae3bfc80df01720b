"""DDPM forward-noising with SD-v1.4's scaled-linear schedule and the fixed
seed-42 shared noise (port of ``madm_tpu/models/sd/scheduler.py``)."""

from __future__ import annotations

import numpy as np
import torch

NUM_TRAIN_TIMESTEPS = 1000
BETA_START = 0.00085
BETA_END = 0.012


def alphas_cumprod(num_timesteps: int = NUM_TRAIN_TIMESTEPS) -> np.ndarray:
    """scaled_linear schedule: betas linear in sqrt space (fp32 table)."""
    betas = np.linspace(BETA_START ** 0.5, BETA_END ** 0.5, num_timesteps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def add_noise(latents: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """sqrt(acp[t]) * latents + sqrt(1 - acp[t]) * noise; latents [B, C, H, W],
    timesteps [B] integer."""
    acp = torch.as_tensor(alphas_cumprod(), device=latents.device)[timesteps]
    sqrt_acp = acp.sqrt().to(latents.dtype)[:, None, None, None]
    sqrt_one_minus = (1.0 - acp).sqrt().to(latents.dtype)[:, None, None, None]
    return sqrt_acp * latents + sqrt_one_minus * noise


def shared_noise(height: int = 64, width: int = 64, channels: int = 4) -> np.ndarray:
    """The reference's fixed noise buffer ``torch.randn(1, 4, h, w)`` from a
    CPU generator seeded 42, returned NHWC float32."""
    gen = torch.Generator().manual_seed(42)
    n = torch.randn(1, channels, height, width, generator=gen, device="cpu").numpy()
    return np.ascontiguousarray(np.transpose(n, (0, 2, 3, 1))).astype(np.float32)
