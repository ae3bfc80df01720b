"""Learned prompt / time conditioning (port of ``madm_tpu/models/prompt.py``:
no CLIP prefix, one prompt shared by every cross-attention layer) and the
prompt ablations.  Parameter names are those of the MADM checkpoints'
``clip_project_rgb`` / ``clip_project_others``.

The ablations (reference ``ldm_base.py:893-938``) take their random values
as tensors, drawn by the ``draw_*`` functions from an explicit generator,
so that a test can hand in the JAX package's."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

PROMPT_SEQ_LEN = 77
PROMPT_DIM = 768
TIME_EMBED_DIM = 1280


class ClipFeatureProject(nn.Module):
    """One domain's learned prompt [1, seq_len, 768], its blend weights, and
    the residual time embedding [1, 1, time_embed_dim] with its weight
    (``seq_len``: ``--prompt_seq_len``, 77 by default)."""

    def __init__(self, time_embed_dim: int = TIME_EMBED_DIM, seq_len: int = PROMPT_SEQ_LEN):
        super().__init__()
        shape = (1, seq_len, PROMPT_DIM)
        self.prompt_embed = nn.Parameter(torch.zeros(shape))
        self.alpha_cond_prompt = nn.Parameter(torch.zeros(shape))
        self.alpha_uncond_prompt = nn.Parameter(torch.zeros(shape))
        self.time_embed = nn.Parameter(torch.zeros(1, 1, time_embed_dim))
        self.alpha_cond_time = nn.Parameter(torch.zeros(time_embed_dim))


def resize_prompt(prompt: torch.Tensor, seq_len: int, antialias: bool = False) -> torch.Tensor:
    """[1, S, D] -> [1, seq_len, D], bilinear along the sequence
    (``jax.image.resize(..., 'bilinear')``; its default ``antialias=True``
    matters only when shrinking)."""
    if prompt.shape[-2] == seq_len:
        return prompt
    x = F.interpolate(prompt[:, None].float(), size=(seq_len, prompt.shape[-1]), mode="bilinear",
                      align_corners=False, antialias=antialias)
    return x[:, 0].to(prompt.dtype)


def cond_prompt(p: ClipFeatureProject, uncond_prompt: torch.Tensor) -> torch.Tensor:
    """tanh(alpha_uncond) * uncond + tanh(alpha_cond) * prompt_embed, the
    77-token uncond embedding resized to the prompt's length where they
    differ (reference ``get_cond_prompt``, ``ldm_base.py:678-680``)."""
    uncond_prompt = resize_prompt(uncond_prompt, p.prompt_embed.shape[-2])
    return (torch.tanh(p.alpha_uncond_prompt) * uncond_prompt
            + torch.tanh(p.alpha_cond_prompt) * p.prompt_embed)


def cond_time(p: ClipFeatureProject) -> torch.Tensor:
    """[1, 1, time_embed_dim] residual time embedding."""
    return torch.tanh(p.alpha_cond_time) * p.time_embed


def select_domain_params(prompt: nn.ModuleDict, input_modal: str,
                         same_cond_params: bool) -> ClipFeatureProject:
    """rgb vs others parameter set; one shared set when ``same_cond_params``."""
    if same_cond_params:
        return prompt["clip_project_rgb"]
    return prompt["clip_project_rgb" if input_modal == "rgb" else "clip_project_others"]


def conditioning_of(p: ClipFeatureProject, uncond_prompt: torch.Tensor, batch_size: int,
                    ablation=None) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(prompt [B, S, 768], residual time embedding [B, 1, D]) of one
    parameter set (a domain's, or the EMA teacher's) for a batch;
    ``ablation`` maps the unbatched prompt [1, S, 768] first (a prompt
    ablation with its draw)."""
    cp = cond_prompt(p, uncond_prompt)
    if ablation is not None:
        cp = ablation(cp)
    ct = cond_time(p)
    return (cp.expand(batch_size, *cp.shape[1:]),
            ct.expand(batch_size, *ct.shape[1:]))


# ------------------------------------------------------------ ablations
def draw_prompt_ablation(generator: torch.Generator, mode: str, seq_len: int) -> torch.Tensor:
    """The random values of one prompt ablation: U[0, 1) scores [1, S, 1]
    for 'masked_prompt', N(0, 1) [1, S, 768] for 'prompt_perturbation',
    U[0, 1) [1, S, 768] for 'rand_prompt' (JAX's shapes)."""
    dev = generator.device
    if mode == "masked_prompt":
        return torch.rand(1, seq_len, 1, generator=generator, device=dev)
    if mode == "prompt_perturbation":
        return torch.randn(1, seq_len, PROMPT_DIM, generator=generator, device=dev)
    if mode == "rand_prompt":
        return torch.rand(1, seq_len, PROMPT_DIM, generator=generator, device=dev)
    raise ValueError(f"prompt ablation {mode!r}")


def mask_prompt(prompt: torch.Tensor, scores: torch.Tensor, mask_ratio: float) -> torch.Tensor:
    """Token-row dropout: rows whose score is not above ``mask_ratio`` are
    zeroed (reference ``ldm_base.py:926-938``)."""
    return prompt * (scores > mask_ratio).to(prompt.dtype)


def perturb_prompt(prompt: torch.Tensor, noise: torch.Tensor, scale: float) -> torch.Tensor:
    """Additive gaussian perturbation (reference ``ldm_base.py:898-901``)."""
    return prompt + noise.to(prompt.dtype) * scale


def rand_prompt(prompt: torch.Tensor, uniform: torch.Tensor, scale: float) -> torch.Tensor:
    """Uniform random prompt in place of the learned one (reference
    ``ldm_base.py:902-903``)."""
    return (uniform * scale).to(prompt.dtype)
