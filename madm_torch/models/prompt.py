"""Learned prompt / time conditioning (port of ``madm_tpu/models/prompt.py``,
the shipped case: no CLIP prefix, one prompt shared by every cross-attention
layer).  Parameter names are those of the MADM checkpoints'
``clip_project_rgb`` / ``clip_project_others``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

PROMPT_SEQ_LEN = 77
PROMPT_DIM = 768
TIME_EMBED_DIM = 1280


class ClipFeatureProject(nn.Module):
    """One domain's learned prompt [1, 77, 768], its blend weights, and the
    residual time embedding [1, 1, time_embed_dim] with its weight."""

    def __init__(self, time_embed_dim: int = TIME_EMBED_DIM):
        super().__init__()
        shape = (1, PROMPT_SEQ_LEN, PROMPT_DIM)
        self.prompt_embed = nn.Parameter(torch.zeros(shape))
        self.alpha_cond_prompt = nn.Parameter(torch.zeros(shape))
        self.alpha_uncond_prompt = nn.Parameter(torch.zeros(shape))
        self.time_embed = nn.Parameter(torch.zeros(1, 1, time_embed_dim))
        self.alpha_cond_time = nn.Parameter(torch.zeros(time_embed_dim))


def cond_prompt(p: ClipFeatureProject, uncond_prompt: torch.Tensor) -> torch.Tensor:
    """tanh(alpha_uncond) * uncond + tanh(alpha_cond) * prompt_embed."""
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
                    ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(prompt [B, 77, 768], residual time embedding [B, 1, D]) of one
    parameter set (a domain's, or the EMA teacher's) for a batch."""
    cp = cond_prompt(p, uncond_prompt)
    ct = cond_time(p)
    return (cp.expand(batch_size, *cp.shape[1:]),
            ct.expand(batch_size, *ct.shape[1:]))

