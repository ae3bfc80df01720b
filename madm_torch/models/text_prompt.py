"""Engineered-text-prompt conditioning (port of
``madm_tpu/models/text_prompt.py``; reference ``ldm_text_prompt.py``).

The legacy alternative to the learned prompt: per-domain prompts ("a photo
of {classes}") embedded once through the CLIP text encoder, then refined by
a small residual ``TextAdapter`` (reference ``ldm.py:762-782``: ``text +
gamma * MLP(text)``, gamma 1e-4 at init), one adapter a domain.  The shipped
MADM configs do not use it.  Parameter names are the JAX tree's (``fc1``,
``fc2``, ``gamma``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .clip_text import WIDTH, CLIPTextTransformer

DEFAULT_SOURCE_TEXT = "a high-resolution photo of {}"
DEFAULT_TARGET_TEXT = "a depth map of {}"
DEFAULT_MIXUP_TEXT = "a mixed photo and depth map of {}"


def format_prompt(template: str, class_names: Sequence[str]) -> str:
    """The class names joined by ', ' with a final ', and ', lower-cased, in
    ``template`` (``ldm_text_prompt.py:31-40``)."""
    if not class_names:
        return template.format("")
    parts = list(class_names)
    joined = ", ".join(parts[:-1])
    joined = f"{joined}, and {parts[-1]}" if len(parts) > 1 else parts[-1]
    return template.format(joined.lower())


class TextAdapter(nn.Module):
    """texts [B, S, D] -> texts + gamma * fc2(gelu(fc1(texts))) (JAX
    ``text_adapter``)."""

    def __init__(self, text_dim: int = WIDTH, hidden_dim: Optional[int] = None,
                 gamma_init_value: float = 1e-4):
        super().__init__()
        hidden = hidden_dim or text_dim
        self.fc1 = nn.Linear(text_dim, hidden)
        self.fc2 = nn.Linear(hidden, text_dim)
        self.gamma = nn.Parameter(torch.full((text_dim,), gamma_init_value))

    def forward(self, texts: torch.Tensor) -> torch.Tensor:
        return texts + self.gamma * self.fc2(F.gelu(self.fc1(texts)))


def init_text_adapter(generator: torch.Generator, text_dim: int = WIDTH,
                      hidden_dim: Optional[int] = None, gamma_init_value: float = 1e-4) -> TextAdapter:
    """A ``TextAdapter`` at JAX ``init_text_adapter``'s distribution: weights
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), zero biases, gamma at
    ``gamma_init_value``; drawn from ``generator`` (on its device)."""
    with torch.device(generator.device):
        adapter = TextAdapter(text_dim, hidden_dim, gamma_init_value)
    with torch.no_grad():
        for fc in (adapter.fc1, adapter.fc2):
            bound = fc.in_features ** -0.5
            fc.weight.copy_(torch.rand(fc.weight.shape, generator=generator, device=generator.device)
                            * (2 * bound) - bound)
            fc.bias.zero_()
    return adapter


@torch.no_grad()
def embed_prompts(text_model: CLIPTextTransformer, token_ids: torch.Tensor) -> torch.Tensor:
    """Tokenised prompts [N, 77] -> their last hidden states [N, 77, 768]
    through the CLIP text encoder (on its device)."""
    return text_model(token_ids.to(text_model.final_layer_norm.weight.device))
