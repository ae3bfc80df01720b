"""Learned prompt / time conditioning (port of ``madm_tpu/models/prompt.py``)
and the prompt ablations.  Parameter names are those of the MADM
checkpoints' ``clip_project_rgb`` / ``clip_project_others``.

The variants of ``init_clip_feature_project``: ``multi_layer_prompt`` gives
the prompt and its blend weights a leading 16, one row a UNet
cross-attention layer; ``without_prompt`` holds no parameter (the prompt is
the empty-prompt embedding and there is no residual time embedding);
``without_prompt_alpha`` keeps the prompt without its blend weights;
``input_prefix`` (``clip_state`` other than 'no') lifts a CLIP image
embedding into the prompt and the time embedding through
``PositionalLinear`` (``prompt_embed_project``, ``time_embed_project``) in
place of the learned constants (reference ``ldm_base.py:619-629,
844-853``).

The ablations (reference ``ldm_base.py:893-938``) take their random values
as tensors, drawn by the ``draw_*`` functions from an explicit generator,
so that a test can hand in the JAX package's."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

PROMPT_SEQ_LEN = 77
PROMPT_DIM = 768
TIME_EMBED_DIM = 1280


NUM_UNET_LAYERS = 16  # the UNet's cross-attention layers (multi_layer_prompt)


class PositionalLinear(nn.Module):
    """[B, in] -> [B, seq_len, out] fp32: a linear lift of a CLIP image
    embedding plus a learned positional table (reference
    ``ldm_base.py:619-629``), in fp32 whatever the parameters' dtype (JAX
    promotes the bf16 prefix against its fp32 parameters)."""

    def __init__(self, in_features: int, out_features: int, seq_len: int = PROMPT_SEQ_LEN):
        super().__init__()
        self.linear = nn.Linear(in_features, out_features)
        self.positional_embedding = nn.Parameter(torch.zeros(1, seq_len, out_features))

    def forward(self, prefix: torch.Tensor) -> torch.Tensor:
        lin = self.linear
        x = F.linear(prefix.float(), lin.weight.float(), lin.bias.float())
        return x[:, None, :] + self.positional_embedding.float()


class ClipFeatureProject(nn.Module):
    """One domain's learned prompt [1, seq_len, 768] ([16, 1, seq_len, 768]
    under ``multi_layer``), its blend weights, and the residual time
    embedding [1, 1, time_embed_dim] with its weight (``seq_len``:
    ``--prompt_seq_len``, 77 by default).  ``learnable=False``
    (``without_prompt``) holds none of them, ``alpha=False``
    (``without_prompt_alpha``) no prompt blend weights; an absent
    parameter is ``None``.  ``in_features`` (the CLIP prefix's width) puts
    ``prompt_embed_project`` and ``time_embed_project`` in place of
    ``prompt_embed`` and ``time_embed``; the time lift gives
    ``time_seq_len`` rows (the LDM captioner's ``num_timesteps``)."""

    def __init__(self, time_embed_dim: int = TIME_EMBED_DIM, seq_len: int = PROMPT_SEQ_LEN,
                 multi_layer: bool = False, learnable: bool = True, alpha: bool = True,
                 in_features: Optional[int] = None, time_seq_len: int = 1):
        super().__init__()
        if in_features is not None and multi_layer and learnable:
            raise ValueError("multi_layer_prompt is incompatible with clip_state prefixes "
                             "(ldm_base.py:644-657)")
        shape = ((NUM_UNET_LAYERS,) if multi_layer else ()) + (1, seq_len, PROMPT_DIM)
        prefixed = learnable and in_features is not None

        def param(*shape, on=True):
            return nn.Parameter(torch.zeros(shape)) if on else None

        self.prompt_embed = param(*shape, on=learnable and not prefixed)
        self.alpha_cond_prompt = param(*shape, on=learnable and alpha)
        self.alpha_uncond_prompt = param(*shape, on=learnable and alpha)
        self.time_embed = param(1, 1, time_embed_dim, on=learnable and not prefixed)
        self.alpha_cond_time = param(time_embed_dim, on=learnable)
        self.prompt_embed_project = (PositionalLinear(in_features, PROMPT_DIM, seq_len)
                                     if prefixed else None)
        self.time_embed_project = (PositionalLinear(in_features, time_embed_dim, time_seq_len)
                                   if prefixed else None)


def resize_prompt(prompt: torch.Tensor, seq_len: int, antialias: bool = False) -> torch.Tensor:
    """[1, S, D] -> [1, seq_len, D], bilinear along the sequence
    (``jax.image.resize(..., 'bilinear')``; its default ``antialias=True``
    matters only when shrinking)."""
    if prompt.shape[-2] == seq_len:
        return prompt
    x = F.interpolate(prompt[:, None].float(), size=(seq_len, prompt.shape[-1]), mode="bilinear",
                      align_corners=False, antialias=antialias)
    return x[:, 0].to(prompt.dtype)


def cond_prompt(p: ClipFeatureProject, uncond_prompt: torch.Tensor,
                prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tanh(alpha_uncond) * uncond + tanh(alpha_cond) * prompt_embed, the
    77-token uncond embedding resized to the prompt's length where they
    differ (reference ``get_cond_prompt``, ``ldm_base.py:678-680``); the
    prompt alone without blend weights, the uncond embedding without a
    prompt.  [1, S, 768], or [16, 1, S, 768] per layer.  With a CLIP
    ``prefix`` [B, D] the prompt is ``prompt_embed_project(prefix)`` [B, S,
    768], blended with the uncond embedding as it is (JAX resizes it only
    on the constant prompt's path)."""
    if p.prompt_embed_project is not None:
        if prefix is None:
            raise ValueError("a clip_state prompt needs the CLIP image prefix")
        lifted = p.prompt_embed_project(prefix)
        if p.alpha_cond_prompt is None:
            return lifted
        return torch.tanh(p.alpha_uncond_prompt) * uncond_prompt + torch.tanh(p.alpha_cond_prompt) * lifted
    if p.prompt_embed is None:
        return uncond_prompt
    if p.alpha_cond_prompt is None:
        return p.prompt_embed
    uncond_prompt = resize_prompt(uncond_prompt, p.prompt_embed.shape[-2])
    return (torch.tanh(p.alpha_uncond_prompt) * uncond_prompt
            + torch.tanh(p.alpha_cond_prompt) * p.prompt_embed)


def cond_time(p: ClipFeatureProject, prefix: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """[1, 1, time_embed_dim] residual time embedding (None without one); [B,
    1, time_embed_dim] from a CLIP ``prefix``, which it reads detached (JAX
    ``cond_time``, reference ``ldm_base.py:703-712``)."""
    if p.time_embed_project is not None:
        if prefix is None:
            raise ValueError("a clip_state time embedding needs the CLIP image prefix")
        return torch.tanh(p.alpha_cond_time) * p.time_embed_project(prefix.detach())
    if p.time_embed is None:
        return None
    return torch.tanh(p.alpha_cond_time) * p.time_embed


def select_domain_params(prompt: nn.ModuleDict, input_modal: str,
                         same_cond_params: bool) -> ClipFeatureProject:
    """rgb vs others parameter set; one shared set when ``same_cond_params``."""
    if same_cond_params:
        return prompt["clip_project_rgb"]
    return prompt["clip_project_rgb" if input_modal == "rgb" else "clip_project_others"]


def conditioning_of(p: ClipFeatureProject, uncond_prompt: torch.Tensor, batch_size: int,
                    ablation=None, prefix: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(prompt [B, S, 768] or per layer [16, B, S, 768], residual time
    embedding [B, 1, D] or None) of one parameter set (a domain's, or the EMA
    teacher's) for a batch; ``ablation`` maps the unbatched prompt ([1, S,
    768] or [16, 1, S, 768]; [B, S, 768] with a CLIP ``prefix`` [B, D])
    first (a prompt ablation with its draw)."""
    cp = cond_prompt(p, uncond_prompt, prefix)
    if ablation is not None:
        cp = ablation(cp)
    ct = cond_time(p, prefix)
    cp = cp.expand(*cp.shape[:-3], batch_size, *cp.shape[-2:])
    return cp, None if ct is None else ct.expand(batch_size, *ct.shape[1:])


# ------------------------------------------------------------ ablations
def draw_prompt_ablation(generator: torch.Generator, mode: str, seq_len: int,
                         lead: Tuple[int, ...] = (), batch: int = 1) -> torch.Tensor:
    """The random values of one prompt ablation: U[0, 1) scores [1, S, 1]
    for 'masked_prompt', N(0, 1) [1, S, 768] for 'prompt_perturbation',
    U[0, 1) [1, S, 768] for 'rand_prompt' (JAX's shapes); ``lead`` (16,) for
    per-layer prompts; ``batch`` B for a CLIP-prefix prompt, which is one
    an image ([B, S, 1], [B, S, 768])."""
    dev = generator.device
    if mode == "masked_prompt":
        return torch.rand(*lead, batch, seq_len, 1, generator=generator, device=dev)
    if mode == "prompt_perturbation":
        return torch.randn(*lead, batch, seq_len, PROMPT_DIM, generator=generator, device=dev)
    if mode == "rand_prompt":
        return torch.rand(*lead, batch, seq_len, PROMPT_DIM, generator=generator, device=dev)
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
