"""NeTI textual inversion (port of ``madm_tpu/models/neti.py``; reference
``modeling/neti/``).

``NeTICLIPText`` is a CLIP text encoder whose embedding of a placeholder
token comes from a **NeTI mapper**, an MLP over a Fourier encoding of
(timestep, UNet layer), and which adds the mapper's second half, the
*bypass* (normalised to the placeholder state's norm and scaled by 0.2),
to the encoder output at the placeholder before the final LayerNorm
(``neti_clip_text_encoder.py:133-148``, ``net_clip_text_embedding.py:39-73``,
``neti_mapper.py:22-99``, ``positional_encoding.py:7-42``).  The shipped
configs run the plain encoder; this is the checkpoint-compatible class.

The mapper keeps the reference's torch names, so a NeTI checkpoint loads
with ``convert_neti_mapper_state``: ``encoder.w`` (the fixed random
projection, read detached), ``input_layer`` (also ``net.0``, the same
module), ``net.1`` / ``net.4`` (Linear), ``net.2`` / ``net.5`` (LayerNorm),
``output_layer.0``.  Nested dropout takes its random values as arguments
(``draw_nested_dropout``, from an explicit generator), so a test can hand in
the JAX package's.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from .clip_text import WIDTH, CLIPTextTransformer, apply_final_layer_norm

UNET_LAYERS = 16  # ldm_diffusers.py:28-29 / neti_mapper.py:12-13
HIDDEN = 128  # neti_mapper.py:54-59
# the mapper's LayerNorms: flax's default eps, as in the JAX package (the
# reference's torch nn.LayerNorm takes 1e-5; ROADMAP §C)
LN_EPS = 1e-6


def fourier_encode(w: torch.Tensor, timestep: torch.Tensor, unet_layer: torch.Tensor) -> torch.Tensor:
    """Unit-normalised [sin(w x), cos(w x)] of x = (t, layer): [B, 2 num_w]
    (``positional_encoding.py:20-33``; ``w`` [num_w, 2] is read detached)."""
    x = torch.stack([timestep.float(), unet_layer.float()], dim=0)  # [2, B]
    wx = w.detach().float() @ x.to(w.device)
    v = torch.cat([torch.sin(wx), torch.cos(wx)], dim=0)
    return (v / v.norm(dim=0, keepdim=True)).T


def anchor_init_matrix(w: torch.Tensor, num_time_anchors: int, num_layers: int) -> torch.Tensor:
    """The input layer's initial weight [num_time_anchors * num_layers, 2
    num_w]: encode(t, l) for t in range(0, 1000, 1000 // num_time_anchors)
    and l in 0..num_layers-1 (``positional_encoding.py:35-42``)."""
    anchors = torch.arange(0, 1000, 1000 // num_time_anchors, dtype=torch.float32)
    layers = torch.arange(num_layers, dtype=torch.float32)
    return fourier_encode(w, anchors.repeat_interleave(num_layers), layers.repeat(len(anchors)))


class FourierEncoder(nn.Module):
    def __init__(self, num_w: int = 1024):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(num_w, 2), requires_grad=False)


def draw_nested_dropout(generator: torch.Generator, batch: int, dim: int = HIDDEN
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One nested-dropout draw: (u ~ U[0, 1), a truncation index a sample in
    [0, dim)); the mapper applies it when u < ``nested_dropout_prob``."""
    dev = generator.device
    return (torch.rand((), generator=generator, device=dev),
            torch.randint(0, dim, (batch,), generator=generator, device=dev))


class NeTIMapper(nn.Module):
    """(timestep [B], UNet layer [B]) -> token embedding [B, output_dim], with
    the bypass half after it ([B, 2 output_dim]) when ``output_bypass``."""

    def __init__(self, output_dim: int = WIDTH, use_nested_dropout: bool = True,
                 nested_dropout_prob: float = 0.5, norm_scale: Optional[float] = None,
                 num_pe_time_anchors: int = 10, num_unet_layers: int = UNET_LAYERS,
                 sigma_t: float = 0.03, sigma_l: float = 2.0, num_w: int = 1024,
                 output_bypass: bool = True):
        super().__init__()
        self.output_dim, self.output_bypass = output_dim, output_bypass
        self.use_nested_dropout, self.nested_dropout_prob = use_nested_dropout, nested_dropout_prob
        self.norm_scale, self.sigmas = norm_scale, (sigma_t, sigma_l)
        self.num_pe_time_anchors, self.num_unet_layers = num_pe_time_anchors, num_unet_layers
        self.encoder = FourierEncoder(num_w)
        self.input_layer = nn.Linear(2 * num_w, num_pe_time_anchors * num_unet_layers)
        self.net = nn.Sequential(self.input_layer,
                                 nn.Linear(num_pe_time_anchors * num_unet_layers, HIDDEN),
                                 nn.LayerNorm(HIDDEN, eps=LN_EPS), nn.LeakyReLU(),
                                 nn.Linear(HIDDEN, HIDDEN), nn.LayerNorm(HIDDEN, eps=LN_EPS),
                                 nn.LeakyReLU())
        self.output_layer = nn.Sequential(nn.Linear(HIDDEN, output_dim * (2 if output_bypass else 1)))

    def forward(self, timestep: torch.Tensor, unet_layer: torch.Tensor, train: bool = False,
                dropout: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                truncation_idx: Optional[int] = None) -> torch.Tensor:
        """``dropout``: a ``draw_nested_dropout`` draw, applied in training
        (with probability ``nested_dropout_prob`` every dim from a sample's
        index on is zeroed, ``neti_mapper.py:84-89``); ``truncation_idx``
        zeroes the dims from it on in eval (``:90-92``)."""
        h = self.net(fourier_encode(self.encoder.w, timestep, unet_layer))
        idx = torch.arange(h.shape[-1], device=h.device)
        if train and self.use_nested_dropout and dropout is not None:
            u, trunc = dropout
            drop = (u.to(h.device) < self.nested_dropout_prob) & (idx >= trunc.to(h.device)[:, None])
            h = h.masked_fill(drop, 0.0)
        elif not train and truncation_idx is not None:
            h = h.masked_fill(idx >= truncation_idx, 0.0)
        out = self.output_layer(h)
        if self.norm_scale is not None:  # neti_mapper.py:95-99
            out = out / out.norm(dim=-1, keepdim=True) * self.norm_scale
        return out


@torch.no_grad()
def init_neti_mapper_(mapper: NeTIMapper, generator: torch.Generator) -> NeTIMapper:
    """Seeded weights: ``encoder.w`` N(0, 1) with its columns scaled by
    sigma_t and sigma_l, the input layer at the anchor encodings with zero
    bias (``neti_mapper.py:61-67``), the other linears N(0, 1/fan_in) with
    zero bias, LayerNorms at identity.  ``generator`` lives on the mapper's
    device."""
    dev = mapper.encoder.w.device
    w = torch.randn(mapper.encoder.w.shape, generator=generator, device=dev)
    mapper.encoder.w.copy_(w * torch.tensor(mapper.sigmas, device=dev))
    for m in mapper.modules():
        if isinstance(m, nn.Linear):
            w = torch.randn(m.weight.shape, generator=generator, device=dev)
            m.weight.copy_(w * m.in_features ** -0.5)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    mapper.input_layer.weight.copy_(anchor_init_matrix(mapper.encoder.w, mapper.num_pe_time_anchors,
                                                       mapper.num_unet_layers))
    return mapper


class NeTICLIPText(nn.Module):
    """The CLIP text encoder with a NeTI-mapped placeholder token.
    ``encode`` is the plain path (``forward_wo_neti``,
    ``neti_clip_text_encoder.py:50-78``); ``encode_with_neti`` puts the
    mapper's word half at each sample's first ``placeholder_id`` and returns
    the final-LayerNormed states without and with the bypass
    (``neti_clip_text_encoder.py:94-148``)."""

    BYPASS_SCALE = 0.2  # neti_clip_text_encoder.py:143

    def __init__(self, transformer: Optional[CLIPTextTransformer] = None,
                 mapper: Optional[NeTIMapper] = None, output_bypass: bool = True):
        super().__init__()
        self.transformer = transformer if transformer is not None else CLIPTextTransformer()
        self.mapper = mapper if mapper is not None else NeTIMapper(output_bypass=output_bypass)

    def encode(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.transformer(input_ids)

    def encode_with_neti(self, input_ids: torch.Tensor, timestep: torch.Tensor,
                         unet_layer: torch.Tensor, placeholder_id: int, train: bool = False,
                         dropout: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         truncation_idx: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        embeds = self.transformer.embeddings.token_embedding(input_ids)
        mapped = self.mapper(timestep, unet_layer, train=train, dropout=dropout,
                             truncation_idx=truncation_idx)
        word, bypass = mapped.chunk(2, dim=-1) if self.mapper.output_bypass else (mapped, None)
        batch = torch.arange(input_ids.shape[0], device=input_ids.device)
        at = (input_ids == placeholder_id).int().argmax(dim=1)  # the first placeholder
        embeds = embeds.index_put((batch, at), word.to(embeds.dtype))
        hidden = self.transformer(inputs_embeds=embeds, final_ln=False)
        plain = apply_final_layer_norm(self.transformer, hidden)
        if bypass is None:
            return plain, plain
        existing = hidden[batch, at]  # [B, width], the pre-LN placeholder state
        bypass = bypass / bypass.norm(dim=1, keepdim=True) * existing.norm(dim=1, keepdim=True)
        hidden = hidden.index_put((batch, at), existing + self.BYPASS_SCALE * bypass.to(hidden.dtype))
        return plain, apply_final_layer_norm(self.transformer, hidden)


def convert_neti_mapper_state(sd: Mapping[str, torch.Tensor]) -> dict:
    """A reference ``NeTIMapper`` state dict -> ``NeTIMapper.load_state_dict``'s:
    the mapper's keys, with ``input_layer`` and its alias ``net.0`` each
    filled from whichever the file holds (JAX ``convert_neti_mapper_state``)."""
    keep = ("encoder.w", "input_layer.", "net.", "output_layer.")
    out = {k: torch.as_tensor(v) for k, v in sd.items() if k.startswith(keep)}
    for leaf in ("weight", "bias"):
        w = out.get(f"input_layer.{leaf}", out.get(f"net.0.{leaf}"))
        out[f"input_layer.{leaf}"] = out[f"net.0.{leaf}"] = w
    return out
