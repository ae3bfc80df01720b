"""CLIP vision transformer and the ``ClipAdapter`` facade (port of
``madm_tpu/models/clip_image.py``; reference ``modeling/meta_arch/clip.py``).

The tower gives the image embedding behind the CLIP image prefix
(``clip_state`` 'no_learnable_clip' / 'learnable_clip': the prefix lifts the
learned prompt and time embedding through ``prompt.PositionalLinear``,
reference ``ldm_base.py:844-853``) and the unused MaskCLIP classifier.

Architecture (ViT-L/14-336, ``VisionConfig()``): patch 14, width 1024, 24
layers, 16 heads, MLP 4096, quick_gelu, pre-LN, a class token, the final
LayerNorm on the class token, then a projection to 768.  The encoder layers
are ``clip_text.CLIPEncoderLayer``; parameter names are HF
``CLIPVisionModelWithProjection``'s without the ``vision_model.`` prefix
(``embeddings.class_embedding``, ``embeddings.patch_embedding``,
``embeddings.position_embedding``, HF's ``pre_layrnorm``, ``encoder.layers``,
``post_layernorm``, ``visual_projection``), so
``checkpoint.converter.clip_vision_state`` reads such a file with renames
only.  Its attention is a plain matmul and softmax, as in the JAX package:
no Pallas kernel stands behind it, so none does here.

Images are NHWC, as everywhere in the port's public surface.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .clip_text import LN_EPS, CLIPEncoder, CLIPTextTransformer

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """The tower's shape; the default is ViT-L/14-336 (JAX
    ``CLIPVisionTransformer``'s fields)."""

    image_size: int = 336
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_dim: int = 4096
    out_dim: int = 768

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.patch_embedding = nn.Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.grid ** 2 + 1, cfg.width)


class CLIPVisionTransformer(nn.Module):
    """CLIP-normalised images [B, H, W, 3] -> image embedding [B, out_dim]
    (the projected class token); see ``forward`` for the spatial and the
    MaskCLIP outputs."""

    def __init__(self, cfg: VisionConfig = VisionConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.width, eps=LN_EPS)
        self.encoder = CLIPEncoder(cfg.width, cfg.layers, cfg.heads, cfg.mlp_dim)
        self.post_layernorm = nn.LayerNorm(cfg.width, eps=LN_EPS)
        self.visual_projection = nn.Linear(cfg.width, cfg.out_dim, bias=False)

    def forward(self, images: torch.Tensor, normalize: bool = False, return_spatial: bool = False,
                num_mask_tokens: int = 0, attn_mask: Optional[torch.Tensor] = None):
        """``return_spatial``: (embedding, per-patch encodings [B, g, g,
        out_dim]) (reference ``clip.py:181-226``).  ``num_mask_tokens`` Q
        with ``attn_mask`` [B, 1, N, N] (additive): the MaskCLIP forward, Q
        copies of the position-embedded, pre-LN'd class token in front,
        returning the projected mask tokens [B, Q, out_dim] (reference
        ``clip.py:263-292``).  ``normalize``: unit-length embeddings."""
        emb = self.embeddings
        x = emb.patch_embedding(images.permute(0, 3, 1, 2).to(emb.patch_embedding.weight.dtype))
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # [B, g*g, width], row-major over the grid
        cls = emb.class_embedding.to(x.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + emb.position_embedding.weight[None, :x.shape[1]].to(x.dtype)
        x = self.pre_layrnorm(x)
        if num_mask_tokens:
            x = torch.cat([x[:, :1].expand(b, num_mask_tokens, -1), x], dim=1)
        n = x.shape[1]
        mask = attn_mask if attn_mask is not None else torch.zeros(n, n, device=x.device)
        for layer in self.encoder.layers:
            x = layer(x, mask)
        if num_mask_tokens:
            return self.visual_projection(self.post_layernorm(x[:, :num_mask_tokens]))
        if return_spatial:
            tokens = self.visual_projection(self.post_layernorm(x))
            out, g = tokens[:, 0], self.cfg.grid
            enc = tokens[:, 1:].reshape(b, g, g, self.cfg.out_dim)
            return (out / out.norm(dim=-1, keepdim=True) if normalize else out), enc
        out = self.visual_projection(self.post_layernorm(x[:, 0]))
        return out / out.norm(dim=-1, keepdim=True) if normalize else out


def resize_nhwc(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, (B, *size, C), 'bilinear')`` on NHWC ``x``: half-
    pixel centres, and a triangle filter widened by the shrink factor where
    it shrinks (JAX's default ``antialias=True``), in fp32."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[1:3]) == size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=size, mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def preprocess(images: torch.Tensor, image_size: int) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> resized to the tower's resolution and
    channel-normalised as open_clip's preprocessing (fp32)."""
    x = resize_nhwc(images.float(), (image_size, image_size))
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
    return (x - mean) / std


class ClipAdapter(nn.Module):
    """``embed_image`` / ``embed_image_spatial`` / ``embed_text`` over a
    vision tower and, optionally, a text transformer (reference
    ``clip.py:96-242``).  Images arrive in [0, 1] NHWC at any size."""

    def __init__(self, vision: Optional[CLIPVisionTransformer] = None,
                 text: Optional[CLIPTextTransformer] = None, normalize: bool = False):
        super().__init__()
        self.vision = vision if vision is not None else CLIPVisionTransformer()
        self.text = text
        self.normalize = normalize

    @property
    def dim_latent(self) -> int:
        return self.vision.cfg.out_dim

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        return preprocess(images, self.vision.cfg.image_size)

    def embed_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.vision(self.preprocess(images), normalize=self.normalize)

    def embed_image_spatial(self, images: torch.Tensor):
        """(image embedding [B, D], encodings [B, H/16, W/16, D]): the
        per-patch tokens on their grid, bilinearly resized to stride 16 of
        the original image (reference ``clip.py:181-242``)."""
        b, h, w, _ = images.shape
        emb, enc = self.vision(self.preprocess(images), normalize=self.normalize, return_spatial=True)
        return emb, resize_nhwc(enc, (h // 16, w // 16))

    def embed_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Last hidden state of the text transformer (the caller projects)."""
        if self.text is None:
            raise ValueError("this ClipAdapter holds no text transformer")
        return self.text(input_ids)


def ensemble_logits_with_labels(logits: torch.Tensor, labels, method: str = "max") -> torch.Tensor:
    """Per-synonym logits -> per-class (reference ``helper.py:49-80``):
    ``labels`` is a list of synonym lists whose lengths partition the last
    dim; the max (or the mean) over each class's synonyms."""
    lens = [len(names) for names in labels]
    if logits.shape[-1] != sum(lens):
        raise ValueError(f"logits' last dim {logits.shape[-1]} is not the {sum(lens)} synonyms")
    segs = torch.split(logits, lens, dim=-1)
    return torch.stack([s.amax(-1) if method == "max" else s.mean(-1) for s in segs], dim=-1)


class MaskCLIP(ClipAdapter):
    """Masked-attention CLIP classification (reference ``clip.py:250-372``,
    MaskCLIP arXiv 2208.08984; unused by the shipped configs): per mask
    query, a copy of the class token attends only to the image patches the
    sigmoided mask covers; the projected mask tokens are scored against text
    embeddings at CLIP's logit scale."""

    def __init__(self, vision: Optional[CLIPVisionTransformer] = None,
                 text: Optional[CLIPTextTransformer] = None):
        super().__init__(vision, text, normalize=False)

    def encode_image_with_mask(self, images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] in [0, 1], masks [B, Q, H', W'] (logits) ->
        mask embeddings [B, Q, D]."""
        images = self.preprocess(images)
        b, s = images.shape[:2]
        q, p = masks.shape[1], self.vision.cfg.patch_size
        m = resize_nhwc(masks.float().permute(0, 2, 3, 1), (s, s)).permute(0, 3, 1, 2)
        m = torch.sigmoid(m)
        g = s // p
        patch = m.reshape(b, q, g, p, g, p).amax(dim=(3, 5))
        hidden = (patch < 0.5).reshape(b, q, g * g)  # visible iff a covered pixel >= 0.5
        n_all = q + g * g + 1
        neg = -1e9
        attn = torch.zeros(b, n_all, n_all, device=images.device)
        attn[:, :, :q] = neg  # nothing attends to the mask tokens
        attn[:, :q, q + 1:] = torch.where(hidden, neg, 0.0)  # each its visible patches (+ cls)
        return self.vision(images, num_mask_tokens=q, attn_mask=attn[:, None])

    def pred_logits(self, mask_embed: torch.Tensor, text_embed: torch.Tensor, labels,
                    logit_scale: float = 100.0) -> torch.Tensor:
        """Cosine-similarity logits against per-class text embeddings,
        synonym-ensembled (reference ``clip.py:345-357``)."""
        me = mask_embed / mask_embed.norm(dim=-1, keepdim=True)
        te = text_embed / text_embed.norm(dim=-1, keepdim=True)
        return ensemble_logits_with_labels(torch.einsum("bqc,nc->bqn", me, te) * logit_scale, labels)

    def forward(self, images: torch.Tensor, masks: torch.Tensor,
                text_embed: Optional[torch.Tensor] = None, labels=None):
        out = {"mask_embed": self.encode_image_with_mask(images, masks)}
        if text_embed is not None and labels is not None:
            out["mask_pred_open_logits"] = self.pred_logits(out["mask_embed"], text_embed, labels)
        return out
