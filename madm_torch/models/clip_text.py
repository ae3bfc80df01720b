"""CLIP text encoder (SD-v1.4's conditioning model) and the empty-prompt
embedding ``uncond_inputs`` (port of ``madm_tpu/models/clip_text.py``).

The trained MADM configs need one constant from the text encoder: the
embedding of the empty prompt, [1, 77, 768], from CLIP's text transformer
with its causal mask and final LayerNorm (reference
``ldm_diffusers.py:219-243``).  ``compute_uncond_inputs`` recomputes it from
an SD snapshot's ``text_encoder/``.

Architecture (openai/clip-vit-large-patch14): vocab 49408, width 768, 12
layers, 12 heads, MLP 3072, quick_gelu, causal attention, pre-LN, LayerNorm
eps 1e-5.  Parameter names are HF ``CLIPTextModel``'s without the
``text_model.`` prefix.  The attention is a plain matmul and softmax, as it
is in the JAX package (outside any Pallas kernel): kernel K1 has no causal
mask.
"""

from __future__ import annotations

import re
from typing import Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

VOCAB_SIZE = 49408
MAX_LEN = 77
WIDTH = 768
LAYERS = 12
HEADS = 12
MLP_DIM = 3072
HEAD_DIM = 64  # every CLIP text model: heads = width / 64
BOS_ID = 49406
EOS_ID = 49407
LN_EPS = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        d = c // self.heads
        q = (self.q_proj(x) * d ** -0.5).view(b, s, self.heads, d)
        k = self.k_proj(x).view(b, s, self.heads, d)
        v = self.v_proj(x).view(b, s, self.heads, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + mask
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        return self.out_proj(torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, c))


class CLIPMLP(nn.Module):
    def __init__(self, width: int, mlp_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(width, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int, mlp_dim: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.self_attn = CLIPAttention(width, heads)
        self.layer_norm2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = CLIPMLP(width, mlp_dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, width: int, max_len: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.position_embedding = nn.Embedding(max_len, width)


class CLIPEncoder(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, mlp_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(width, heads, mlp_dim) for _ in range(layers))


class CLIPTextTransformer(nn.Module):
    """input_ids [B, S] -> last hidden state [B, S, width] after the final
    LayerNorm (``final_ln=False``: before it)."""

    def __init__(self, vocab_size: int = VOCAB_SIZE, width: int = WIDTH, layers: int = LAYERS,
                 heads: int = HEADS, mlp_dim: int = MLP_DIM, max_len: int = MAX_LEN):
        super().__init__()
        self.vocab_size, self.width, self.layers, self.heads = vocab_size, width, layers, heads
        self.mlp_dim, self.max_len = mlp_dim, max_len
        self.embeddings = CLIPEmbeddings(vocab_size, width, max_len)
        self.encoder = CLIPEncoder(width, layers, heads, mlp_dim)
        self.final_layer_norm = nn.LayerNorm(width, eps=LN_EPS)

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None, final_ln: bool = True) -> torch.Tensor:
        emb = self.embeddings
        x = emb.token_embedding(input_ids) if inputs_embeds is None else inputs_embeds
        s = x.shape[1]
        x = x + emb.position_embedding.weight[None, :s].to(x.dtype)
        mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
        for layer in self.encoder.layers:
            x = layer(x, mask)
        return self.final_layer_norm(x) if final_ln else x


def _text_state(sd: Mapping[str, torch.Tensor]) -> dict:
    """The transformer's tensors of an HF ``CLIPTextModel`` state dict
    (``text_model.`` prefix optional); ``position_ids`` and anything outside
    the transformer (a projection head, a NeTI mapper) are left out, as the
    JAX converter leaves them."""
    out = {}
    for key, w in sd.items():
        key = key.removeprefix("text_model.")
        if key.startswith(("embeddings.token_embedding.", "embeddings.position_embedding.",
                           "encoder.layers.", "final_layer_norm.")):
            out[key] = torch.as_tensor(w)
    return out


def load_clip_text(sd: Mapping[str, torch.Tensor], device: str | torch.device = "cuda"
                   ) -> CLIPTextTransformer:
    """An fp32 ``CLIPTextTransformer`` on ``device`` holding ``sd``, its
    fields read from the tensors' shapes (heads = width / 64)."""
    state = _text_state(sd)
    vocab, width = state["embeddings.token_embedding.weight"].shape
    max_len = state["embeddings.position_embedding.weight"].shape[0]
    layers = 1 + max(int(m.group(1)) for k in state
                     if (m := re.match(r"encoder\.layers\.(\d+)\.", k)))
    mlp_dim = state["encoder.layers.0.mlp.fc1.weight"].shape[0]
    with torch.device(resolve_device(device)):
        model = CLIPTextTransformer(vocab, width, layers, width // HEAD_DIM, mlp_dim, max_len)
    model.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
    return model.eval().requires_grad_(False)


def apply_final_layer_norm(params_or_module: Union[CLIPTextTransformer, Mapping[str, torch.Tensor]],
                           x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """The transformer's final LayerNorm on ``x`` [..., width], from the
    module or its state dict (the NeTI bypass LNs both its states, reference
    ``neti_clip_text_encoder.py:147-148``)."""
    if isinstance(params_or_module, CLIPTextTransformer):
        w, b = params_or_module.final_layer_norm.weight, params_or_module.final_layer_norm.bias
    else:
        state = _text_state(params_or_module)
        w, b = state["final_layer_norm.weight"], state["final_layer_norm.bias"]
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w.to(x) + b.to(x)


def empty_prompt_ids(length: int = MAX_LEN, device: str | torch.device = "cpu") -> torch.Tensor:
    """Token ids [1, length] of the empty prompt '' padded with EOS to the
    maximum length, as the reference's CLIPTokenizer gives them
    (``ldm_diffusers.py:220-222``)."""
    ids = torch.full((1, length), EOS_ID, dtype=torch.long, device=device)
    ids[0, 0] = BOS_ID
    return ids


@torch.no_grad()
def compute_uncond_inputs(params_or_module: Union[CLIPTextTransformer, Mapping[str, torch.Tensor]],
                          device: str | torch.device = "cuda") -> torch.Tensor:
    """The empty-prompt embedding [1, max_len, width] fp32 (77 x 768 for SD's
    encoder; ``ldm_diffusers.py:219-243``), from a module (on its device) or
    from an HF text-encoder state dict (on ``device``)."""
    if isinstance(params_or_module, CLIPTextTransformer):
        model = params_or_module
    else:
        model = load_clip_text(params_or_module, device)
    dev = model.final_layer_norm.weight.device
    if model.final_layer_norm.weight.dtype != torch.float32:
        raise ValueError("compute_uncond_inputs runs in fp32: pass an fp32 CLIPTextTransformer")
    return model(empty_prompt_ids(model.max_len, dev)).float()
