"""Weight files -> this port's state dict (port of
``madm_tpu/checkpoint/converter.py``: the HF SD-v1.4 snapshot loader, the
released MADM ``.pth`` converter and ``merge_into_variables``).

Two families of files (SURVEY.md §7):

(a) an HF SD-v1.4 snapshot: diffusers ``AutoencoderKL`` / ``UNet2DConditionModel``
    state dicts (``.safetensors`` or ``.bin``) and the CLIP text encoder
    (``ldm_diffusers.py:246-266``);
(b) a released MADM ``.pth``: the trained subset and the EMA teacher; the
    frozen VAE is not in it and comes from the snapshot (the ignored-keys
    contract of ``odise_checkpointer.py:45-102``);

and the CLIP image tower of ``clip_state`` from an HF
``CLIPVisionModel(WithProjection)`` state dict (``convert_clip_vision_state``,
``load_clip_vision``).

The port keeps diffusers' and the reference's key names, so where the JAX
converter transposes layouts and renames leaves, this one rewrites key
prefixes:

    backbone.feature_extractor.ldm_extractor.unet.<k>   -> unet.<k>
        (peft: ``.base_layer.`` dropped; ``<site>.lora_A|lora_B.<adapter>.weight``
        -> ``lora.<adapter>.<site>.lora_A|lora_B``)
    backbone.feature_projections.<k>                    -> feature_projections.<k>
    backbone.ema_feature_projections.<k>                -> ema.feature_projections.<k>
    sem_seg_head.<k>, ema_sem_seg_head.<k>              -> sem_seg_head.<k>, ema.sem_seg_head.<k>
        (``embed_layers.<feature index>`` -> ``embed_layers.<position in in_index>``)
    backbone.feature_extractor.clip_project_rgb.<k>     -> prompt.clip_project_rgb.<k>
    backbone.feature_extractor.clip_project_others.<k>  -> prompt.clip_project_others.<k>
    backbone.feature_extractor.ema_clip_project_others.<k> -> ema.clip_project_others.<k>

No ``safetensors`` package is needed: ``.safetensors`` files are parsed
(and written) by hand; ``.bin`` / ``.pth`` go through ``torch.load``.  The
writers (``save_safetensors``, ``save_sd_snapshot``, ``reference_state_dict``)
make such files from a port model, for export and for the checks that load
them back.
"""

from __future__ import annotations

import json
import logging
import os
import re
import struct
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.clip_image import CLIPVisionTransformer, VisionConfig

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------- file I/O

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_SAFETENSORS_NAMES = {v: k for k, v in _SAFETENSORS_DTYPES.items()}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file (8-byte little-endian header length, JSON
    header, data) as CPU tensors in the file's dtypes, BF16 included."""
    out = {}
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        base = 8 + hlen
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            dtype = _SAFETENSORS_DTYPES[meta["dtype"]]
            start, stop = meta["data_offsets"]
            buf = bytearray(stop - start)
            f.seek(base + start)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: tensor {name} runs past the end of the file")
            t = torch.frombuffer(buf, dtype=dtype) if buf else torch.empty(0, dtype=dtype)
            out[name] = t.reshape(meta["shape"])
    return out


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                     dtype: torch.dtype | None = None) -> None:
    """Write ``tensors`` as a ``.safetensors`` file, floating ones cast to
    ``dtype`` when given (the header padded to 8 bytes, the data in key
    order)."""
    items, offset, header = [], 0, {}
    for name in sorted(tensors):
        t = tensors[name].detach().cpu()
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        t = t.contiguous()
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _SAFETENSORS_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        items.append(t)
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in items:
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from ``.safetensors``, ``.bin`` or ``.pth``: a
    ``state_dict`` or ``model`` entry is unwrapped, entries that are not
    arrays are dropped, and floating tensors of any dtype come back fp32 (the
    JAX loader's ``.float()``).  ``.bin`` / ``.pth`` are unpickled with
    ``weights_only=True`` (tensors and plain containers; the JAX package
    unpickles anything): a file that holds other objects raises."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    return _state_dict_of(torch.load(path, map_location="cpu", weights_only=True))


def _state_dict_of(obj) -> Dict[str, torch.Tensor]:
    """The tensors of a loaded checkpoint object (see ``load_torch_file``)."""
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    out = {}
    for k, v in obj.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if isinstance(v, torch.Tensor):
            out[k] = v.float() if v.is_floating_point() else v
    return out


# --------------------------------------------------------------- snapshot

def _diffusers_rename(key: str) -> str:
    """Legacy diffusers VAE attention names -> the modern ones the port uses."""
    key = key.replace(".query.", ".to_q.").replace(".key.", ".to_k.")
    return key.replace(".value.", ".to_v.").replace(".proj_attn.", ".to_out.0.")


def load_sd_snapshot(snapshot_dir: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """An HF SD-v1.4 snapshot directory -> ``{'vae': ..., 'unet': ...}``
    state dicts in the port's ``MADM.vae`` / ``MADM.unet`` names, plus
    ``'clip_text'`` (HF ``CLIPTextModel`` names) when ``text_encoder/``
    holds weights: it is needed only to recompute ``uncond_inputs``.  Each
    part is read from ``diffusion_pytorch_model.safetensors`` (or ``.bin``;
    the text encoder's ``model.safetensors`` or ``pytorch_model.bin``)."""
    def find(sub, names):
        d = os.path.join(os.path.expanduser(snapshot_dir), sub)
        for name in names:
            p = os.path.join(d, name)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no weights under {d} (looked for {', '.join(names)})")

    diff_names = ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin")
    vae = {_diffusers_rename(k): v for k, v in load_torch_file(find("vae", diff_names)).items()
           if k.startswith(("encoder.", "decoder.", "quant_conv.", "post_quant_conv."))}
    unet = {_diffusers_rename(k): v for k, v in load_torch_file(find("unet", diff_names)).items()}
    out = {"vae": vae, "unet": unet}
    try:
        text = find("text_encoder", ("model.safetensors", "pytorch_model.bin"))
    except FileNotFoundError:
        return out  # optional: only needed to recompute uncond_inputs
    out["clip_text"] = load_torch_file(text)
    return out


def snapshot_state_dict(snapshot: Mapping[str, Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The VAE and UNet of ``load_sd_snapshot``'s result under ``MADM``'s
    keys (``vae.*``, ``unet.*``), for ``merge_into_model``."""
    return {f"{part}.{k}": v for part in ("vae", "unet") for k, v in snapshot[part].items()}


# ------------------------------------------------------------ CLIP vision

def convert_clip_vision_state(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An HF ``CLIPVisionModel(WithProjection)`` state dict -> the port's
    ``CLIPVisionTransformer`` names (JAX ``convert_clip_vision_state``):
    ``vision_model.`` dropped, HF's ``pre_layrnorm`` kept (``pre_layernorm``
    read as it), ``visual_projection.weight`` kept, ``position_ids`` and
    anything outside the tower left out."""
    out = {}
    for key, w in sd.items():
        key = key.removeprefix("vision_model.")
        if key.startswith("pre_layernorm."):
            key = "pre_layrnorm." + key[len("pre_layernorm."):]
        if key.startswith(("embeddings.class_embedding", "embeddings.patch_embedding.",
                           "embeddings.position_embedding.", "pre_layrnorm.", "encoder.layers.",
                           "post_layernorm.", "visual_projection.")):
            out[key] = torch.as_tensor(w)
    return out


def load_clip_vision(sd: Mapping[str, torch.Tensor], device: str | torch.device = "cuda",
                     heads: Optional[int] = None) -> CLIPVisionTransformer:
    """An fp32 ``CLIPVisionTransformer`` on ``device`` holding ``sd`` (HF
    names), its shape read from the tensors' but for ``heads``, which they
    do not hold (default width / 64, as every released CLIP tower)."""
    state = convert_clip_vision_state(sd)
    width, _, patch, _ = state["embeddings.patch_embedding.weight"].shape
    grid = int(round((state["embeddings.position_embedding.weight"].shape[0] - 1) ** 0.5))
    layers = 1 + max(int(m.group(1)) for k in state if (m := re.match(r"encoder\.layers\.(\d+)\.", k)))
    cfg = VisionConfig(image_size=grid * patch, patch_size=patch, width=width, layers=layers,
                       heads=heads or width // 64, mlp_dim=state["encoder.layers.0.mlp.fc1.weight"].shape[0],
                       out_dim=state["visual_projection.weight"].shape[0])
    with torch.device(resolve_device(device)):
        model = CLIPVisionTransformer(cfg)
    model.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
    return model


# ------------------------------------------------------------- MADM .pth

UNET = "backbone.feature_extractor.ldm_extractor.unet."
EMA_UNET = "backbone.feature_extractor.ldm_extractor.ema_unet."
_PREFIXES = (  # (released prefix, port prefix), checked in order
    ("backbone.feature_projections.", "feature_projections."),
    ("backbone.ema_feature_projections.", "ema.feature_projections."),
    ("backbone.feature_extractor.clip_project_rgb.", "prompt.clip_project_rgb."),
    ("backbone.feature_extractor.clip_project_others.", "prompt.clip_project_others."),
    ("backbone.feature_extractor.ema_clip_project_others.", "ema.clip_project_others."),
)
_HEADS = (("sem_seg_head.", "sem_seg_head."), ("ema_sem_seg_head.", "ema.sem_seg_head."),
          ("sem_seg_head_sec_modal.", "sem_seg_head_sec_modal."))
_PEFT = re.compile(r"(.*)\.lora_(A|B)\.([^.]+)\.weight")


def _head_key(rel: str, in_index: Sequence[int]) -> str:
    """A reference DAFormerHead key (relative) -> the port's.  ``embed_layers``
    are keyed by backbone feature index in the file, by position in the port
    (JAX ``convert_daformer_head``).  ``num_batches_tracked`` is kept: it
    loads into the port's BatchNorm2d buffer, which nothing reads (BN
    momentum is fixed at 0.9); the JAX converter drops it."""
    m = re.fullmatch(r"embed_layers\.(\d+)\.(.+)", rel)
    if m:
        i = int(m.group(1))
        if i not in in_index:
            raise KeyError(f"head key {rel}: feature index {i} is not in in_index {tuple(in_index)}")
        return f"embed_layers.{list(in_index).index(i)}.{m.group(2)}"
    if rel.split(".", 1)[0] in ("fuse_layer", "conv_seg", "vae_decoder_feat_proj"):
        return rel
    raise KeyError(f"unhandled head key {rel}")


def convert_madm_pth(path_or_sd, in_index: Sequence[int] = (0, 1, 2, 3)) -> Dict[str, torch.Tensor]:
    """A released MADM checkpoint (a path, or its loaded state dict) -> the
    port's state-dict keys, for ``merge_into_model``: the UNet (peft wrappers
    stripped) and its adapters, the prompts, projections and head with its BN
    statistics, and the teacher's copies (``ema.*``; a file of an
    ``--ema_w_unet`` run also holds the teacher's UNet and adapters under
    ``ldm_extractor.ema_unet``, which go to ``ema.unet`` and ``ema.lora``,
    JAX ``converter.py:476-480``).  Keys outside these parts (the frozen SD
    weights the reference leaves out, buffers such as ``pixel_mean``) are
    not MADM's trained weights and are skipped, as the JAX converter skips
    them."""
    sd = _state_dict_of(path_or_sd) if isinstance(path_or_sd, dict) else load_torch_file(path_or_sd)
    out: Dict[str, torch.Tensor] = {}
    skipped = 0
    for key, w in sd.items():
        new = None
        for src, dst in ((UNET, ""), (EMA_UNET, "ema.")):
            if key.startswith(src):
                rel = key[len(src):]
                m = _PEFT.fullmatch(rel)
                if m:  # peft: <site>.lora_A.<adapter>.weight -> lora.<adapter>.<site>.lora_A
                    new = f"{dst}lora.{m.group(3)}.{_diffusers_rename(m.group(1))}.lora_{m.group(2)}"
                else:
                    new = f"{dst}unet." + _diffusers_rename(rel.replace(".base_layer.", "."))
        for src, dst in _HEADS:
            if key.startswith(src):
                new = dst + _head_key(key[len(src):], in_index)
        for src, dst in _PREFIXES:
            if key.startswith(src):
                new = dst + key[len(src):]
        if new is None:
            skipped += 1
            continue
        if new in out:
            raise ValueError(f"two keys of the file convert to {new}")
        out[new] = w
    if skipped:
        logger.info(f"convert_madm_pth: skipped {skipped} keys outside MADM's trained parts")
    return out


def expand_conv_in(weight: torch.Tensor, input_channel_plus: int = 0,
                   concat_pixel_shuffle: bool = False) -> torch.Tensor:
    """Widen a 4-channel SD conv_in weight [out, 4, kh, kw] for the conv_in
    surgery (JAX ``expand_conv_in``, reference ``ldm_diffusers.py:60-99``):
    ``input_channel_plus=N`` scales it by ``4./4 + N`` (the reference's
    literal expression: 1 + N) and appends copies of its last N input
    channels; else ``concat_pixel_shuffle`` takes 17 copies of it / 17 (68
    inputs).  With both, the first rule alone applies, as in JAX."""
    if weight.shape[1] != 4:
        raise ValueError(f"conv_in weight {tuple(weight.shape)} does not have 4 input channels")
    if input_channel_plus:
        w = weight * (4.0 / 4 + input_channel_plus)
        return torch.cat([w, w[:, -input_channel_plus:]], dim=1)
    if concat_pixel_shuffle:
        return torch.cat([weight / 17.0] * 17, dim=1)
    return weight


def merge_into_model(model: nn.Module, state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Overlay a partial state dict onto ``model`` in place (JAX
    ``merge_into_variables``; ``odise_checkpointer.py:45-102``): each tensor
    is copied into the model's tensor of that key, cast to its dtype, after a
    shape check; keys the state lacks keep their values.  The teacher's keys
    (``ema.*``) are dropped for a model without a teacher (an eval
    ``MADM``).  A key the model lacks raises, where JAX's overlay would add
    it to the tree."""
    own = model.state_dict()
    has_ema = any(k.startswith("ema.") for k in own)
    todo = {k: v for k, v in state.items() if has_ema or not k.startswith("ema.")}
    if len(todo) < len(state):
        logger.info(f"merge_into_model: dropped {len(state) - len(todo)} teacher (ema.*) keys: "
                    "the model has no EMA teacher")
    missing = sorted(k for k in todo if k not in own)
    if missing:
        raise KeyError(f"{len(missing)} keys of the checkpoint are not in the model, e.g. {missing[:5]}")
    for k, v in todo.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: model {tuple(own[k].shape)}, file {tuple(v.shape)}")
    with torch.no_grad():
        for k, v in todo.items():
            own[k].copy_(torch.as_tensor(v))
    return model


# ----------------------------------------------------------------- writers

def save_sd_snapshot(snapshot_dir: str, model: nn.Module,
                     clip_text: Mapping[str, torch.Tensor] | None = None,
                     unet_dtype: torch.dtype | None = None,
                     text_dtype: torch.dtype | None = None) -> None:
    """Write ``model``'s VAE and UNet as an HF snapshot that
    ``load_sd_snapshot`` reads: ``unet/diffusion_pytorch_model.safetensors``
    (floats cast to ``unet_dtype`` when given), ``vae/diffusion_pytorch_model.bin``
    (``torch.save``, fp32) and, given an HF ``CLIPTextModel`` state dict,
    ``text_encoder/model.safetensors`` (``text_dtype``)."""
    state = model.state_dict()
    for sub in ("unet", "vae") + (("text_encoder",) if clip_text is not None else ()):
        os.makedirs(os.path.join(snapshot_dir, sub), exist_ok=True)
    save_safetensors(os.path.join(snapshot_dir, "unet", "diffusion_pytorch_model.safetensors"),
                     {k[5:]: v for k, v in state.items() if k.startswith("unet.")}, unet_dtype)
    torch.save({k[4:]: v.detach().float().cpu() for k, v in state.items() if k.startswith("vae.")},
               os.path.join(snapshot_dir, "vae", "diffusion_pytorch_model.bin"))
    if clip_text is not None:
        save_safetensors(os.path.join(snapshot_dir, "text_encoder", "model.safetensors"),
                         clip_text, text_dtype)


def reference_state_dict(model: nn.Module, in_index: Sequence[int] = (0, 1, 2, 3)
                         ) -> Dict[str, torch.Tensor]:
    """``model``'s trained state in a released checkpoint's layout, fp32 on
    the CPU: the inverse of ``convert_madm_pth``.  With adapters, every
    adapted linear is peft-wrapped (``<site>.base_layer.weight``) and each
    adapter is ``<site>.lora_A|lora_B.<name>.weight``; the teacher's UNet
    and adapters (``ema_w_unet``) likewise under ``ldm_extractor.ema_unet``.
    The frozen VAE and the constants are left out, as the reference's
    checkpointer leaves them."""
    adapters = getattr(model, "lora", {})
    sites = {path for a in adapters.values() for path, _ in a.sites()}
    inverse = [(dst, src) for src, dst in _PREFIXES]
    out: Dict[str, torch.Tensor] = {}
    for key, v in model.state_dict().items():
        v = v.detach().to("cpu", torch.float32 if v.is_floating_point() else v.dtype, copy=True)
        ema, unet_key = key.startswith("ema."), key.removeprefix("ema.")
        prefix = EMA_UNET if ema else UNET
        if unet_key.startswith("unet."):
            rel = unet_key[len("unet."):]
            site, _, leaf = rel.rpartition(".")
            out[prefix + (f"{site}.base_layer.{leaf}" if site in sites else rel)] = v
        elif unet_key.startswith("lora."):
            _, name, rest = unet_key.split(".", 2)
            site, _, leaf = rest.rpartition(".")
            out[f"{prefix}{site}.{leaf}.{name}.weight"] = v
        elif key.startswith(("sem_seg_head.", "ema.sem_seg_head.", "sem_seg_head_sec_modal.")):
            src, rel = key.removeprefix("ema.").split(".", 1)
            src = ("ema_" if key.startswith("ema.") else "") + src + "."
            m = re.fullmatch(r"embed_layers\.(\d+)\.(.+)", rel)
            if m:
                rel = f"embed_layers.{in_index[int(m.group(1))]}.{m.group(2)}"
            out[src + rel] = v
        else:
            for dst, src in inverse:
                if key.startswith(dst):
                    out[src + key[len(dst):]] = v
                    break
    return out
