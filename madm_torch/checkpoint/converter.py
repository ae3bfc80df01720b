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

the CLIP image tower of ``clip_state`` from an HF
``CLIPVisionModel(WithProjection)`` state dict (``convert_clip_vision_state``,
``load_clip_vision``), and (c) a raw CompVis ``sd-v1-*.ckpt`` for the LDM
extractors (``load_compvis_checkpoint``, ``LdmCheckpointer``; the
reference's ``odise_checkpointer.py:114-124``).

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
from ..models.clip_text import _text_state

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


# --------------------------------------------------- CompVis .ckpt support
# A raw SD checkpoint stores a 'state_dict' with model.diffusion_model /
# first_stage_model / cond_stage_model.transformer prefixes; its keys are
# renamed to the diffusers layout the port's modules keep (JAX
# ``_compvis_unet_key`` / ``_compvis_vae_key``).

def _compvis_unet_key(key: str) -> Optional[str]:
    """'model.diffusion_model.X' (prefix stripped) -> the UNet's key, None
    for the parts the port does not hold (``label_emb``)."""
    if key.startswith("time_embed."):
        return key.replace("time_embed.0.", "time_embedding.linear_1.").replace(
            "time_embed.2.", "time_embedding.linear_2.")
    for src, dst in (("input_blocks.0.0.", "conv_in."), ("out.0.", "conv_norm_out."),
                     ("out.2.", "conv_out.")):
        if key.startswith(src):
            return key.replace(src, dst)

    def resnet(rest: str) -> str:
        for src, dst in (("in_layers.0.", "norm1."), ("in_layers.2.", "conv1."),
                         ("emb_layers.1.", "time_emb_proj."), ("out_layers.0.", "norm2."),
                         ("out_layers.3.", "conv2."), ("skip_connection.", "conv_shortcut.")):
            rest = rest.replace(src, dst)
        return rest

    if key.startswith("input_blocks."):
        _, n, m, rest = key.split(".", 3)
        i, j = (int(n) - 1) // 3, (int(n) - 1) % 3
        if j == 2:  # the downsample block's 'op' conv
            return f"down_blocks.{i}.downsamplers.0.conv.{rest.removeprefix('op.')}"
        if m == "0":
            return f"down_blocks.{i}.resnets.{j}.{resnet(rest)}"
        return f"down_blocks.{i}.attentions.{j}.{rest}"
    if key.startswith("middle_block."):
        _, m, rest = key.split(".", 2)
        if m == "1":
            return f"mid_block.attentions.0.{rest}"
        return f"mid_block.resnets.{0 if m == '0' else 1}.{resnet(rest)}"
    if key.startswith("output_blocks."):
        _, n, m, rest = key.split(".", 3)
        i, j = int(n) // 3, int(n) % 3
        if m == "0":
            return f"up_blocks.{i}.resnets.{j}.{resnet(rest)}"
        # slot 1 is the attention but in up block 0 (no attention), where it
        # is the upsampler; slot 2 is always the upsampler
        if rest.startswith("conv.") and (m == "2" or i == 0):
            return f"up_blocks.{i}.upsamplers.0.{rest}"
        return f"up_blocks.{i}.attentions.{j}.{rest}"
    return None


def _compvis_vae_key(key: str) -> Optional[str]:
    """'first_stage_model.X' (prefix stripped) -> the ``AutoencoderKL``
    key, None for the parts it does not hold (a training loss)."""
    def resnet(rest: str) -> str:
        return rest.replace("nin_shortcut.", "conv_shortcut.")

    def attn(rest: str) -> str:
        for src, dst in (("norm.", "group_norm."), ("q.", "to_q."), ("k.", "to_k."),
                         ("v.", "to_v."), ("proj_out.", "to_out.0.")):
            rest = rest.replace(src, dst)
        return rest

    if key.startswith(("quant_conv.", "post_quant_conv.")):
        return key
    side, _, rest = key.partition(".")
    if side not in ("encoder", "decoder"):
        return None
    p = side + "."
    if rest.startswith(("conv_in.", "conv_out.")):
        return key
    if rest.startswith("norm_out."):
        return p + "conv_norm_out." + rest[len("norm_out."):]
    if rest.startswith("mid."):
        sub = rest[len("mid."):]
        if sub.startswith("block_1."):
            return p + "mid_block.resnets.0." + resnet(sub[len("block_1."):])
        if sub.startswith("block_2."):
            return p + "mid_block.resnets.1." + resnet(sub[len("block_2."):])
        if sub.startswith("attn_1."):
            return p + "mid_block.attentions.0." + attn(sub[len("attn_1."):])
    if side == "encoder" and rest.startswith("down."):
        _, lvl, kind, remainder = rest.split(".", 3)
        if kind == "block":
            j, r2 = remainder.split(".", 1)
            return f"encoder.down_blocks.{lvl}.resnets.{j}.{resnet(r2)}"
        if kind == "downsample":
            return f"encoder.down_blocks.{lvl}.downsamplers.0.{remainder}"
    if side == "decoder" and rest.startswith("up."):
        _, lvl, kind, remainder = rest.split(".", 3)
        i = 3 - int(lvl)  # CompVis level 0 is the highest resolution, up_blocks run lowest first
        if kind == "block":
            j, r2 = remainder.split(".", 1)
            return f"decoder.up_blocks.{i}.resnets.{j}.{resnet(r2)}"
        if kind == "upsample":
            return f"decoder.up_blocks.{i}.upsamplers.0.{remainder}"
    return None


def convert_compvis_state(sd: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """A CompVis SD state dict -> ``{'unet', 'vae', 'clip_text'}`` state
    dicts in the port's names (``UNet2DCondition``, ``AutoencoderKL`` with
    the VAE attention's 1x1 convs as linears, ``CLIPTextTransformer``),
    each present when the file has it; ``snapshot_state_dict`` prefixes the
    first two for a model."""
    out: Dict[str, Dict[str, torch.Tensor]] = {"unet": {}, "vae": {}, "clip_text": {}}
    for key, w in sd.items():
        w = torch.as_tensor(w)
        if key.startswith("model.diffusion_model."):
            new = _compvis_unet_key(key[len("model.diffusion_model."):])
            if new is not None:
                out["unet"][new] = w
        elif key.startswith("first_stage_model."):
            new = _compvis_vae_key(key[len("first_stage_model."):])
            if new is not None:
                if ".attentions.0.to_" in new and w.ndim == 4:
                    w = w.reshape(w.shape[0], w.shape[1])  # 1x1 conv -> linear
                out["vae"][new] = w
        elif key.startswith("cond_stage_model.transformer."):
            out["clip_text"][key[len("cond_stage_model.transformer."):]] = w
    out["clip_text"] = _text_state(out["clip_text"])
    return {k: v for k, v in out.items() if v}


def load_compvis_checkpoint(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """A raw CompVis ``sd-v1-*.ckpt`` (``{'state_dict': ...}``) converted by
    ``convert_compvis_state``, floats in fp32.  The file is unpickled with
    ``weights_only=True``: a Lightning checkpoint that pickles objects other
    than tensors and plain containers raises (the JAX package unpickles
    anything)."""
    return convert_compvis_state(load_torch_file(path))


def _to_compvis_unet(key: str) -> str:
    """The inverse of ``_compvis_unet_key``."""
    def resnet(rest: str) -> str:
        for src, dst in (("norm1.", "in_layers.0."), ("conv1.", "in_layers.2."),
                         ("time_emb_proj.", "emb_layers.1."), ("norm2.", "out_layers.0."),
                         ("conv2.", "out_layers.3."), ("conv_shortcut.", "skip_connection.")):
            if rest.startswith(src):
                return dst + rest[len(src):]
        return rest

    for src, dst in (("time_embedding.linear_1.", "time_embed.0."), ("time_embedding.linear_2.", "time_embed.2."),
                     ("conv_in.", "input_blocks.0.0."), ("conv_norm_out.", "out.0."), ("conv_out.", "out.2.")):
        if key.startswith(src):
            return dst + key[len(src):]
    m = re.fullmatch(r"(down_blocks|up_blocks)\.(\d+)\.(resnets|attentions|downsamplers|upsamplers)\.(\d+)\.(.+)", key)
    if m:
        blocks, i, kind, j, rest = m.group(1), int(m.group(2)), m.group(3), int(m.group(4)), m.group(5)
        if blocks == "down_blocks":
            if kind == "downsamplers":
                return f"input_blocks.{3 * i + 3}.0.op.{rest.removeprefix('conv.')}"
            n = 3 * i + j + 1
            return f"input_blocks.{n}.0.{resnet(rest)}" if kind == "resnets" else f"input_blocks.{n}.1.{rest}"
        if kind == "upsamplers":
            return f"output_blocks.{3 * i + 2}.{1 if i == 0 else 2}.{rest}"
        n = 3 * i + j
        return f"output_blocks.{n}.0.{resnet(rest)}" if kind == "resnets" else f"output_blocks.{n}.1.{rest}"
    m = re.fullmatch(r"mid_block\.(resnets|attentions)\.(\d)\.(.+)", key)
    if m:
        if m.group(1) == "attentions":
            return f"middle_block.1.{m.group(3)}"
        return f"middle_block.{2 * int(m.group(2))}.{resnet(m.group(3))}"
    raise KeyError(f"no CompVis name for UNet key {key}")


def _to_compvis_vae(key: str) -> str:
    """The inverse of ``_compvis_vae_key``."""
    if key.startswith(("quant_conv.", "post_quant_conv.")):
        return key
    side, _, rest = key.partition(".")
    if rest.startswith(("conv_in.", "conv_out.")):
        return key
    if rest.startswith("conv_norm_out."):
        return f"{side}.norm_out.{rest[len('conv_norm_out.'):]}"
    rest = rest.replace("conv_shortcut.", "nin_shortcut.")
    m = re.fullmatch(r"mid_block\.(resnets|attentions)\.(\d)\.(.+)", rest)
    if m:
        if m.group(1) == "resnets":
            return f"{side}.mid.block_{int(m.group(2)) + 1}.{m.group(3)}"
        sub = m.group(3)
        for src, dst in (("group_norm.", "norm."), ("to_q.", "q."), ("to_k.", "k."), ("to_v.", "v."),
                         ("to_out.0.", "proj_out.")):
            if sub.startswith(src):
                return f"{side}.mid.attn_1.{dst}{sub[len(src):]}"
    m = re.fullmatch(r"(down_blocks|up_blocks)\.(\d+)\.(resnets|downsamplers|upsamplers)\.(\d+)\.(.+)", rest)
    if m:
        lvl = int(m.group(2)) if side == "encoder" else 3 - int(m.group(2))
        level = "down" if side == "encoder" else "up"
        if m.group(3) == "resnets":
            return f"{side}.{level}.{lvl}.block.{m.group(4)}.{m.group(5)}"
        return f"{side}.{level}.{lvl}.{level}sample.{m.group(5)}"
    raise KeyError(f"no CompVis name for VAE key {key}")


def compvis_state_dict(unet: Mapping[str, torch.Tensor], vae: Mapping[str, torch.Tensor],
                       clip_text: Optional[Mapping[str, torch.Tensor]] = None,
                       dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """The port's UNet, VAE (``AutoencoderKL``) and text-encoder
    (``CLIPTextTransformer``) state dicts under a CompVis SD checkpoint's
    names, the VAE attention's linears as 1x1 convs, floats cast to
    ``dtype`` when given: the inverse of ``convert_compvis_state``."""
    out = {}

    def put(name, w):
        w = w.detach().cpu()
        out[name] = w.to(dtype) if dtype is not None and w.is_floating_point() else w

    for k, w in unet.items():
        put("model.diffusion_model." + _to_compvis_unet(k), w)
    for k, w in vae.items():
        if ".attentions.0.to_" in k and w.ndim == 2:
            w = w[:, :, None, None]
        put("first_stage_model." + _to_compvis_vae(k), w)
    for k, w in (clip_text or {}).items():
        put("cond_stage_model.transformer.text_model." + k, w)
    return out


def save_compvis_checkpoint(path: str, unet: Mapping[str, torch.Tensor], vae: Mapping[str, torch.Tensor],
                            clip_text: Optional[Mapping[str, torch.Tensor]] = None,
                            dtype: Optional[torch.dtype] = None) -> None:
    """Write ``compvis_state_dict``'s tensors as a CompVis ``.ckpt``:
    ``{'state_dict': ..., 'global_step': 0}``."""
    torch.save({"state_dict": compvis_state_dict(unet, vae, clip_text, dtype), "global_step": 0}, path)


class LdmCheckpointer:
    """The reference's ``LdmCheckpointer`` (``odise_checkpointer.py:
    114-124``) by name: ``load(path)`` returns ``load_compvis_checkpoint``'s
    state dicts, and given a ``model`` (an ``LdmExtractor``, or anything
    with ``vae`` and ``unet``) also copies the VAE and UNet into it."""

    def __init__(self, model: Optional[nn.Module] = None):
        self.model = model

    def load(self, path: str) -> Dict[str, Dict[str, torch.Tensor]]:
        state = load_compvis_checkpoint(path)
        if self.model is not None:
            merge_into_model(self.model, snapshot_state_dict(state))
        return state


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
