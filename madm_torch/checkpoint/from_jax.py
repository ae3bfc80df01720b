"""The JAX package's variables -> this port's state dict.

The inverse of the torch -> JAX mapping the JAX package's checkpoint
converter applies (``convert_unet_state``, ``convert_vae_state``,
``convert_projections``, ``convert_daformer_head``, ``convert_clip_project``,
and the peft adapters of ``convert_madm_pth``), restricted to the modules the
port holds, so both packages compute the same function on the same weights.
Besides ``params`` (the LoRA adapters ``params['lora']`` among them) and
``consts`` it carries what a JAX ``TrainState`` adds: the EMA teacher tree
(``ema``: projections, head, ``clip_project_others``, and ``unet`` and
``lora`` where an ``ema_w_unet`` state has them) and the BN statistics ``state.head_bn`` and
``state.ema_head_bn``; and the variants' trees: the second head
(``params.head_sec`` with ``state.head_sec_bn``), the pixel-unshuffle tower,
the ISA fuse layer and per-layer prompts.  Reads nested dicts of arrays (anything
``numpy.asarray`` takes); imports nothing of the JAX package.

Layout transforms (JAX -> torch):
    conv kernel [kh, kw, I, O] -> weight [O, I, kh, kw]   (depthwise: I = 1)
    dense kernel [I, O]        -> weight [O, I]  (UNet proj_in/proj_out: [O, I, 1, 1])
    norm scale / bias          -> weight / bias
    LoRA lora_a [in, r]        -> lora.<name>.<site>.lora_A [r, in]
    LoRA lora_b [r, out]       -> lora.<name>.<site>.lora_B [out, r]
    BN mean / var              -> running_mean / running_var (+ num_batches_tracked)
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_INDEXED = re.compile(
    r"(down_blocks|up_blocks|resnets|attentions|transformer_blocks|downsamplers|upsamplers"
    r"|to_out|net)_(\d+)"
)
_PROJ = re.compile(r"proj_(\d+)_block_(\d+)")
# BottleneckBlock: flax module -> detectron2 path (each conv owns its norm)
_BOTTLENECK = {"norm1": "conv1.norm", "norm2": "conv2.norm", "norm3": "conv3.norm",
               "shortcut_norm": "shortcut.norm"}


def _leaves(tree: Dict[str, Any], path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v, dtype=np.float32)


def _tensor(path: Tuple[str, ...], leaf: str, w: np.ndarray) -> Tuple[str, np.ndarray]:
    """(torch leaf name, converted array) for one flax leaf."""
    if leaf == "kernel":
        if w.ndim == 4:
            return "weight", w.transpose(3, 2, 0, 1)
        w = w.T
        if path and path[-1] in ("proj_in", "proj_out"):  # 1x1 convs in the torch UNet
            w = w[:, :, None, None]
        return "weight", w
    return {"scale": "weight", "mean": "running_mean", "var": "running_var"}.get(leaf, leaf), w


def _module_tree(tree: Dict[str, Any], prefix: str, rename=lambda p: p) -> Dict[str, np.ndarray]:
    out = {}
    for path, w in _leaves(tree):
        mod = tuple(rename(p) for p in path[:-1])
        name, val = _tensor(path[:-1], path[-1], w)
        out[".".join((prefix,) + mod + (name,))] = val
    return out


def _diffusers(name: str) -> str:
    """'down_blocks_0_resnets_1' -> 'down_blocks.0.resnets.1',
    'net_0_proj' -> 'net.0.proj', 'to_out_0' -> 'to_out.0'."""
    return re.sub(r"(\.\d+)_", r"\1.", _INDEXED.sub(r"\1.\2", name))


def _vae(tree: Dict[str, Any], side: str, quant: str) -> Dict[str, np.ndarray]:
    own = {k: v for k, v in tree.items() if k != quant}
    out = _module_tree(own, f"vae.{side}", _diffusers)
    out.update(_module_tree({quant: tree[quant]}, "vae"))
    return out


def _head(params: Dict[str, Any], stats: Dict[str, Any],
          prefix: str = "sem_seg_head") -> Dict[str, np.ndarray]:
    def rename(p: str) -> str:
        m = re.fullmatch(r"embed_(\d+)", p)
        if m:
            return f"embed_layers.{m.group(1)}.proj"
        m = re.fullmatch(r"aspp_(\d+)", p)
        if m:
            return f"aspp_modules.{m.group(1)}"
        m = re.fullmatch(r"(query_project|key_project)_(\d+)", p)  # ISA's ConvModule stacks
        if m:
            return f"{m.group(1)}.{m.group(2)}"
        if p == "vae_decoder_feat_proj":  # a one-block Sequential in the reference
            return "vae_decoder_feat_proj.0"
        return _BOTTLENECK.get(p, p)

    out = _module_tree(params, prefix, rename)
    out.update(_module_tree(stats, prefix, rename))
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = np.zeros((), np.int64)
    return out


def _projections(tree: Dict[str, Any], prefix: str = "feature_projections") -> Dict[str, np.ndarray]:
    out = {}
    for name, block in tree.items():
        idx, blk = _PROJ.fullmatch(name).groups()
        out.update(_module_tree(block, f"{prefix}.{idx}.{blk}",
                                lambda p: _BOTTLENECK.get(p, p)))
    return out


def _lora(tree: Dict[str, Any], prefix: str = "lora") -> Dict[str, np.ndarray]:
    out = {}
    for name, adapter in tree.items():
        for path, w in _leaves(adapter):
            site = ".".join(_diffusers(p) for p in path[:-1])
            leaf = {"lora_a": "lora_A", "lora_b": "lora_B"}[path[-1]]
            out[f"{prefix}.{name}.{site}.{leaf}"] = w.T
    return out


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{'params', 'ema', 'state', 'consts'}`` of the JAX ``MADM`` or its
    ``TrainState`` (or any part of them) -> {key: float32 CPU tensor} for
    ``MADM.load_state_dict``.  Subtrees that are absent are skipped, so one
    module's weights convert alone."""
    params = variables.get("params", {})
    state = variables.get("state", {})
    out: Dict[str, np.ndarray] = {}
    if "vae_encoder" in params:
        out.update(_vae(params["vae_encoder"], "encoder", "quant_conv"))
    if "vae_decoder" in params:
        out.update(_vae(params["vae_decoder"], "decoder", "post_quant_conv"))
    if "unet" in params:
        out.update(_module_tree(params["unet"], "unet", _diffusers))
    out.update(_lora(params.get("lora", {})))
    for domain, p in params.get("prompt", {}).items():
        out.update({f"prompt.{domain}.{k}": np.asarray(v, np.float32) for k, v in p.items()})
    if "projections" in params:
        out.update(_projections(params["projections"]))
    if "head" in params:
        out.update(_head(params["head"], state.get("head_bn", {})))
    if "head_sec" in params:
        out.update(_head(params["head_sec"], state.get("head_sec_bn", {}), "sem_seg_head_sec_modal"))
    if "pixel_unshuffle" in params:
        out.update(_module_tree(params["pixel_unshuffle"], "pixel_unshuffle"))
    ema = variables.get("ema", {})
    if "projections" in ema:
        out.update(_projections(ema["projections"], "ema.feature_projections"))
    if "head" in ema:
        out.update(_head(ema["head"], state.get("ema_head_bn", {}), "ema.sem_seg_head"))
    if "unet" in ema:
        out.update(_module_tree(ema["unet"], "ema.unet", _diffusers))
    out.update(_lora(ema.get("lora", {}), "ema.lora"))
    if "clip_project_others" in ema:
        out.update({f"ema.clip_project_others.{k}": np.asarray(v, np.float32)
                    for k, v in ema["clip_project_others"].items()})
    consts = variables.get("consts", {})
    if "uncond_inputs" in consts:
        out["uncond_inputs"] = np.asarray(consts["uncond_inputs"], np.float32)
    if "shared_noise" in consts:  # NHWC -> NCHW
        out["shared_noise"] = np.asarray(consts["shared_noise"], np.float32).transpose(0, 3, 1, 2)
    return {k: torch.tensor(v) for k, v in out.items()}
