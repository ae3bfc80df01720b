"""Checkpoints: save/resume of the train state (``checkpointer``), the
weight loaders of SD-v1.4 snapshots, released MADM ``.pth`` files, HF
CLIP vision towers and CompVis ``.ckpt`` files (``converter``), and weight conversion from the JAX package's tree
(``from_jax``)."""

from .checkpointer import BestCheckpointer, Checkpointer, PeriodicCheckpointer, load_checkpoint
from .converter import (
    LdmCheckpointer,
    compvis_state_dict,
    convert_clip_vision_state,
    convert_compvis_state,
    expand_conv_in,
    convert_madm_pth,
    load_clip_vision,
    load_compvis_checkpoint,
    load_safetensors,
    load_sd_snapshot,
    load_torch_file,
    merge_into_model,
    reference_state_dict,
    save_compvis_checkpoint,
    save_safetensors,
    save_sd_snapshot,
    snapshot_state_dict,
)

__all__ = [
    "BestCheckpointer",
    "Checkpointer",
    "LdmCheckpointer",
    "PeriodicCheckpointer",
    "compvis_state_dict",
    "convert_clip_vision_state",
    "convert_compvis_state",
    "convert_madm_pth",
    "expand_conv_in",
    "load_checkpoint",
    "load_clip_vision",
    "load_compvis_checkpoint",
    "load_safetensors",
    "load_sd_snapshot",
    "load_torch_file",
    "merge_into_model",
    "reference_state_dict",
    "save_compvis_checkpoint",
    "save_safetensors",
    "save_sd_snapshot",
    "snapshot_state_dict",
]
