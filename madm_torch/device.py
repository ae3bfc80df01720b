"""Device resolution for the port's entry points.

Every entry point takes ``device=`` (default ``"cuda"``).  A CUDA device on
a host without one is an error, never a silent move to the CPU: the CPU runs
only when the caller asks for it.  ``"meta"`` builds a model's shapes
without its data (its layout, its names, its metadata).
"""

from __future__ import annotations

import subprocess

import torch


def card_line(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, to
    stand beside every number measured on it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[index]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is
    no usable CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asks for CUDA but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda', 'cpu' or 'meta'")
    return dev
