"""madm_torch: MADM in PyTorch for an NVIDIA H100 — the eval path (single
crop and sliding window, four eval heads, ``madm_torch.evaluation``), the
shipped UDA train step (``madm_torch.train``) and the trainer CLI
(``python -m madm_torch.main``).

A port of ``madm_tpu`` (the JAX reference, which stays as it is) that imports
neither JAX nor ``madm_tpu``.  Its hand-written CUDA kernels (flash attention
forward and backward, plain and packed-head, the fused sep-ASPP layer, the
dilated depthwise convs and conv_seg + argmax of the fused eval heads) build
from ``csrc/`` at first CUDA use; CPU tensors take their plain PyTorch twins.
"""

from __future__ import annotations

from .device import resolve_device


def entry(device="cuda", seed: int = 0):
    """(fn, example_args) for the flagship eval pass on ``device``: full
    SD-v1.4 MADM in bf16 on seeded random weights and one 512x512 crop
    (the port's counterpart of ``__graft_entry__.entry``)."""
    import torch

    from .models.madm import MADM, MADMConfig, init_random_

    dev = resolve_device(device)
    model = init_random_(MADM(MADMConfig(), device=dev),
                         torch.Generator(device=dev).manual_seed(seed))
    images = torch.zeros((1, 512, 512, 3), dtype=torch.float32, device=dev)
    return model.eval_forward, (images,)


__all__ = ["entry", "resolve_device"]
