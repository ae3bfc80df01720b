"""LoRA adapters on the UNet's attention projections, merged functionally
(port of ``madm_tpu/models/sd/lora.py``; the reference injects peft
adapters, ``mtmadise.py:115-147``).

An adapter holds, for every ``to_q``, ``to_k``, ``to_v`` and ``to_out.0``
linear of the UNet, peft's two matrices in peft's layout, ``lora_A`` [r, in]
and ``lora_B`` [out, r], under the linear's UNet path: the state-dict key
``lora.<name>.<path>.lora_A`` holds what a released checkpoint stores as
``<path>.lora_A.<name>.weight``.  Activating an adapter is ``merge_lora``:
W' = W + (alpha / r) (B @ A) in the port's [out, in] layout (the JAX package
keeps a = A^T [in, r] and b = B^T [r, out] and adds (a @ b) scale to its
[in, out] kernel).  The merge is computed per pass from the current tensors,
never written into the module, so gradients reach W, A and B, and adapters
switch from pass to pass within one train step.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch
from torch import nn

LORA_TARGETS = ("to_q", "to_k", "to_v", "to_out.0")
# adapter names the reference's configs use (mtmadise.py:48-54)
ADAPTER_NAMES = ("default", "Infrared", "Depth", "Event")
_SPEC = re.compile(r"([A-Za-z]+)_r(\d+)_a(\d+)")


def lora_sites(unet: nn.Module) -> Iterator[Tuple[str, nn.Linear]]:
    """(path, linear) of every attention projection an adapter covers."""
    ends = tuple("." + t for t in LORA_TARGETS)
    for name, m in unet.named_modules():
        if isinstance(m, nn.Linear) and name.endswith(ends):
            yield name, m


class LoRASite(nn.Module):
    """peft's pair for one linear: ``lora_A`` [rank, in], ``lora_B`` [out, rank]."""

    def __init__(self, d_in: int, d_out: int, rank: int):
        super().__init__()
        self.lora_A = nn.Parameter(torch.zeros(rank, d_in))
        self.lora_B = nn.Parameter(torch.zeros(d_out, rank))


class LoRAAdapter(nn.Module):
    """One adapter: a ``LoRASite`` for each of ``lora_sites(unet)``, nested
    under the UNet's module path.  Built zero; ``reset_lora_`` or a
    checkpoint fills it."""

    def __init__(self, unet: nn.Module, rank: int):
        super().__init__()
        self.rank = rank
        for name, lin in lora_sites(unet):
            *path, leaf = name.split(".")
            node: nn.Module = self
            for tok in path:
                if tok not in node._modules:
                    node.add_module(tok, nn.Module())
                node = node._modules[tok]
            node.add_module(leaf, LoRASite(lin.in_features, lin.out_features, rank))

    def sites(self) -> Iterator[Tuple[str, LoRASite]]:
        for name, m in self.named_modules():
            if isinstance(m, LoRASite):
                yield name, m


@torch.no_grad()
def reset_lora_(adapter: LoRAAdapter, generator: torch.Generator) -> LoRAAdapter:
    """peft's ``init_lora_weights='gaussian'``: A ~ N(0, 1) / rank, B = 0, so
    the adapter starts as the identity (``mtmadise.py:118-124``)."""
    for _, site in adapter.sites():
        a = site.lora_A
        a.copy_(torch.randn(a.shape, generator=generator, device=a.device) / adapter.rank)
        site.lora_B.zero_()
    return adapter


def init_lora(unet: nn.Module, rank: int, generator: torch.Generator) -> LoRAAdapter:
    """A fresh adapter over every attention projection of ``unet`` (JAX
    ``init_lora``); alpha is not a tensor: ``parse_lora_configs`` keeps it."""
    with torch.device(next(unet.parameters()).device):
        adapter = LoRAAdapter(unet, rank)
    return reset_lora_(adapter, generator)


def merge_lora(weights: Mapping[str, torch.Tensor], adapter: Optional[LoRAAdapter],
               scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """``weights`` (UNet parameter name -> tensor) with W + (B @ A) scale at
    every adapted ``<path>.weight``.  The sum is formed in fp32 and rounded
    once to W's dtype, so a bf16 W is rounded once, not twice.  ``scale`` is
    peft's alpha / rank; ``adapter=None`` returns ``weights`` (no adapter)."""
    if adapter is None:
        return dict(weights)
    out = dict(weights)
    for path, site in adapter.sites():
        w = weights[f"{path}.weight"]
        delta = (site.lora_B.float() @ site.lora_A.float()) * scale
        out[f"{path}.weight"] = (w.float() + delta).to(w.dtype)
    return out


def parse_lora_configs(lora_configs) -> Dict[str, Dict[str, int]]:
    """``['Infrared_r16_a16', ...]`` -> ``{'Infrared': {'rank': 16, 'alpha': 16}}``
    (reference ``mtmadise.py:48-54``); another form or name raises."""
    out = {}
    for s in lora_configs or ():
        m = _SPEC.fullmatch(s)
        if m is None or m.group(1) not in ADAPTER_NAMES:
            raise ValueError(f"lora config {s!r} is not <name>_r<rank>_a<alpha> with a name in "
                             f"{ADAPTER_NAMES}")
        out[m.group(1)] = {"rank": int(m.group(2)), "alpha": int(m.group(3))}
    return out
