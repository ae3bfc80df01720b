"""Ops: attention (kernels K1 and K3), GroupNorm, the fused sep-ASPP layer
(kernel K2), the DACS mix and augmentations, palette colours."""
