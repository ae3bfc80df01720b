"""Ops of the eval pass: attention (kernel K1), GroupNorm, the fused
sep-ASPP layer (kernel K2)."""
