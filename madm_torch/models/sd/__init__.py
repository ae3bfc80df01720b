"""SD-v1.4 VAE, UNet, layers, noise schedule and LoRA adapters."""

from .lora import LoRAAdapter, init_lora, merge_lora, parse_lora_configs
from .scheduler import add_noise, alphas_cumprod, shared_noise
from .unet import UNet2DCondition
from .vae import AutoencoderKL

__all__ = [
    "AutoencoderKL",
    "LoRAAdapter",
    "UNet2DCondition",
    "add_noise",
    "alphas_cumprod",
    "init_lora",
    "merge_lora",
    "parse_lora_configs",
    "shared_noise",
]
