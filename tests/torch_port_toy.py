"""A toy-width model shared by the port's parity tests: the port's MADM on
seeded random weights and the same weights as the JAX package's variables,
through the JAX package's checkpoint converter (cheaper than a flax init)."""

import jax.numpy as jnp
import numpy as np
import torch

from madm_tpu.checkpoint.converter import (
    convert_clip_project,
    convert_daformer_head,
    convert_projections,
    convert_unet_state,
    convert_vae_state,
)
from madm_tpu.models.madm import MADM as JaxMADM
from madm_tpu.models.madm import MADMConfig as JaxMADMConfig
from madm_torch.models.madm import MADM, MADMConfig, init_random_

TOY = dict(num_classes=11, crop_size=(64, 64), unet_channels=(32, 64, 128, 128),
           vae_channels=(32, 32, 64, 64), feature_dims=(3, 32, 64, 128),
           projection_dim=(32, 32, 32, 32))


def jax_variables(port: MADM) -> dict:
    """The port's weights as the JAX ``MADM``'s eval variables."""
    sd = {k: v.float().numpy() for k, v in port.state_dict().items()}

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    enc, dec = convert_vae_state(sub("vae."))
    head, head_bn = convert_daformer_head(sd, "sem_seg_head")
    return {
        "params": {"vae_encoder": enc, "vae_decoder": dec, "unet": convert_unet_state(sub("unet.")),
                   "prompt": {"clip_project_rgb": convert_clip_project(sd, "prompt.clip_project_rgb")},
                   "projections": convert_projections(sd, "feature_projections"), "head": head},
        "state": {"head_bn": head_bn},
        "consts": {"uncond_inputs": sd["uncond_inputs"],
                   "shared_noise": sd["shared_noise"].transpose(0, 2, 3, 1)},
    }


def toy_pair(seed: int = 0):
    """(port MADM fp32 on the CPU, JAX MADM, its variables) on the same weights."""
    port = init_random_(MADM(MADMConfig(**TOY, compute_dtype=torch.float32), device="cpu"),
                        torch.Generator().manual_seed(seed))
    jm = JaxMADM(JaxMADMConfig(**TOY, compute_dtype=jnp.float32))
    return port, jm, jax_variables(port)


def sure_pixels(logits: np.ndarray, margin: float = 1e-4) -> np.ndarray:
    """Pixels whose top-2 logit margin (last axis) exceeds ``margin``: there
    an argmax is settled beyond fp32 summation-order noise."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > margin
