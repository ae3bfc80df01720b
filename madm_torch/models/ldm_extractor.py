"""CompVis-lineage LDM feature extractors, the legacy ODISE path (port of
``madm_tpu/models/ldm_extractor.py``; reference ``modeling/meta_arch/ldm.py:
56-782``).

- ``LatentDiffusion``: the SD checkpoint family's geometry, its 1000-step
  ldm_linear ``GaussianDiffusion`` and classifier-free guidance;
- ``LdmExtractor``: VAE-encoder, UNet and VAE-decoder taps with DDPM
  ``q_sample`` noising at ``steps``;
- ``LdmImplicitCaptionerExtractor``: an ``LdmExtractor`` whose prompt and
  time embedding are lifted from the image's CLIP embedding, one parameter
  set for 'rgb' and one for the other modalities.

The modules are this port's SD modules with their taps (``sd/vae.py``,
``sd/unet.py``); CompVis ``.ckpt`` weights load through
``madm_torch.checkpoint.load_compvis_checkpoint``.  State-dict names are
those ``checkpoint.from_jax.state_dict_from_jax`` gives the JAX package's
tree: ``vae.*``, ``unet.*``, ``clip_vision.*``, ``clip_project_rgb.*``,
``clip_project_others.*``, ``ema.clip_project_*``, and the buffers
``shared_noise`` (NCHW) and ``uncond_inputs``.  Images enter NHWC in [0, 1];
features leave NCHW.  The UNet's attentions and the VAE mid-blocks' run
through kernel K1 (34 launches a pass at one step).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, ClassVar, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import resolve_device
from . import clip_image
from . import prompt as prompt_lib
from .diffusion import GaussianDiffusion
from .madm import init_modules_
from .sd import unet as unet_lib
from .sd import vae as vae_lib
from .sd.scheduler import shared_noise


@dataclasses.dataclass(frozen=True)
class LatentDiffusion:
    """SD model metadata and schedule (reference ``ldm.py:56-225``): the
    image / latent geometry of each checkpoint family and the 1000-step
    ldm_linear ``GaussianDiffusion``; the modules live on ``LdmExtractor``."""

    LDM_CONFIGS: ClassVar[Dict[str, Tuple[Tuple[int, int], Tuple[int, int]]]] = {
        "sd://v1-3": ((512, 512), (64, 64)),
        "sd://v1-4": ((512, 512), (64, 64)),
        "sd://v1-5": ((512, 512), (64, 64)),
        "sd://v2-0-base": ((512, 512), (64, 64)),
        "sd://v2-1-base": ((512, 512), (64, 64)),
    }

    init_checkpoint: str = "sd://v1-4"
    guidance_scale: float = 7.5
    pixel_mean: Tuple[float, ...] = (0.5, 0.5, 0.5)
    pixel_std: Tuple[float, ...] = (0.5, 0.5, 0.5)

    @property
    def image_size(self) -> Tuple[int, int]:
        return self.LDM_CONFIGS[self.init_checkpoint][0]

    @property
    def latent_image_size(self) -> Tuple[int, int]:
        return self.LDM_CONFIGS[self.init_checkpoint][1]

    @property
    def latent_dim(self) -> int:
        return 4

    @functools.cached_property
    def diffusion(self) -> GaussianDiffusion:
        return GaussianDiffusion.create(steps=1000, schedule="ldm_linear")

    def apply_model_with_guidence(self, model_fn: Callable, x_noisy: torch.Tensor, t: torch.Tensor,
                                  cond) -> torch.Tensor:
        """Classifier-free guidance (reference ``ldm.py:133-142``; the
        reference's name): the batch carries [cond | uncond] halves, the
        first half of ``x_noisy`` goes to both, and both halves of the
        result are uncond + scale (cond - uncond)."""
        half = x_noisy[: len(x_noisy) // 2]
        eps = model_fn(torch.cat([half, half], dim=0), t, cond)
        cond_eps, uncond_eps = eps.chunk(2, dim=0)
        half_eps = uncond_eps + self.guidance_scale * (cond_eps - uncond_eps)
        return torch.cat([half_eps, half_eps], dim=0)


class LdmExtractor(nn.Module):
    """Feature extractor with encoder / UNet / decoder taps (reference
    ``ldm.py:228-616``).

    ``forward(image, cond_inputs, cond_emb)`` returns the flat feature list
    ``[*encoder, *unet x len(steps), *decoder]``: encoder taps are resnet
    inputs, UNet taps up-block inputs after the skip concat ('in'), decoder
    taps resnet inputs of the decoder run on the clean latent, as the
    reference hooks them (``ldm.py:419-524``).  ``compute_dtype`` is the VAE
    and UNet's; the constants stay fp32."""

    def __init__(self, ldm: Optional[LatentDiffusion] = None,
                 encoder_block_indices: Sequence[int] = (5, 7),
                 unet_block_indices: Sequence[int] = (2, 5, 8, 11),
                 decoder_block_indices: Sequence[int] = (2, 5),
                 steps: Sequence[int] = (0,), share_noise: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 unet_channels: Optional[Sequence[int]] = None,
                 vae_channels: Optional[Sequence[int]] = None,
                 device: str | torch.device = "cuda", **kwargs):
        super().__init__()
        self.ldm = ldm or LatentDiffusion(**kwargs)
        self.encoder_block_indices = tuple(encoder_block_indices)
        self.unet_block_indices = tuple(unet_block_indices)
        self.decoder_block_indices = tuple(decoder_block_indices)
        self.steps = tuple(steps)
        self.share_noise = share_noise
        self.compute_dtype = compute_dtype
        self.vae_ch = tuple(vae_channels or vae_lib.BLOCK_OUT_CHANNELS)
        self.unet_ch = tuple(unet_channels or unet_lib.BLOCK_OUT_CHANNELS)
        self.device = resolve_device(device)
        with torch.device(self.device):
            # 'in' encoder taps: the legacy hook placement (ldm.py:419-446)
            self.vae = vae_lib.AutoencoderKL(self.vae_ch, self.encoder_block_indices, "in",
                                             self.decoder_block_indices)
            self.unet = unet_lib.UNet2DCondition(self.unet_ch, self.unet_block_indices,
                                                 unet_block_indices_type="in")
        self.vae.to(dtype=compute_dtype)
        self.unet.to(dtype=compute_dtype)
        noise = None
        if share_noise:
            noise = torch.from_numpy(shared_noise(*self.ldm.latent_image_size)).permute(0, 3, 1, 2)
            noise = noise.contiguous().to(self.device)
        self.register_buffer("shared_noise", noise)
        self.register_buffer("uncond_inputs", torch.zeros(1, 77, 768, device=self.device))
        self.eval()
        self.requires_grad_(False)

    # -------------------------------------------------- dims / strides
    @property
    def feature_size(self) -> Tuple[int, int]:
        return self.ldm.image_size

    @property
    def feature_dims(self) -> List[int]:
        """Channels of each feature (reference ``reset_dim_stride``,
        ``ldm.py:277-338``)."""
        ch = self.vae_ch
        enc_in, prev = [], ch[0]  # encoder: 2 resnets a level, a tap is a resnet's input
        for c in ch:
            enc_in.extend([prev, c])
            prev = c
        enc = [enc_in[i] for i in self.encoder_block_indices]
        # UNet 'in' taps: an up-block resnet's input, the previous output
        # and the skip it concatenates
        skips = [self.unet_ch[0]]  # conv_in
        for i, c in enumerate(self.unet_ch):
            skips.extend([c, c] + ([c] if i != len(self.unet_ch) - 1 else []))  # + downsample
        unet_in, h = [], self.unet_ch[-1]
        for c in reversed(self.unet_ch):
            for _ in range(3):
                unet_in.append(h + skips.pop())
                h = c
        unet = [unet_in[i] for i in self.unet_block_indices]
        dec_in, prev = [], ch[-1]  # decoder: 3 resnets a level, levels reversed
        for c in reversed(ch):
            dec_in.extend([prev, c, c])
            prev = c
        dec = [dec_in[i] for i in self.decoder_block_indices]
        return enc + unet * len(self.steps) + dec

    @property
    def feature_strides(self) -> List[int]:
        """The reference's stride formulas (``ldm.py:297-331``)."""
        enc = [2 ** ((i + 2) // 2 - 1) for i in self.encoder_block_indices]
        unet = [64 // (2 ** ((i + 3) // 3 - 1)) for i in self.unet_block_indices]
        dec = [8 // (2 ** ((i + 3) // 3 - 1)) for i in self.decoder_block_indices]
        return enc + unet * len(self.steps) + dec

    @property
    def num_groups(self) -> int:
        return len(self.encoder_block_indices) + len(self.unet_block_indices) + len(self.decoder_block_indices)

    @property
    def grouped_indices(self) -> List[List[int]]:
        """Feature indices grouped across ``steps`` (``ldm.py:359-380``)."""
        n_enc, n_unet = len(self.encoder_block_indices), len(self.unet_block_indices)
        ret = [[i] for i in range(n_enc)]
        ret.extend([i + t * n_unet + n_enc for t in range(len(self.steps))] for i in range(n_unet))
        off = n_enc + len(self.steps) * n_unet
        ret.extend([i + off] for i in range(len(self.decoder_block_indices)))
        return ret

    # ----------------------------------------------------------- forward
    def forward(self, image: torch.Tensor, cond_inputs: Optional[torch.Tensor] = None,
                cond_emb: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """image [B, H, W, 3] in [0, 1]; cond_inputs [B, 77, 768] (default
        the empty-prompt embedding); cond_emb [B, len(steps), time_dim], a
        step's row added to the UNet's time embedding."""
        b = image.shape[0]
        dev = image.device
        mean = torch.tensor(self.ldm.pixel_mean, device=dev)
        std = torch.tensor(self.ldm.pixel_std, device=dev)
        x = ((image - mean) / std).permute(0, 3, 1, 2).to(self.compute_dtype)
        latent, enc_feats = self.vae.encode_features(x)
        if cond_inputs is None:
            cond_inputs = self.uncond_inputs.expand(b, 77, 768)
        diffusion = self.ldm.diffusion
        unet_feats: List[torch.Tensor] = []
        for i, t in enumerate(self.steps):
            if t < 0:  # the clean latent at t = 0 (ldm.py:565-570)
                noisy, tb = latent, torch.zeros((b,), dtype=torch.int32, device=dev)
            else:
                tb = torch.full((b,), t, dtype=torch.int32, device=dev)
                if self.shared_noise is not None:
                    noise = self.shared_noise.to(latent.dtype).expand(latent.shape)
                else:  # share_noise=False noises with zeros, as the JAX package
                    noise = torch.zeros_like(latent)
                noisy = diffusion.q_sample(latent, tb, noise)
            ce = None if cond_emb is None else cond_emb[:, i]
            _, taps = self.unet(noisy, tb, cond_inputs, ce)
            unet_feats.extend(taps)
        _, dec_feats = self.vae.decode_features(latent, output_final=False)
        features = [*enc_feats, *unet_feats, *dec_feats]
        assert len(features) == len(self.feature_dims), (len(features), len(self.feature_dims))
        return features


class LdmImplicitCaptionerExtractor(LdmExtractor):
    """CLIP-image-embedding-driven prompts over an ``LdmExtractor``
    (reference ``ldm.py:659-759``): the image's CLIP embedding (the tower
    ``clip_vision`` as ``ClipAdapter(normalize=False)`` runs it, fp32) is
    lifted by ``PositionalLinear`` to a 77 x 768 prompt, alpha-blended with
    the empty-prompt embedding, and to a time-embedding residual, one
    parameter set for 'rgb' (``clip_project_rgb``) and one for the other
    modalities (``clip_project_others``).  ``ema=True`` adds the EMA sets
    ``ema.clip_project_*`` that ``ema_forward`` reads.  The JAX class wraps
    an ``LdmExtractor``; this one is one (its keyword arguments are the
    extractor's), so its state dict is the JAX tree's, flat."""

    def __init__(self, learnable_time_embed: bool = True, num_timesteps: int = 1,
                 without_prompt: bool = False,
                 vision: clip_image.VisionConfig = clip_image.VisionConfig(),
                 ema: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.learnable_time_embed = learnable_time_embed
        self.num_timesteps = num_timesteps
        self.without_prompt = without_prompt
        self.time_embed_dim = self.unet_ch[0] * 4

        def project():
            return prompt_lib.ClipFeatureProject(self.time_embed_dim, prompt_lib.PROMPT_SEQ_LEN,
                                                 in_features=vision.out_dim, time_seq_len=num_timesteps)

        with torch.device(self.device):
            self.clip_vision = clip_image.CLIPVisionTransformer(vision)
            self.clip_project_rgb = project()
            self.clip_project_others = project()
            if ema:
                self.ema = nn.ModuleDict({"clip_project_rgb": project(), "clip_project_others": project()})
        self.requires_grad_(False)

    def embed_image(self, image: torch.Tensor) -> torch.Tensor:
        """The CLIP image embedding [B, out_dim] of ``image`` [B, H, W, 3] in
        [0, 1] (``ClipAdapter.embed_image``, unnormalised)."""
        size = self.clip_vision.cfg.image_size
        return self.clip_vision(clip_image.preprocess(image, size), normalize=False)

    def _project(self, p: prompt_lib.ClipFeatureProject, uncond: torch.Tensor, prefix: torch.Tensor):
        """ClipFeatureProject with ``input_prefix=True`` (``ldm_base.py:
        676-717``): prompt tanh(a_u) uncond + tanh(a_c) PL(prefix) (the
        empty prompt alone under ``without_prompt``), time tanh(a_t)
        PL(prefix detached)."""
        if self.without_prompt:
            cp = uncond.expand(prefix.shape[0], *uncond.shape[1:])
        else:
            cp = prompt_lib.cond_prompt(p, uncond, prefix)
        ct = prompt_lib.cond_time(p, prefix) if self.learnable_time_embed else None
        return cp, ct

    def forward(self, image: torch.Tensor, input_modal: str = "rgb",
                ema_forward: bool = False) -> List[torch.Tensor]:
        prefix = self.embed_image(image)
        key = "clip_project_rgb" if input_modal == "rgb" else "clip_project_others"
        if ema_forward and hasattr(self, "ema"):
            p = self.ema[key]
        else:
            p = getattr(self, key)
        cond_inputs, cond_emb = self._project(p, self.uncond_inputs, prefix)
        if cond_emb is not None and cond_emb.shape[1] != len(self.steps):
            cond_emb = cond_emb[:, :1].expand(cond_emb.shape[0], len(self.steps), cond_emb.shape[-1])
        return super().forward(image, cond_inputs=cond_inputs, cond_emb=cond_emb)


def init_random_(extractor: LdmExtractor, generator: torch.Generator) -> LdmExtractor:
    """Seeded random weights (``madm.init_random_``'s draws) following the
    JAX ``init_params``: the prompt blend weights U[0, 1), ``alpha_cond_time``
    0, ``clip_project_others`` a copy of ``clip_project_rgb``, the EMA sets
    copies of the student's.  ``generator`` must live on the extractor's
    device."""
    init_modules_(extractor, generator)
    if isinstance(extractor, LdmImplicitCaptionerExtractor):
        with torch.no_grad():
            extractor.clip_project_others.load_state_dict(extractor.clip_project_rgb.state_dict())
            for key, ema in getattr(extractor, "ema", {}).items():
                ema.load_state_dict(getattr(extractor, key).state_dict())
    return extractor
