"""Models: SD-v1.4 VAE/UNet, prompts, projections, DAFormer head (eval and
train mode), and the MADM container with its EMA teacher; the diffusion
library (``diffusion``) and the CompVis-lineage LDM extractors
(``ldm_extractor``)."""
