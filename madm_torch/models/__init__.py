"""Models of the eval pass: SD-v1.4 VAE/UNet, prompts, projections,
DAFormer head, and the MADM container."""
