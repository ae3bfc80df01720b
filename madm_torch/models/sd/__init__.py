"""SD-v1.4 VAE, UNet, layers and noise schedule."""
