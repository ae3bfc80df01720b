"""The shipped UDA train step: DACS mix, EMA teacher with rev-noise
pseudo-labels, palette regression through the frozen VAE, AdamW."""
