# MADM model graph (PyTorch port of config_files/common/models/
# mtmadise_multi_lora.py; reference config_files/common/models/mtmadise_multi_lora.py).  Same public knobs;
# experiment configs mutate them exactly like the reference does.

from madm_torch.config import ConfigDict, LazyCall as L
from madm_torch.models.build import build_madm

model = L(build_madm)(
    num_classes=19,
    target_modality="???",
    lora_configs=[],
    # backbone taps / projections (reference defaults before the
    # experiment-config s0 overrides)
    feature_dims=[3, 320, 640, 1280],
    projection_dim=[128, 512, 512, 512],
    out_features=["s0", "s3", "s4", "s5"],
    in_keys=["s0", "s3", "s4", "s5"],
    unet_block_indices=[5, 8, 11],
    unet_block_indices_type="after",  # 'in' or 'after'
    head_channels=256,
    same_cond_params=True,
    vae_decoder_loss="st",
    ema_alpha=0.999,
    pseudo_threshold=0.968,
    train_palette="???",
    crop_size=[512, 512],
    compute_dtype="bfloat16",
    # UNet gradient checkpointing in the JAX package (use_checkpoint); a
    # memory option the port's step does without (madm_torch.models.build)
    remat=True,
)

# UDA training knobs live on the model node (reference surface — CMDISE/
# MTMADISE ctor args), so `model.rev_noise_sup=True` overrides port verbatim.
# `uda` remains as an optional override namespace (takes precedence when a
# key is set; see madm_torch.train.build_train_config).
uda = ConfigDict()
