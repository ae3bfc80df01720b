# optimizer config (reference config_files/common/optim.py): AdamW with
# no weight decay on norm/bias params (madm_torch.train.optimizer.make_optimizer masks)
from madm_torch.config import ConfigDict

AdamW = ConfigDict(
    name="adamw",  # 'adafactor' = factored 2nd moment + bf16 momentum
    #                (a JAX-package memory option; the port takes 'adamw' only)
    lr="???",
    weight_decay="???",
    weight_decay_norm=0.0,
    weight_decay_bias=0.0,
    betas=(0.9, 0.999),
    eps=1e-8,
    unet_lr=None,
)
