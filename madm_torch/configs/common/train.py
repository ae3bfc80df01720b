# training defaults (reference config_files/common/train.py)
from madm_torch.config import ConfigDict

train = ConfigDict(
    output_dir="./output",
    init_checkpoint="",
    max_iter="???",
    # bf16 compute replaces torch AMP fp16 (no loss scaling needed)
    amp=ConfigDict(enabled=True, dtype="bfloat16"),
    grad_clip=None,
    checkpointer=ConfigDict(period=5000, max_to_keep=1),
    eval_period=5000,
    log_period=50,
    device="cuda",  # the CLI's --device decides; the JAX file says "tpu"
    seed=42,
    vis_period=0,
    wandb=ConfigDict(enable_writer=False, resume=False, project="MADM_TPU"),
    cfg_name="",
    run_name="",
    run_tag="",
    reference_world_size=0,
)
