# Cityscapes RGB -> DELIVER Depth, 11 classes
# (PyTorch port of config_files/; reference config_files/SemSeg/MTMADISE/
# mtmadise_cityscapes_rgb_to_depth_11.py — same overrides, same values)

from ...common.models.mtmadise_multi_lora import model, uda
from ...common.data.cityscapes_rgb_to_deliver_11_depth_semseg import dataloader
from ...common.train import train
from ...common.optim import AdamW as optimizer

model.lora_configs = []  # --lora_configs ''
model.target_modality = "Depth"
model.num_classes = len(dataloader.evaluator[0].stuff_classes)
model.train_palette = dataloader.evaluator[0].palette

train.max_iter = 10000  # --max_iter 10000
train.grad_clip = 0.01
train.checkpointer["period"] = 1000  # --eval_iter 1000
train.eval_period = 1000
train.vis_period = 250  # --vis_period 250

optimizer["lr"] = 5e-6  # --lr 5e-6
optimizer["weight_decay"] = 0.05

train.amp["enabled"] = True  # --amp (bf16 compute)
dataloader.train.dataset.rare_class_sample = True  # --rare_class_sample
model.same_cond_params = True  # --same_cond_params

model.rev_noise_sup = True  # --rev_noise_sup
model.rev_noise_end_iter = 5000  # --rev_noise_end_iter 5000
model.rev_noise_gradually = True  # --rev_noise_gradually
model.denoise_timestep_range = [60, 61]  # --denoise_timestep_range 60 61
# --vae_decoder_loss st
model.vae_decoder_loss = "st"
model.feature_dims[0] = 3
model.projection_dim[0] = 128
model.out_features[0] = "s0"
model.in_keys[0] = "s0"
model.reg_uncertain = True  # --reg_uncertain
model.vae_decoder_loss_type = "L1"  # --vae_decoder_loss_type L1
model.vae_decoder_loss_weight = [1.0, 1.0]  # --vae_decoder_loss_weight 1.0 1.0

# python main.py --config-file config_files/SemSeg/MTMADISE/mtmadise_cityscapes_rgb_to_depth_11.py --bs 2 --tag RGB2Depth
