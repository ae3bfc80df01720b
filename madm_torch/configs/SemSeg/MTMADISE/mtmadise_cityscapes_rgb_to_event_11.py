# Cityscapes RGB -> DSEC Event, 11 classes
# (PyTorch port of config_files/; reference config_files/SemSeg/MTMADISE/
# mtmadise_cityscapes_rgb_to_event_11.py)

from ...common.models.mtmadise_multi_lora import model, uda
from ...common.data.cityscapes_rgb_to_dsec_event_semseg import dataloader
from ...common.train import train
from ...common.optim import AdamW as optimizer

model.lora_configs = []  # --lora_configs '' (reference keeps LoRA off in shipped configs)
model.target_modality = "Event"
model.num_classes = len(dataloader.evaluator[0].stuff_classes)
model.train_palette = dataloader.evaluator[0].palette

train.max_iter = 10000
train.grad_clip = 0.01
train.checkpointer["period"] = 1000
train.eval_period = 1000
train.vis_period = 250

optimizer["lr"] = 5e-6
optimizer["weight_decay"] = 0.05

train.amp["enabled"] = True
dataloader.train.dataset.rare_class_sample = True
model.same_cond_params = True

model.rev_noise_sup = True
model.rev_noise_end_iter = 8000
model.rev_noise_gradually = True
model.denoise_timestep_range = [50, 51]
# --vae_decoder_loss s  (source-only palette regression, weight 20)
model.vae_decoder_loss = "s"
model.feature_dims[0] = 3
model.projection_dim[0] = 128
model.out_features[0] = "s0"
model.in_keys[0] = "s0"
model.reg_uncertain = True
model.vae_decoder_loss_type = "L1"
model.vae_decoder_loss_weight = [20.0]  # --vae_decoder_loss_weight 20.0

# python main.py --config-file config_files/SemSeg/MTMADISE/mtmadise_cityscapes_rgb_to_event_11.py --bs 2 --tag RGB2Event
