# Cityscapes RGB -> FMB Infrared (9 classes) dataloader
# (reference config_files/common/data/cityscapes_rgb_to_fmb_9_infrared_semseg.py)

import os

from madm_torch.config import ConfigDict, LazyCall as L
from madm_torch.data import (
    CrossModalityDataset,
    build_d2_test_dataloader,
    build_d2_train_dataloader,
)
from madm_torch.evaluation import DSECSemSegEvaluator

_JSON_DIR = os.environ.get(
    "MADM_JSON_DIR",
    os.path.join(os.path.dirname(__file__), "../../../../data/json_file"),
)

dataloader = ConfigDict()

dataloader.train = L(build_d2_train_dataloader)(
    dataset=L(CrossModalityDataset)(
        json_path=os.path.join(_JSON_DIR, "Cityscapes_RGB_to_FMB_Infrared_train.json"),
        source_root_path="???",
        target_root_path="???",
        train_or_test="train",
        source_resize_h_w=[512, 1024],
        source_crop_size_h_w=[512, 512],
        target_resize_h_w=[512, 683],
        target_crop_size_h_w=[512, 512],
        label_convert=[[0, 4], [1, 5], [2, 1], [3, 255], [4, 255], [5, 3], [6, 8],
                       [7, 8], [8, 6], [9, 6], [10, 0], [11, 2], [12, 2], [13, 7],
                       [14, 7], [15, 7], [16, 7], [17, 7], [18, 7]],
    ),
    total_batch_size=2,
    num_workers=4,
)

dataloader.test = L(build_d2_test_dataloader)(
    dataset=L(CrossModalityDataset)(
        json_path=os.path.join(_JSON_DIR, "Cityscapes_RGB_to_FMB_Infrared_test.json"),
        source_root_path="???",
        target_root_path="???",
        train_or_test="test",
        names="Cityscapes_RGB_to_FMB_Infrared",
        test_resize_h_w=[512, 512],
        label_convert=[[0, 255], [1, 4], [2, 5], [3, 1], [4, 8], [5, 8], [6, 6],
                       [7, 0], [8, 2], [9, 7], [10, 7], [11, 7], [12, 7], [13, 7],
                       [14, 3]],
    ),
    local_batch_size=1,
    num_workers=4,
)

dataloader.evaluator = [
    L(DSECSemSegEvaluator)(
        dataset_name="Cityscapes_RGB_to_FMB_Infrared",
        stuff_classes=["sky", "building", "person", "pole", "road",
                       "sidewalk", "vegetation", "car", "traffic sign"],
        palette=[70, 130, 180, 70, 70, 70, 220, 20, 60, 153, 153, 153, 128, 64, 128,
                 244, 35, 232, 107, 142, 35, 0, 0, 142, 250, 170, 30],
        ignore_label=255,
        output_dir=None,
        save_predictions_json=False,
        save_eval_results_step=10,
        convert_pred_list=None,
        enable_wandb=False,
    ),
]
