# Cityscapes RGB -> DSEC Event (11 classes) dataloader
# (reference config_files/common/data/cityscapes_rgb_to_dsec_event_semseg.py)

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
        json_path=os.path.join(_JSON_DIR, "Cityscapes_RGB_to_DSEC_Event_train.json"),
        source_root_path="???",
        target_root_path="???",
        train_or_test="train",
        source_resize_h_w=[512, 1024],
        source_crop_size_h_w=[512, 512],
        target_resize_h_w=[512, 768],
        target_crop_size_h_w=[512, 512],
        label_convert=[[0, 5], [1, 6], [2, 1], [3, 9], [4, 2], [5, 4], [6, 10], [7, 10],
                       [8, 7], [9, 7], [10, 0], [11, 3], [12, 3], [13, 8], [14, 8],
                       [15, 8], [16, 8], [17, 8], [18, 8]],
    ),
    total_batch_size=2,
    num_workers=4,
)

dataloader.test = L(build_d2_test_dataloader)(
    dataset=L(CrossModalityDataset)(
        json_path=os.path.join(_JSON_DIR, "Cityscapes_RGB_to_DSEC_Event_test.json"),
        source_root_path="???",
        target_root_path="???",
        train_or_test="test",
        names="Cityscapes_RGB_to_DSEC_Event",
        test_resize_h_w=[512, 512],
        label_convert=None,
    ),
    local_batch_size=1,
    num_workers=4,
)

dataloader.evaluator = [
    L(DSECSemSegEvaluator)(
        dataset_name="Cityscapes_RGB_to_DSEC_Event",
        stuff_classes=["sky", "building", "fence", "person", "pole", "road",
                       "sidewalk", "vegetation", "car", "wall", "traffic sign"],
        palette=[70, 130, 180, 70, 70, 70, 190, 153, 153, 220, 20, 60, 153, 153, 153,
                 128, 64, 128, 244, 35, 232, 107, 142, 35, 0, 0, 142, 102, 102, 156,
                 250, 170, 30],
        ignore_label=255,
        output_dir=None,
        save_predictions_json=False,
        save_eval_results_step=10,
        convert_pred_list=None,
        enable_wandb=False,
    ),
]
