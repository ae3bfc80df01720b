"""Evaluation: the eval functions, the test-set loop and the mIoU evaluator (port of
``madm_tpu/evaluation``)."""

from .evaluator import DSECSemSegEvaluator, coco_rle_encode
from .inference import inference_on_dataset, make_eval_fn, make_slide_eval_fn, pad_to_divisible

__all__ = [
    "DSECSemSegEvaluator",
    "coco_rle_encode",
    "inference_on_dataset",
    "make_eval_fn",
    "make_slide_eval_fn",
    "pad_to_divisible",
]
