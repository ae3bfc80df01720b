"""Confusion-matrix mIoU evaluator (port of ``madm_tpu/evaluation/evaluator.py``;
reference ``evaluation/d2_evaluator.py``).

- (C+1)x(C+1) confusion matrix accumulated as ``bincount((C+1) * pred + gt)``
  with the ignore label mapped to class C (``d2_evaluator.py:122-127``); rows
  are predictions, columns ground truth.
- mIoU / fwIoU / mACC / pACC as in ``d2_evaluator.py:240-279`` (NaN for
  absent classes, validity masks on ground-truth presence).
- optional prediction-id remapping (``convert_pred_list``).

The reference's cross-rank all_gather is commented out, so its multi-GPU
logs show per-shard metrics; here ``evaluate(sum_across_processes=True)``
sums the matrices of all processes with ``torch.distributed`` where a
process group is initialised.
"""

from __future__ import annotations

import json
import logging
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..parallel import dist as dist_lib

logger = logging.getLogger(__name__)


def coco_rle_encode(mask: np.ndarray) -> dict:
    """COCO compressed RLE of a binary [H, W] mask (pycocotools-compatible:
    Fortran-order run lengths, LEB128-style signed-delta string encoding),
    in numpy, in place of the reference's pycocotools
    (``d2_evaluator.py:281-301``)."""
    h, w = mask.shape
    flat = np.asfortranarray(mask).flatten(order="F").astype(np.uint8)
    # run lengths, starting with the count of leading zeros
    changes = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], changes, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat[0] == 1:
        counts = [0] + counts

    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]  # delta encoding
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return {"size": [h, w], "counts": "".join(out)}


def _sum_over_processes(conf: np.ndarray) -> np.ndarray:
    """The confusion matrices of every process added up, where a
    ``torch.distributed`` process group of more than one is initialised."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1):
        return conf
    t = torch.from_numpy(conf)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t)
    return t.cpu().numpy()


def _gather_over_processes(items: list) -> list:
    """Every process's list, concatenated in rank order."""
    if dist_lib.world() == 1:
        return items
    import torch.distributed as dist

    out = [None] * dist_lib.world()
    dist.all_gather_object(out, items)
    return [x for part in out for x in part]


class DSECSemSegEvaluator:
    def __init__(
        self,
        dataset_name: str = "",
        stuff_classes: Sequence[str] = (),
        palette: Sequence[int] = (),
        ignore_label: int = 255,
        output_dir: Optional[str] = None,
        save_predictions_json: bool = False,
        save_eval_results_step: int = -1,
        convert_pred_list=None,
        enable_wandb: bool = False,
        **kwargs,
    ):
        self.dataset_name = dataset_name
        self._class_names = list(stuff_classes)
        self._num_classes = len(self._class_names)
        self.palette = list(palette)
        self._ignore_label = ignore_label
        self._output_dir = output_dir
        self.save_predictions_json = save_predictions_json
        self.save_eval_results_step = save_eval_results_step
        self.convert_pred_list = convert_pred_list
        self.reset()

    @property
    def stuff_classes(self):
        return self._class_names

    def reset(self):
        n = self._num_classes
        self._conf_matrix = np.zeros((n + 1, n + 1), dtype=np.int64)
        self._predictions: List[dict] = []
        self.eval_index = 0
        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)

    def encode_json_sem_seg(self, pred: np.ndarray, file_name: str) -> List[dict]:
        """COCO-stuff-format RLE records for one prediction
        (``d2_evaluator.py:281-301``)."""
        return [
            {
                "file_name": file_name,
                "category_id": int(label),
                "segmentation": coco_rle_encode(pred == label),
            }
            for label in np.unique(pred)
        ]

    def process(self, inputs: Dict, pred: np.ndarray) -> None:
        """Accumulate one image.

        ``pred``: [H, W] int class ids (already argmaxed).
        ``inputs``: sample dict with 'target_label' or 'file_name'.
        """
        pred = np.asarray(pred, dtype=np.int32)
        if self.convert_pred_list is not None:
            converted = pred.copy()
            for old_id, new_id in self.convert_pred_list:
                converted[pred == old_id] = new_id
            pred = converted

        if "target_label" in inputs:
            gt = np.asarray(inputs["target_label"], dtype=np.int32)
            if gt.ndim == 3:
                gt = gt[0]
        else:
            from PIL import Image  # only this branch reads an image file

            gt = np.array(Image.open(inputs["file_name"]), dtype=np.int32)
        gt = gt.copy()
        gt[gt == self._ignore_label] = self._num_classes

        assert pred.shape == gt.shape, f"pred {pred.shape} vs gt {gt.shape}"
        self._conf_matrix += np.bincount(
            (self._num_classes + 1) * pred.reshape(-1) + gt.reshape(-1),
            minlength=self._conf_matrix.size,
        ).reshape(self._conf_matrix.shape)
        if self.save_predictions_json:
            self._predictions.extend(
                self.encode_json_sem_seg(pred, inputs.get("file_name", ""))
            )
        self.eval_index += 1

    def evaluate(self, sum_across_processes: bool = True) -> "OrderedDict":
        """Compute mIoU/fwIoU/mACC/pACC (+ per-class IoU/ACC)."""
        conf = self._conf_matrix
        if sum_across_processes:
            conf = _sum_over_processes(conf)

        n = self._num_classes
        acc = np.full(n, np.nan, dtype=np.float64)
        iou = np.full(n, np.nan, dtype=np.float64)
        tp = conf.diagonal()[:-1].astype(np.float64)
        pos_gt = conf[:-1, :-1].sum(axis=0).astype(np.float64)
        class_weights = pos_gt / max(pos_gt.sum(), 1)
        pos_pred = conf[:-1, :-1].sum(axis=1).astype(np.float64)
        acc_valid = pos_gt > 0
        acc[acc_valid] = tp[acc_valid] / pos_gt[acc_valid]
        iou_valid = (pos_gt + pos_pred) > 0
        union = pos_gt + pos_pred - tp
        iou[acc_valid] = tp[acc_valid] / union[acc_valid]
        miou = np.nansum(iou[acc_valid]) / max(iou_valid.sum(), 1)
        fiou = np.nansum(iou[acc_valid] * class_weights[acc_valid])
        macc = np.nansum(acc[acc_valid]) / max(acc_valid.sum(), 1)
        pacc = tp.sum() / max(pos_gt.sum(), 1)

        res: Dict[str, float] = {}
        res["mIoU"] = 100 * miou
        res["fwIoU"] = 100 * fiou
        for i, name in enumerate(self._class_names):
            res[f"IoU-{name}"] = 100 * iou[i]
        res["mACC"] = 100 * macc
        res["pACC"] = 100 * pacc
        for i, name in enumerate(self._class_names):
            res[f"ACC-{name}"] = 100 * acc[i]

        predictions = self._predictions
        if self.save_predictions_json and sum_across_processes:
            predictions = _gather_over_processes(predictions)
        if self._output_dir and (not sum_across_processes or dist_lib.is_main()):  # one writer
            with open(os.path.join(self._output_dir, "sem_seg_evaluation.json"), "w") as f:
                json.dump({k: (None if np.isnan(v) else v) for k, v in res.items()}, f)
            if self.save_predictions_json:
                with open(os.path.join(self._output_dir, "sem_seg_predictions.json"), "w") as f:
                    json.dump(predictions, f)

        self._log_per_class_table(iou, acc)
        return OrderedDict({"sem_seg": res})

    def _log_per_class_table(self, iou, acc):
        rows = [
            f"{name:>16s} | IoU {100 * i:6.2f} | ACC {100 * a:6.2f}"
            for name, i, a in zip(self._class_names, iou, acc)
        ]
        logger.info("per-category results:\n" + "\n".join(rows))
