"""Multi-target-modality dataset (port of ``madm_tpu/data/multi_modality.py``;
reference: ``data/dataset/multi_modality_dataset.py``).

A variant of ``CrossModalityDataset`` serving several target modalities per
sample, with per-modality index splits (reference ``:219-236,246-253``).  Not
referenced by the shipped configs (the single-target dataset is the active
path), kept for the multi-target-adaptation workflow.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from .dataset import CrossModalityDataset


class MultiModalityDataset(CrossModalityDataset):
    def __init__(self, *args, target_modalities: Sequence[str] = (), **kwargs):
        super().__init__(*args, **kwargs)
        self.target_modalities = list(
            target_modalities or self.manifest["target_data"].keys()
        )
        self.target_modalities = [
            m for m in self.target_modalities if m != "label"
        ]
        self._lengths = {
            m: len(self.manifest["target_data"][m]) for m in self.target_modalities
        }

    def __getitem__(self, idx: int) -> Dict:
        source_idx = idx % self.source_data_length
        if self.train_or_test == "train":
            src = (
                self.get_rare_class_sample()
                if self.rare_class_sample
                else self.get_source_data(source_idx)
            )
            rh, rw = self.target_resize_h_w
            ch, cw = self.target_crop_size_h_w
            targets = {}
            for m in self.target_modalities:
                t_idx = idx % self._lengths[m]
                flip = self.rng.random() < 0.5
                x = self.rng.randint(0, rw - cw)
                y = self.rng.randint(0, rh - ch)
                path = os.path.join(
                    self.target_root_path, self.manifest["target_data"][m][t_idx]
                )
                targets[m] = self._load(path, (rw, rh), (x, y, cw, ch), flip)
            return {
                "source_rgb": src["rgb"],
                "source_label": self._convert_label(src["label"]),
                "target_second_modality": targets,
                "height": ch,
                "width": cw,
            }
        out = super().__getitem__(idx)
        out["modality_type"] = self.target_modalities[0]
        return out
