"""CrossModalityDataset: paired source/target dataset + rare-class sampling
(port of ``madm_tpu/data/dataset.py``).

Host-side re-implementation of ``data/dataset/cross_modality_dataset.py``
(PIL + numpy).  Semantics preserved:

- JSON manifest with ``source_data.{RGB,label}`` and
  ``target_data.{second_modality,label}`` path lists; ``len = len(source) *
  len(target)``; index maps via modulo on each side (``:430-431``).
- train: resize (bilinear data / nearest label) -> random crop -> random
  horizontal flip, identical crop/flip for image+label (``:266-298,352-365``);
  target gets its own random crop/flip (``:443-453``).  The crop and flip
  draws come from ``random.Random(seed)`` in the JAX package's order.
- rare-class sampling (RCS): class ~ softmax((1-freq)/T) over
  ``sample_class_stats.json``; pick a file containing the class from
  ``samples_with_class.json`` (> 3000 px) and re-crop up to 10x until the
  crop keeps >= 1500 px of the class (``:87-109,242-264,302-318``).  The
  class and file draws come from a ``numpy.random.Generator`` seeded by the
  dataset's seed (the JAX package draws them from the global ``np.random``).
- label_convert applied as a simultaneous id remap (``:417-421``).
- DELIVER label preprocessing: take channel 0 and shift ids by -1, keeping
  255 (``:184-188,401-410``).
- test: resize both image and label to ``test_resize_h_w``; emits
  ``file_name``/``pred_save_name`` for the evaluator (``:488-521``).

Ablations (JAX ``dataset.py:79-130``): ``remove_amp`` adds
'source_rgb_pha' (the FDA low-frequency amplitude flattened over a band
drawn in [remove_amp[0], remove_amp[1]], blended by ``fda_fusion_val``);
``remove_texture`` adds 'target_second_modality_pha' (the target's local
edge texture); ``pl_data_path`` adds 'source_pl_data' with the source's
crop and flip; ``merge_more_target_data`` appends a target subdirectory's
images.

Images decode with the native C++ decoder (``native``: decode, resample,
crop and flip in one call) where it builds and loads, else with PIL, as the
JAX package chooses; the two resample bilinear images within 1 of each
other on [0, 255] (labels, nearest, exactly alike).  The dataset logs
which one it uses.

Output layout is **NHWC float32 in [0, 255]** (converted to [0,1] by the
loader), labels [H, W] int32.
"""

from __future__ import annotations

import json
import logging
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from ..ops.fda import extract_edge_info_local, remove_array_amp
from . import native

logger = logging.getLogger(__name__)

IGNORE_LABEL = 255


def get_rcs_class_probs(data_root: str, temperature: float):
    """(classes, probs) for rare-class sampling (reference ``:87-109``)."""
    with open(os.path.join(data_root, "sample_class_stats.json")) as f:
        sample_class_stats = json.load(f)
    overall: Dict[int, int] = {}
    for s in sample_class_stats:
        s = dict(s)
        s.pop("file", None)
        for c, n in s.items():
            overall[int(c)] = overall.get(int(c), 0) + n
    overall = dict(sorted(overall.items(), key=lambda kv: kv[1]))
    freq = np.asarray(list(overall.values()), np.float64)
    freq = freq / freq.sum()
    freq = 1 - freq
    e = np.exp(freq / temperature - np.max(freq / temperature))
    probs = e / e.sum()
    return list(overall.keys()), probs.astype(np.float64)


class CrossModalityDataset:
    rcs_class_temp = 0.01
    rcs_min_crop_ratio = 0.5
    rcs_min_pixels = 3000

    def __init__(
        self,
        json_path: str,
        source_root_path: str = "",
        target_root_path: str = "",
        source_resize_h_w: Optional[Sequence[int]] = None,
        source_crop_size_h_w: Optional[Sequence[int]] = None,
        target_resize_h_w: Optional[Sequence[int]] = None,
        target_crop_size_h_w: Optional[Sequence[int]] = None,
        test_resize_h_w: Optional[Sequence[int]] = None,
        train_or_test: str = "train",
        label_convert=None,
        rare_class_sample: bool = False,
        names: Optional[str] = None,
        seed: Optional[int] = None,
        remove_amp: Optional[Sequence[float]] = None,
        fda_fusion_val: Optional[Sequence[float]] = None,
        remove_texture: bool = False,
        pl_data_path: Optional[str] = None,
        merge_more_target_data: Optional[str] = None,
        **kwargs,
    ):
        assert train_or_test in {"train", "test"}
        self.json_path = json_path
        self.source_root_path = source_root_path
        self.target_root_path = target_root_path
        self.train_or_test = train_or_test
        self.source_resize_h_w = list(source_resize_h_w or (0, 0))
        self.source_crop_size_h_w = list(source_crop_size_h_w or (0, 0))
        self.target_resize_h_w = list(target_resize_h_w or (0, 0))
        self.target_crop_size_h_w = list(target_crop_size_h_w or (0, 0))
        self.test_resize_h_w = list(test_resize_h_w) if test_resize_h_w else None
        self.label_convert = label_convert
        self.rare_class_sample = rare_class_sample
        self.names = names
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)  # the rare-class draws
        # FDA ablation (reference :112-126,195-205,287-291): when set, each
        # train sample additionally carries 'source_rgb_pha' — the source
        # image with its low-frequency FFT amplitude flattened over a random
        # band in [remove_amp[0], remove_amp[1]]
        self.remove_amp = list(remove_amp) if remove_amp is not None else None
        if self.remove_amp is not None:
            assert len(self.remove_amp) == 2, self.remove_amp
        self.fda_fusion_val = (
            list(fda_fusion_val) if fda_fusion_val is not None else None
        )
        # edge-texture ablation (reference :206-207,465-470): the target
        # image's local-region edge map rides along as
        # 'target_second_modality_pha'
        self.remove_texture = remove_texture
        assert not (self.remove_amp and self.remove_texture)
        # two-stage extras: pl_data_path points at stage-1 generated images
        # parallel to the source labels (reference :278-284); samples gain
        # 'source_pl_data' with the same crop/flip as the source
        self.pl_data_path = pl_data_path

        # DELIVER label ids are stored +1 with channelled PNGs (ref :184-188)
        self.deliver_label_process = (
            "to_DELIVER_Depth" in json_path and train_or_test == "test"
        ) or "DELIVER_RGB2Depth" in json_path or "DELIVER_Depth2RGB" in json_path

        with open(json_path) as f:
            self.manifest = json.load(f)

        # extra unlabeled target images from a subdirectory of the target
        # root ("like dreambooth", reference :223-228)
        if merge_more_target_data is not None:
            extra_dir = os.path.join(target_root_path, merge_more_target_data)
            for name in sorted(os.listdir(extra_dir)):
                self.manifest["target_data"]["second_modality"].append(
                    os.path.join(merge_more_target_data, name)
                )

        self.source_data_length = (
            len(self.manifest["source_data"]["RGB"]) if train_or_test == "train" else 1
        )
        self.target_data_length = len(self.manifest["target_data"]["second_modality"])

        if self.label_convert is not None:
            lut = np.arange(256, dtype=np.int32)
            for old_id, new_id in self.label_convert:
                lut[old_id] = new_id
            self._label_lut = lut
        else:
            self._label_lut = None

        if self.rare_class_sample:
            self._init_rcs()
        logger.info(f"{type(self).__name__} ({train_or_test}) decodes images with {native.decoder_name()}")

    # ------------------------------------------------------------------ RCS
    def _init_rcs(self):
        self.rcs_classes, self.rcs_classprob = get_rcs_class_probs(
            self.source_root_path, self.rcs_class_temp
        )
        logger.info(f"RCS Classes: {self.rcs_classes}")
        logger.info(f"RCS ClassProb: {self.rcs_classprob}")
        with open(os.path.join(self.source_root_path, "samples_with_class.json")) as f:
            swc = json.load(f)
        swc = {int(k): v for k, v in swc.items() if int(k) in self.rcs_classes}
        self.samples_with_class = {}
        for c in self.rcs_classes:
            self.samples_with_class[c] = [
                file.split("/")[-1] for file, px in swc[c] if px > self.rcs_min_pixels
            ]
            assert self.samples_with_class[c], f"no samples for rcs class {c}"
        self.file_to_idx = {
            name.split("/")[-1]: i
            for i, name in enumerate(self.manifest["source_data"]["label"])
        }

    def __len__(self):
        return self.source_data_length * self.target_data_length

    # ------------------------------------------------------------- loading
    def _load(
        self, path, resize_wh=None, crop=None, flip=False, is_label=False,
    ) -> np.ndarray:
        if native.available():
            arr = native.load(path, resize_wh, crop, flip, nearest=is_label, out_c=1 if is_label else 3)
            if is_label:
                return self._deliver_shift(arr[..., 0].astype(np.int32))
            return arr.astype(np.float32)
        img = Image.open(path)
        if resize_wh is not None:
            img = img.resize(resize_wh, Image.NEAREST if is_label else Image.BILINEAR)
        if crop is not None:
            x, y, w, h = crop
            img = img.crop((x, y, x + w, y + h))
        if flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        arr = np.array(img)
        if is_label:
            if arr.ndim == 3:
                arr = arr[..., 0]
            return self._deliver_shift(arr.astype(np.int32))
        # data: HWC float32 0..255, force 3 channels
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        elif arr.shape[-1] == 4:
            arr = arr[..., :3]
        return arr.astype(np.float32)

    def _deliver_shift(self, label: np.ndarray) -> np.ndarray:
        """DELIVER label ids -1, 255 kept (reference ``:184-188``)."""
        if self.deliver_label_process:
            mask = label == IGNORE_LABEL
            label = label - 1
            label[mask] = IGNORE_LABEL
        return label

    def _convert_label(self, label: np.ndarray) -> np.ndarray:
        if self._label_lut is None:
            return label
        return self._label_lut[np.clip(label, 0, 255)]

    def get_source_data(self, source_idx: int):
        rh, rw = self.source_resize_h_w
        ch, cw = self.source_crop_size_h_w
        flip = self.rng.random() < 0.5
        x = self.rng.randint(0, rw - cw)
        y = self.rng.randint(0, rh - ch)
        rgb_path = os.path.join(
            self.source_root_path, self.manifest["source_data"]["RGB"][source_idx]
        )
        lbl_path = os.path.join(
            self.source_root_path, self.manifest["source_data"]["label"][source_idx]
        )
        rgb = self._load(rgb_path, (rw, rh), (x, y, cw, ch), flip)
        lbl = self._load(lbl_path, (rw, rh), (x, y, cw, ch), flip, is_label=True)
        out = {"rgb": rgb, "label": lbl}
        if self.pl_data_path is not None:
            rel = self.manifest["source_data"]["label"][source_idx]
            rel = rel.split("gtFine/train/")[-1]
            out["pl_data"] = self._load(
                os.path.join(self.pl_data_path, rel), (rw, rh),
                (x, y, cw, ch), flip,
            )
        return out

    def get_rare_class_sample(self):
        c = int(self.np_rng.choice(self.rcs_classes, p=self.rcs_classprob))
        f1 = self.samples_with_class[c][int(self.np_rng.integers(len(self.samples_with_class[c])))]
        i1 = self.file_to_idx[f1]
        s1 = self.get_source_data(i1)
        # converted-id space? reference counts pixels on the *raw* label
        # (convert_label applies later in __getitem__) — same here
        if self.rcs_min_crop_ratio > 0:
            for _ in range(10):
                if (s1["label"] == c).sum() > self.rcs_min_pixels * self.rcs_min_crop_ratio:
                    break
                s1 = self.get_source_data(i1)
        return s1

    # ------------------------------------------------------------ __getitem__
    def __getitem__(self, idx: int) -> Dict:
        source_idx = idx % self.source_data_length
        target_idx = idx % self.target_data_length

        if self.train_or_test == "train":
            src = (
                self.get_rare_class_sample()
                if self.rare_class_sample
                else self.get_source_data(source_idx)
            )
            rh, rw = self.target_resize_h_w
            ch, cw = self.target_crop_size_h_w
            flip = self.rng.random() < 0.5
            x = self.rng.randint(0, rw - cw)
            y = self.rng.randint(0, rh - ch)
            tgt_path = os.path.join(
                self.target_root_path,
                self.manifest["target_data"]["second_modality"][target_idx],
            )
            tgt = self._load(tgt_path, (rw, rh), (x, y, cw, ch), flip)
            out = {
                "source_rgb": src["rgb"],
                "source_label": self._convert_label(src["label"]),
                "target_second_modality": tgt,
                "height": ch,
                "width": cw,
            }
            if self.remove_amp is not None:
                L = self.rng.uniform(self.remove_amp[0], self.remove_amp[1])
                fusion = None
                if self.fda_fusion_val is not None:
                    f = self.fda_fusion_val
                    fusion = self.rng.uniform(f[0], f[1]) if len(f) == 2 else f[0]
                pha = remove_array_amp(src["rgb"].transpose(2, 0, 1), L, fusion)
                tgt_pha = remove_array_amp(tgt.transpose(2, 0, 1), L, fusion)
                # mean-shift the source pha toward the target pha and clip
                # (reference :455-462)
                pha = np.clip(pha + (tgt_pha.mean() - pha.mean()), 0, 255)
                out["source_rgb_pha"] = np.ascontiguousarray(
                    pha.transpose(1, 2, 0)
                ).astype(np.float32)
            if self.pl_data_path is not None:
                out["source_pl_data"] = src["pl_data"]
            if self.remove_texture:
                out["target_second_modality_pha"] = np.ascontiguousarray(
                    extract_edge_info_local(tgt.transpose(2, 0, 1)).transpose(1, 2, 0)
                ).astype(np.float32)
            return out

        # ----------------------------- test branch
        tgt_rel = self.manifest["target_data"]["second_modality"][target_idx]
        lbl_rel = self.manifest["target_data"]["label"][target_idx]
        tgt_path = os.path.join(self.target_root_path, tgt_rel)
        lbl_path = os.path.join(self.target_root_path, lbl_rel)
        resize_wh = (
            (self.test_resize_h_w[1], self.test_resize_h_w[0])
            if self.test_resize_h_w
            else None
        )
        img = self._load(tgt_path, resize_wh)
        out = {
            "target_second_modality": img,
            "file_name": lbl_path,
            "height": img.shape[0],
            "width": img.shape[1],
        }
        if self.test_resize_h_w is not None:
            lbl = self._load(lbl_path, resize_wh, is_label=True)
            out["target_label"] = self._convert_label(lbl)
        words = lbl_rel.split("/")
        if "DELIVER_Depth" in self.json_path:
            out["pred_save_name"] = "_".join(words[-4:])
        elif "DSEC" in self.json_path and len(words) >= 3:
            out["pred_save_name"] = f"{words[-3]}_{words[-1]}"
        else:
            out["pred_save_name"] = words[-1]
        return out
