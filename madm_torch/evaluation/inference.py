"""Eval functions: single-crop and sliding-window eval, and the loop over a
test set (port of ``madm_tpu/evaluation/inference.py``).

Reference behaviour reproduced:

- ``inference_on_dataset`` (``evaluation/evaluator.py:14-133``): the eval
  loop with warm-up-aware data / compute timing, feeding the evaluator one
  image at a time.
- the sliding window (``feature_extractor.py:199-278``): three 512x512 crops
  over a 512x1024 image, (0,512,0,512), (0,512,256,768), (0,512,512,1024);
  features added into full-size canvases and divided by the overlap counts,
  then the head once on the stitched features.

The eval functions are plain closures over the model (PyTorch runs eagerly);
they take NHWC images in [0, 1] on any device and return ids on the model's.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

logger = logging.getLogger(__name__)

SLIDE_WINDOWS = ((0, 512, 0, 512), (0, 512, 256, 768), (0, 512, 512, 1024))


def pad_to_divisible(img: torch.Tensor, divisor: int = 64):
    """Zero-pad NHWC to multiples of ``divisor`` (reference
    ``ImageList.from_tensors``); returns (padded, (h, w))."""
    h, w = img.shape[1:3]
    ph = (divisor - h % divisor) % divisor
    pw = (divisor - w % divisor) % divisor
    if ph or pw:
        img = F.pad(img, (0, 0, 0, pw, 0, ph))
    return img, (h, w)


def make_eval_fn(model, eval_with_noise: Optional[int] = None,
                 lora_name: Optional[str] = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Single-crop eval: [B, H, W, 3] in [0, 1] -> argmax ids [B, H, W],
    through the model's eval head (``MADMConfig.eval_head``), with adapter
    ``lora_name`` merged."""

    def eval_fn(images: torch.Tensor) -> torch.Tensor:
        padded, (h, w) = pad_to_divisible(torch.as_tensor(images, device=model.device))
        return model.eval_forward_ids(padded, eval_with_noise=eval_with_noise,
                                      lora_name=lora_name)[:, :h, :w]

    return eval_fn


def make_slide_eval_fn(model, windows=None, eval_with_noise: Optional[int] = None,
                       form: str = "batch", lora_name: Optional[str] = None,
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Sliding-window eval of [B, H, W, 3] images (512x1024 in the
    reference): windows from the image size unless given, ``eval_with_noise``
    (``mtmadise.py:681-682``) and adapter ``lora_name`` for every window, the
    stitched features through one pass of the model's eval head; ``form`` as
    in ``MADM.slide_backbone_forward`` ('batch', the faster on the card)."""

    def eval_fn(images: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(images, device=model.device)
        t = None if eval_with_noise is None else torch.full((x.shape[0],), int(eval_with_noise),
                                                            device=model.device)
        stitched = model.slide_backbone_forward(x, windows=windows, timesteps=t, form=form,
                                                lora_name=lora_name)["output_features"]
        return model.head_ids(stitched, x.shape[1:3])

    return eval_fn


def inference_on_dataset(model, loader, evaluator, slide_inference: bool = False,
                         eval_with_noise: Optional[int] = None, warmup: int = 2,
                         batch: int = 1, lora_name: Optional[str] = None) -> Dict:
    """Run eval over a test loader (any iterable of sample dicts with
    ``target_second_modality`` [1, H, W, 3] in [0, 1] and a label, and a
    length), feed the evaluator, return its metrics.

    ``lora_name``: the adapter every pass merges (``do_test``: the target
    modality's when the model has adapters).  Images go in groups of
    ``batch``; the last group is padded by repeating its last image, and the
    padding's predictions are thrown away.  Group
    i+1 is dispatched before group i's predictions are fetched, so that the
    host's work overlaps the card's (CUDA runs asynchronously; the copy to
    the host is the sync point).  Logs the data / compute split per group
    after ``warmup`` groups, like the reference's loop
    (``evaluation/evaluator.py:56-132``)."""
    group = max(1, batch)
    if slide_inference:
        eval_fn = make_slide_eval_fn(model, eval_with_noise=eval_with_noise, lora_name=lora_name)
    else:
        eval_fn = make_eval_fn(model, eval_with_noise, lora_name)
    evaluator.reset()
    total = len(loader)
    n_groups = (total + group - 1) // group

    def dispatch(samples):
        imgs = np.concatenate([s["target_second_modality"] for s in samples], axis=0)
        if imgs.shape[0] < group:  # pad the tail group by repetition
            imgs = np.concatenate([imgs] + [imgs[-1:]] * (group - imgs.shape[0]), axis=0)
        x = torch.from_numpy(np.ascontiguousarray(imgs, dtype=np.float32))
        if model.device.type == "cuda":
            x = x.pin_memory()  # an asynchronous copy: the host goes on
        return eval_fn(x.to(model.device, non_blocking=True))

    def drain(pending):
        samples, dev_pred = pending
        preds = dev_pred.cpu().numpy()
        for j, s in enumerate(samples):
            evaluator.process(s, preds[j])

    t_data = t_compute = 0.0
    last = time.perf_counter()
    pending = None  # (samples, predictions on the device)
    it = iter(loader)
    for gi in range(1, n_groups + 1):
        buf = []
        while len(buf) < group:
            try:
                buf.append(next(it))
            except StopIteration:
                break
        now = time.perf_counter()
        t_data += now - last
        dev_pred = dispatch(buf)
        if pending is not None:
            drain(pending)
        pending = (buf, dev_pred)
        t_compute += time.perf_counter() - now
        last = time.perf_counter()
        if gi == warmup:  # leave the first groups' set-up out of the steady-state times
            t_data = t_compute = 0.0
        if gi % 100 == 0 or gi == n_groups:
            done = gi - warmup
            if done > 0:
                eta = (n_groups - gi) * (t_compute + t_data) / done
                logger.info(f"inference {gi * group}/{total} "
                            f"compute {t_compute / done:.3f}s/group({group}) "
                            f"data {t_data / done:.3f}s/group eta {eta:.0f}s")
    if pending is not None:
        drain(pending)
    return evaluator.evaluate()
