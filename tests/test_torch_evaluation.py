"""The port's evaluation layer against the JAX package on CPU: the mIoU
evaluator and its RLE encoder, padding, and ``inference_on_dataset`` over a
few labelled samples built in memory."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.evaluation.evaluator import DSECSemSegEvaluator as JaxEvaluator
from madm_tpu.evaluation.evaluator import coco_rle_encode as jax_coco_rle_encode
from madm_tpu.evaluation.inference import inference_on_dataset as jax_inference_on_dataset
from madm_tpu.evaluation.inference import pad_to_divisible as jax_pad_to_divisible
from madm_torch.evaluation import (
    DSECSemSegEvaluator,
    coco_rle_encode,
    inference_on_dataset,
    pad_to_divisible,
)
from torch_port_toy import TOY, sure_pixels, toy_pair

CLASSES = [f"c{i}" for i in range(TOY["num_classes"])]


def _same_results(a, b):
    assert list(a["sem_seg"]) == list(b["sem_seg"])
    for k, v in a["sem_seg"].items():
        w = b["sem_seg"][k]
        assert (np.isnan(v) and np.isnan(w)) or v == w, (k, v, w)


@pytest.mark.parametrize("convert", [None, [(3, 4), (7, 0)]])
def test_evaluator_equals_jax(convert, tmp_path):
    """Same predictions and labels (class 9 never occurs; 255 is ignored):
    the same confusion matrix, metrics and RLE records."""
    rng = np.random.default_rng(0)
    kw = dict(stuff_classes=CLASSES, convert_pred_list=convert, save_predictions_json=True)
    port = DSECSemSegEvaluator(output_dir=str(tmp_path / "port"), **kw)
    ref = JaxEvaluator(output_dir=str(tmp_path / "jax"), **kw)
    for i in range(4):
        pred = rng.integers(0, 11, size=(24, 40)).astype(np.int32)
        gt = rng.choice([0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 255], size=(24, 40)).astype(np.uint8)
        sample = {"target_label": gt if i % 2 else gt[None], "file_name": f"img{i}.png"}
        port.process(sample, pred)
        ref.process(sample, pred)
    np.testing.assert_array_equal(port._conf_matrix, ref._conf_matrix)
    assert port._predictions == ref._predictions
    _same_results(port.evaluate(), ref.evaluate())
    assert (tmp_path / "port" / "sem_seg_evaluation.json").read_text() == \
        (tmp_path / "jax" / "sem_seg_evaluation.json").read_text()
    assert port.eval_index == 4


def test_coco_rle_encode_equals_jax():
    rng = np.random.default_rng(1)
    masks = [rng.random((17, 23)) < p for p in (0.05, 0.5, 0.95)]
    masks += [np.zeros((5, 7), bool), np.ones((5, 7), bool)]
    masks[0][0, 0] = True  # a run of ones first
    for m in masks:
        assert coco_rle_encode(m) == jax_coco_rle_encode(m)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80), (65, 127)])
def test_pad_to_divisible_equals_jax(hw):
    img = np.random.default_rng(2).uniform(size=(2, *hw, 3)).astype(np.float32)
    out, size = pad_to_divisible(torch.from_numpy(img))
    ref, ref_size = jax_pad_to_divisible(jnp.asarray(img))
    assert size == ref_size == hw
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


class _Recording:
    """An evaluator's ``process`` that also keeps every prediction."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.preds = []

    def process(self, inputs, pred):
        self.preds.append(np.array(pred))
        super().process(inputs, pred)


class Recording(_Recording, DSECSemSegEvaluator):
    pass


class JaxRecording(_Recording, JaxEvaluator):
    pass


@pytest.fixture(scope="module")
def dataset_run():
    """Three labelled 64x64 samples, as the test loader gives them, through
    the port's and JAX's ``inference_on_dataset`` at batch 2 (the second
    group is the third sample padded by repetition)."""
    port, jm, variables = toy_pair()
    rng = np.random.default_rng(5)
    samples = [{"target_second_modality": rng.uniform(size=(1, 64, 64, 3)).astype(np.float32),
                "target_label": rng.integers(0, 11, size=(64, 64)).astype(np.int32)}
               for _ in range(3)]
    samples[1]["target_label"][:8] = 255
    ev = Recording(stuff_classes=CLASSES)
    res = inference_on_dataset(port, samples, ev, batch=2)
    jev = JaxRecording(stuff_classes=CLASSES)
    jres = jax_inference_on_dataset(jm, variables, samples, jev, batch=2)
    return port, samples, ev, res, jev, jres


def test_inference_on_dataset_evaluates_every_sample_once(dataset_run):
    port, samples, ev, res, _, _ = dataset_run
    assert ev.eval_index == 3 and len(ev.preds) == 3
    for s, pred in zip(samples, ev.preds):
        np.testing.assert_array_equal(pred, port.eval_forward_ids(s["target_second_modality"])[0].numpy())
    for k in ("mIoU", "fwIoU", "mACC", "pACC"):
        assert np.isfinite(res["sem_seg"][k])


def test_inference_on_dataset_matches_jax(dataset_run):
    """The same loader through the JAX package's loop: predictions equal where the
    fp32 top-2 margin settles the argmax."""
    port, samples, ev, _, jev, _ = dataset_run
    assert jev.eval_index == 3
    for s, pred, ref in zip(samples, ev.preds, jev.preds):
        sure = sure_pixels(port.eval_forward(s["target_second_modality"])[0].numpy())
        assert sure.mean() > 0.9
        np.testing.assert_array_equal(pred[sure], ref[sure])


def test_slide_inference_on_dataset(dataset_run):
    """``slide_inference`` over 64x128 samples gives the slide eval's ids."""
    from madm_torch.evaluation import make_slide_eval_fn

    port = dataset_run[0]
    rng = np.random.default_rng(6)
    wide = [{"target_second_modality": rng.uniform(size=(1, 64, 128, 3)).astype(np.float32),
             "target_label": rng.integers(0, 11, size=(64, 128)).astype(np.int32)} for _ in range(2)]
    ev = Recording(stuff_classes=CLASSES)
    res = inference_on_dataset(port, wide, ev, slide_inference=True, eval_with_noise=900)
    assert ev.eval_index == 2 and 0.0 <= res["sem_seg"]["pACC"] <= 100.0
    fn = make_slide_eval_fn(port, eval_with_noise=900)
    for s, pred in zip(wide, ev.preds):
        np.testing.assert_array_equal(pred, fn(s["target_second_modality"])[0].numpy())
