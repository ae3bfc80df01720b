"""The port's data parallelism (``madm_torch.parallel``) on the CPU over gloo
at world size 2, in spawned processes (``run_ranks``): two toy steps at
world 2, B=1 a rank, each from the state of a single-process step at B=2,
against those steps (losses, grad_norm, gradients, the optimizer state
consolidated on rank 0, the parameters, the head's BN statistics; with
``pseudo_weight_scope='batch'`` too), the parameters bit-identical across
ranks, a ZeRO-1 checkpoint moving between world sizes, the loaders' shards
and ``inference_on_dataset``'s.

The spawned ranks import this module and ``chip_smoke`` by name, so neither
imports JAX (the conftest's JAX set-up must not run in them)."""

import copy
import shutil

import numpy as np
import pytest
import torch

from chip_smoke import SEG_SCALE, TOY, compare, same_on_ranks, steps_on_rows
from madm_torch.checkpoint import Checkpointer
from madm_torch.data import build_d2_test_dataloader, build_d2_train_dataloader
from madm_torch.evaluation import DSECSemSegEvaluator, inference_on_dataset
from madm_torch.models.madm import MADM, init_random_, trainable_parameters
from madm_torch.parallel import dist as dist_lib
from madm_torch.train.loop import init_train_state, synthetic_batches, train
from madm_torch.train.train_step import TrainConfig, sample_draws

CPUS = ["cpu", "cpu"]
# World 2 against world 1 on the same CPU, each step from one state: the
# head's BN takes its statistics from all-reduced sums instead of
# F.batch_norm, and the gradients are the mean of two half-batch gradients;
# fp32 rounding moves, and a ReLU whose input sits within it of 0 flips on
# one side only.  The tolerances are chip_smoke.py phase 6's (CUDA against
# CPU at the same toy): losses and grad_norm 1e-4 relative, the clipped
# gradients 2e-3 of the largest entry; BN statistics 1e-5 of the largest
# (tests/test_torch_train.py's, port against JAX); the weights and the
# optimizer state on AdamW's rule applied to the one process's state with
# the rank's gradient, to within fp32 rounding (``compare``).
RTOL, GRAD_OF_MAX, BN_OF_MAX = 1e-4, 2e-3, 1e-5


@pytest.fixture(autouse=True)
def remove_tmp_path(request):
    """Each test's ``tmp_path`` (checkpoints) removed at its teardown."""
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module", params=["sample", "batch"])
def world2(request, tmp_path_factory):
    tc = TrainConfig(pseudo_weight_scope=request.param)
    args = (tc, 2, 0, "cpu")
    ref = steps_on_rows(*args)
    path = tmp_path_factory.mktemp("starts") / "starts.pt"
    torch.save(ref["starts"], path)
    ranks = dist_lib.run_ranks(steps_on_rows, 2, CPUS, args=args + (str(path),))
    shutil.rmtree(path.parent, ignore_errors=True)
    return tc, ref, ranks


def test_world2_steps_equal_the_b2_steps(world2):
    _, ref, ranks = world2
    assert [r["rank"] for r in ranks] == [0, 1] and ranks[0]["world"] == 2 and ref["world"] == 1
    assert all(0.0 < m["pseudo_val"] < 1.0 for m in ref["metrics"])  # pseudo-weighted terms live
    err = compare(ref, ranks[0])
    assert err["loss_rel"] <= RTOL, err
    assert err["grad_of_max"] <= GRAD_OF_MAX, err
    assert err["off_rule"] <= 1.0 and err["off_rule_ref"] <= 1.0 and not err["faults"], err
    assert set(err["state_of_max"]) == {"exp_avg", "exp_avg_sq"}, err
    assert err["bn_of_max"] <= BN_OF_MAX, err
    assert ranks[0]["metrics"] == ranks[1]["metrics"]  # means over the ranks


def test_world2_parameters_bit_identical_across_ranks(world2):
    _, _, ranks = world2
    assert [e["names"] for e in ranks[0]["ends"]] == [e["names"] for e in ranks[1]["ends"]]
    assert same_on_ranks(ranks)
    assert ranks[1]["ends"][0]["opt"] is None  # consolidated on rank 0 alone


def test_compare_catches_a_state_off_its_rule(world2):
    """The rule check is not vacuous: rank 0's consolidated second moment
    of one tensor, or one weight, moved by 1e-3 of itself, is found."""
    _, ref, ranks = world2
    for key in ("exp_avg_sq", "params"):
        bad = copy.deepcopy(ranks[0])
        end = bad["ends"][-1]
        i = max(range(len(end["params"])), key=lambda j: end["params"][j].numel())
        if key == "params":
            end["params"][i].mul_(1 + 1e-3)
        else:
            end["opt"]["state"][i][key].mul_(1 + 1e-3)
        err = compare(ref, bad)
        assert err["off_rule"] > 1.0 and end["names"][i] in " ".join(err["faults"]), (key, err)


# ---------------------------------------------------- ZeRO-1 checkpoints
def _state(seed=0):
    state = init_train_state(TOY, TrainConfig(), device="cpu", seed=seed)
    with torch.no_grad():
        for head in (state.model.sem_seg_head, state.model.ema["sem_seg_head"]):
            head.conv_seg.weight.mul_(SEG_SCALE)
    return state


def _stream(state, skip):
    """The generator and batches a run of ``train`` reads, advanced past
    the first ``skip`` steps' batches and draws (a resumed run's inputs)."""
    gen = torch.Generator().manual_seed(1)
    batches = synthetic_batches(2, TOY.crop_size, TOY.num_classes, gen)
    for _ in range(skip):
        labels = next(batches)["source_label"][dist_lib.local_rows(2)]
        sample_draws(gen, state.tc, labels, TOY.num_classes, state.model.sem_seg_head, TOY)
    return gen, batches


def _snapshot(state):
    """The trained parameters, their gradients (where a step left them) and
    every buffer (BN statistics, the EMA head's too)."""
    named = trainable_parameters(state.model)
    return {"params": {n: p.detach().clone() for n, p in named},
            "grads": {n: p.grad.detach().clone() for n, p in named if p.grad is not None},
            "buffers": {n: b.clone() for n, b in state.model.named_buffers()}}


def _resume_at_world2(path_in, dir_out):
    """A rank: load the world-1 checkpoint of step 1, take step 2, save."""
    state = _state()
    Checkpointer(dir_out).load(path_in, state)
    gen, batches = _stream(state, 1)
    metrics = train(state, batches, 1, gen)[0]
    Checkpointer(dir_out).save("model_0000001", state)
    return {"metrics": metrics, "sharded": dist_lib.is_sharded(state.optimizer), **_snapshot(state)}


def test_zero1_checkpoint_moves_between_world_sizes(tmp_path):
    """World 1 takes steps 1-3 and saves after step 1; world 2 resumes that
    checkpoint for step 2 with ZeRO-1 and saves; world 1 resumes that one
    for step 3.  Each resumed step equals the uninterrupted run's."""
    ref = _state()
    gen, batches = _stream(ref, 0)
    ref_metrics = [train(ref, batches, 1, gen)[0]]
    Checkpointer(str(tmp_path / "w1")).save("model_0000000", ref)
    ref_metrics += train(ref, batches, 2, gen)
    ranks = dist_lib.run_ranks(_resume_at_world2, 2, CPUS,
                               args=(str(tmp_path / "w1" / "model_0000000.pth"), str(tmp_path / "w2")))
    assert all(r["sharded"] for r in ranks)
    saved = torch.load(tmp_path / "w2" / "model_0000001.pth", weights_only=True)
    n_trained = len(trainable_parameters(ref.model))
    assert saved["step"] == 2 and len(saved["optimizer"]["state"]) == n_trained  # every shard

    resumed = _state(seed=1)  # other weights: the checkpoint must overwrite them all
    Checkpointer(str(tmp_path / "w2")).load("model_0000001.pth", resumed)
    got = _snapshot(resumed)
    for n, p in got["params"].items():  # the ranks' state, bit for bit
        assert torch.equal(p, ranks[0]["params"][n]), n
    for n, b in got["buffers"].items():
        assert torch.equal(b, ranks[0]["buffers"][n]), n
    st = resumed.optimizer.state
    assert all(st[p]["step"] == 2 and st[p]["exp_avg"].dtype == torch.float32
               for _, p in trainable_parameters(resumed.model))
    gen, batches = _stream(resumed, 2)
    step3 = train(resumed, batches, 1, gen)[0]
    for got_m, ref_m in ((ranks[0]["metrics"], ref_metrics[1]), (step3, ref_metrics[2])):
        for k, v in ref_m.items():
            if k != "step_ms":
                assert abs(got_m[k] - v) <= RTOL * max(abs(v), 1e-3), (k, got_m[k], v)
    ref_g, got_g = _snapshot(ref)["grads"], _snapshot(resumed)["grads"]
    gmax = max(g.abs().max().item() for g in ref_g.values())
    assert max((got_g[n] - g).abs().max().item() for n, g in ref_g.items()) <= GRAD_OF_MAX * gmax


# ------------------------------------------------------- loaders and eval
class _Indexed:
    """n samples whose pixels hold their index."""

    def __init__(self, n, h=8, w=8):
        self.n, self.h, self.w = n, h, w

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        img = np.full((self.h, self.w, 3), i, np.uint8)
        return {"source_rgb": img, "source_label": np.full((self.h, self.w), i, np.int32),
                "target_second_modality": img, "index": i}


def _shards(n_train, n_test, total_batch, batches):
    train_loader = build_d2_train_dataloader(_Indexed(n_train), total_batch, seed=3)
    it = iter(train_loader)
    seen = []
    for _ in range(batches):
        seen += [int(lbl[0, 0]) for lbl in next(it)["source_label"]]
    return {"train": seen, "test": [s["index"] for s in build_d2_test_dataloader(_Indexed(n_test))]}


def test_loader_shards_disjoint_and_covering():
    """Train: rank r reads positions r, r+2, ... of the one permutation the
    single process reads (one epoch of 10 samples at a global batch of 2:
    each rank 5 batches of 1); test: contiguous blocks of 11 samples."""
    ranks = dist_lib.run_ranks(_shards, 2, CPUS, args=(10, 11, 2, 5))
    alone = _shards(10, 11, 2, 5)  # 5 batches of 2
    order = alone["train"]
    assert sorted(order) == list(range(10))
    assert ranks[0]["train"] == order[0::2] and ranks[1]["train"] == order[1::2]
    assert ranks[0]["test"] == list(range(6)) and ranks[1]["test"] == list(range(6, 11))
    assert alone["test"] == list(range(11))


class _Recording(DSECSemSegEvaluator):
    """An evaluator that also records which samples it saw."""

    def reset(self):
        super().reset()
        self.seen = []

    def process(self, inputs, pred):
        super().process(inputs, pred)
        self.seen.append(int(inputs["index"]))


class _Labelled(_Indexed):
    """11 random 64x64 images with random labels (255 ignored in places)."""

    def __getitem__(self, i):
        rng = np.random.default_rng(100 + i)
        lbl = rng.integers(0, 11, (self.h, self.w)).astype(np.int32)
        lbl[:4, :6] = 255
        return {"target_second_modality": rng.integers(0, 256, (self.h, self.w, 3), dtype=np.uint8),
                "target_label": lbl, "index": i}


def _evaluate(out_dir):
    model = init_random_(MADM(TOY, device="cpu"), torch.Generator().manual_seed(0))
    loader = build_d2_test_dataloader(_Labelled(11, 64, 64))
    ev = _Recording(stuff_classes=[str(c) for c in range(11)], output_dir=out_dir,
                    save_predictions_json=True)
    results = inference_on_dataset(model, loader, ev, batch=2)
    return {"seen": ev.seen, "results": dict(results["sem_seg"])}


def test_inference_on_dataset_world2_equals_world1(tmp_path):
    """Each sample once across the ranks, the metrics of one process, and
    rank 0 alone writing the results and every rank's predictions."""
    ranks = dist_lib.run_ranks(_evaluate, 2, CPUS, args=(str(tmp_path / "w2"),))
    alone = _evaluate(str(tmp_path / "w1"))
    assert ranks[0]["seen"] + ranks[1]["seen"] == alone["seen"] == list(range(11))
    assert ranks[0]["results"] == ranks[1]["results"] == alone["results"]
    assert 0.0 < alone["results"]["pACC"] < 100.0
    for name in ("sem_seg_evaluation.json", "sem_seg_predictions.json"):
        assert (tmp_path / "w2" / name).read_text() == (tmp_path / "w1" / name).read_text(), name
    assert sorted(p.name for p in (tmp_path / "w2").iterdir()) == ["sem_seg_evaluation.json",
                                                                    "sem_seg_predictions.json"]


def test_inference_refuses_a_loader_of_another_world():
    model = MADM(TOY, device="cpu")
    loader = build_d2_test_dataloader(_Labelled(3, 64, 64))
    loader.shard_index, loader.num_shards = 1, 2
    with pytest.raises(ValueError, match="shard"):
        inference_on_dataset(model, loader, _Recording(stuff_classes=["a"]))


def _rows_of(batches):
    out = []
    for b in batches:
        try:
            out.append(dist_lib.local_rows(b))
        except ValueError as e:
            out.append(str(e))
    return out


def test_local_rows_are_contiguous_blocks():
    """``shard_batch``'s placement: rank r's rows [r B/R, (r+1) B/R); a
    global batch that does not divide raises."""
    r0, r1 = dist_lib.run_ranks(_rows_of, 2, CPUS, args=((4, 3),))
    assert r0[0] == slice(0, 2) and r1[0] == slice(2, 4)
    assert "does not divide" in r0[1] and "does not divide" in r1[1]
    assert _rows_of((3,)) == [slice(0, 3)]
