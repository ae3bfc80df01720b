"""The port's trainer CLI and its I/O layer against the JAX package on CPU:
config files and ``build_train_config``, the dataset and loaders (PIL path),
checkpoints, events, ``do_test``, and ``madm_torch.main.main`` end to end at
the tiny widths of ``tests/test_cli_smoke.py`` with ``--device cpu``; import
hygiene of every ``madm_torch`` module."""

import dataclasses
import json
import logging
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

import madm_tpu.data.native as jax_native
from madm_tpu.config import LazyConfig as JaxLazyConfig
from madm_tpu.config import instantiate as jax_instantiate
from madm_tpu.data import CrossModalityDataset as JaxDataset
from madm_tpu.data import TestLoader as JaxTestLoader
from madm_tpu.data import TrainLoader as JaxTrainLoader
from madm_tpu.data import get_rcs_class_probs as jax_rcs_probs
from madm_tpu.evaluation.evaluator import DSECSemSegEvaluator as JaxEvaluator
from madm_tpu.train.train_step import build_train_config as jax_build_train_config
from madm_torch.checkpoint import BestCheckpointer, Checkpointer, PeriodicCheckpointer
from madm_torch.config import LazyConfig, instantiate
from madm_torch.data import CrossModalityDataset, TrainLoader, get_rcs_class_probs
from madm_torch.data import TestLoader as PortTestLoader
from madm_torch.evaluation.evaluator import DSECSemSegEvaluator
from madm_torch import main as port_main
from madm_torch.main import main
from madm_torch.models.madm import MADMConfig
from madm_torch.parallel import dist as dist_lib
from madm_torch.train.loop import init_train_state, synthetic_batches, train
from madm_torch.train.train_step import TrainConfig, build_train_config
from torch_port_toy import TOY, jax_variables, sure_pixels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
EXPERIMENTS = ("depth_11", "event_11", "infrared_9")
STEP_METRICS = {"source_loss", "vae_decoder_source_loss", "target_loss", "total_loss",
                "pseudo_val", "reg_prob_mean", "grad_norm"}


def _config(package, name):
    return os.path.join(REPO, "madm_torch/configs" if package == "port" else "config_files",
                        f"SemSeg/MTMADISE/mtmadise_cityscapes_rgb_to_{name}.py")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """tests/test_cli_smoke.py's dataset: three 64x96 pairs, two test images;
    plus the rare-class statistics of the source labels."""
    root = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(0)
    train_m = {"source_data": {"RGB": [], "label": []}, "target_data": {"second_modality": []}}
    test_m = {"source_data": {"RGB": [], "label": []},
              "target_data": {"second_modality": [], "label": []}}
    stats = []
    for i in range(3):
        lbl = rng.integers(0, 11, (64, 96), dtype=np.uint8)
        Image.fromarray(rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)).save(root / f"src{i}.png")
        Image.fromarray(lbl).save(root / f"lbl{i}.png")
        Image.fromarray(rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)).save(root / f"tgt{i}.png")
        train_m["source_data"]["RGB"].append(f"src{i}.png")
        train_m["source_data"]["label"].append(f"lbl{i}.png")
        train_m["target_data"]["second_modality"].append(f"tgt{i}.png")
        if i < 2:
            test_m["target_data"]["second_modality"].append(f"tgt{i}.png")
            test_m["target_data"]["label"].append(f"lbl{i}.png")
        stats.append({"file": f"lbl{i}.png", **{str(c): int(n) for c, n in
                                                  enumerate(np.bincount(lbl.ravel() * (1 + i % 2)))
                                                  if n}})
    (root / "train.json").write_text(json.dumps(train_m))
    (root / "test.json").write_text(json.dumps(test_m))
    (root / "sample_class_stats.json").write_text(json.dumps(stats))
    return root


def overrides(data_root, toy=True):
    """tests/test_cli_smoke.py's dot-overrides, with the s0 tap kept at the
    toy widths (the port's train step takes only the shipped s0 branch)."""
    ov = [
        f"dataloader.train.dataset.json_path={str(data_root / 'train.json')!r}",
        f"dataloader.train.dataset.source_root_path={str(data_root)!r}",
        f"dataloader.train.dataset.target_root_path={str(data_root)!r}",
        "dataloader.train.dataset.source_resize_h_w=[64,96]",
        "dataloader.train.dataset.source_crop_size_h_w=[64,64]",
        "dataloader.train.dataset.target_resize_h_w=[64,96]",
        "dataloader.train.dataset.target_crop_size_h_w=[64,64]",
        "dataloader.train.dataset.rare_class_sample=False",
        "dataloader.train.dataset.label_convert=None",
        "dataloader.train.num_workers=0",
        f"dataloader.test.dataset.json_path={str(data_root / 'test.json')!r}",
        f"dataloader.test.dataset.source_root_path={str(data_root)!r}",
        f"dataloader.test.dataset.target_root_path={str(data_root)!r}",
        "dataloader.test.dataset.test_resize_h_w=[64,64]",
        "dataloader.test.num_workers=0",
        "train.log_period=1",
    ]
    if toy:
        ov += ["model.unet_channels=[32,64,128,128]", "model.vae_channels=[32,32,64,64]",
               "model.crop_size=[64,64]", "model.compute_dtype='float32'",
               "model.feature_dims=[3,32,64,128]", "model.projection_dim=[32,32,32,32]",
               "model.remat=False"]
    return ov


def _tree(node):
    """A config tree with targets by name and paths normalised."""
    if isinstance(node, dict):
        return {k: (getattr(v, "__name__", v) if k == "_target_" else _tree(v)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_tree(v) for v in node)
    if isinstance(node, str) and "json_file" in node:
        return os.path.normpath(node)
    return node


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", EXPERIMENTS)
def test_config_files_equal_jax(name, data_root):
    """Each port config, loaded and overridden as tests/test_cli_smoke.py
    does, is the JAX file's tree with madm_torch targets; only train.device
    differs ('cuda' for 'tpu')."""
    extra = ["model.vae_decoder_loss=None", "model.reg_uncertain=False"]
    port = LazyConfig.apply_overrides(LazyConfig.load(_config("port", name)), overrides(data_root) + extra)
    ref = JaxLazyConfig.apply_overrides(JaxLazyConfig.load(_config("jax", name)), overrides(data_root) + extra)
    assert port.model["_target_"].__module__ == "madm_torch.models.build"
    assert ref.model["_target_"].__module__ == "madm_tpu.models.build"
    assert (port.train.pop("device"), ref.train.pop("device")) == ("cuda", "tpu")
    assert _tree(port) == _tree(ref)


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_built_model_and_train_config_equal_jax(name, data_root):
    """build_madm and build_train_config of the same tree give the JAX
    package's MADMConfig fields and TrainConfig values."""
    port = LazyConfig.apply_overrides(LazyConfig.load(_config("port", name)), overrides(data_root))
    ref = JaxLazyConfig.apply_overrides(JaxLazyConfig.load(_config("jax", name)), overrides(data_root))
    _assert_built_equal(port, ref)


# the model-variant flags (one case each) that the CLI once refused
VARIANT_FLAGS = [["--FD_attention", "1.0"], ["--concat_pixel_shuffle"], ["--mask_diff", "rgb=0_Depth=1"],
                 ["--slide_training"], ["--multi_layer_prompt"], ["--target_attention_loss"]]


@pytest.mark.parametrize("flag", VARIANT_FLAGS, ids=lambda f: f[0])
def test_variant_flag_builds_the_model_and_train_config_of_jax(flag, data_root):
    """The flag through each launcher's ``apply_cli_mutations`` (JAX
    ``main.py``'s defaults included: res (16, 32) at 'up' for the attention
    consumers, ``input_channel_plus=1`` for mask_diff), then build_madm and
    build_train_config: the JAX package's MADMConfig fields and TrainConfig
    values."""
    import main as jax_main

    argv = ["--config-file", "x", "--output", "out", *flag]
    port = port_main.apply_cli_mutations(LazyConfig.load(_config("port", "depth_11")),
                                         port_main.build_parser().parse_args(argv))
    ref = jax_main.apply_cli_mutations(JaxLazyConfig.load(_config("jax", "depth_11")),
                                       jax_main.build_parser().parse_args(argv))
    port = LazyConfig.apply_overrides(port, overrides(data_root))
    ref = JaxLazyConfig.apply_overrides(ref, overrides(data_root))
    model = _assert_built_equal(port, ref)
    changed = {"--FD_attention": ("fd_attention", 1.0), "--concat_pixel_shuffle": ("unet_in_channels", 68),
               "--mask_diff": ("input_channel_plus", 1), "--slide_training": ("slide_training", True),
               "--multi_layer_prompt": ("multi_layer_prompt", True),
               "--target_attention_loss": ("attention_features_res", (16, 32))}[flag[0]]
    assert getattr(model.cfg, changed[0]) == changed[1]


def _assert_built_equal(port, ref):
    """build_madm and build_train_config of the port's tree against the JAX
    package's of ``ref``: every MADMConfig field and TrainConfig value;
    returns the port's model."""
    node = dict(port.model, device="cpu")
    model = instantiate(node)
    jmodel = jax_instantiate(ref.model)
    for f in dataclasses.fields(MADMConfig):
        if f.name in ("compute_dtype", "eval_head", "flash_pack"):
            continue
        assert getattr(model.cfg, f.name) == getattr(jmodel.cfg, f.name), f.name
    assert str(model.cfg.compute_dtype).split(".")[-1] == jmodel.cfg.compute_dtype.__name__
    tc, jtc = build_train_config(port), jax_build_train_config(ref, jmodel.cfg)
    optimizer_fields = ("optimizer", "b1", "b2", "eps", "mu_dtype")  # make_optimizer's, not JAX TrainConfig's
    for f in dataclasses.fields(TrainConfig):
        if f.name in ("train_palette", "lr", "weight_decay", "grad_clip", "unet_lr", "schedule",
                      *optimizer_fields):
            continue
        assert getattr(tc, f.name) == getattr(jtc, f.name), f.name
    assert tc.train_palette == tuple(ref.dataloader.evaluator[0].palette) == tuple(jmodel.cfg.train_palette)
    assert (tc.lr, tc.weight_decay, tc.grad_clip) == (5e-6, 0.05, 0.01)
    # as JAX main.py:458-473 hands the optimizer node to make_optimizer
    opt = ref.optimizer
    assert (tc.optimizer, tc.b1, tc.b2, tc.eps, tc.mu_dtype) == (
        opt.get("name", "adamw"), None if opt.get("no_momentum") else opt.get("betas", (0.9, 0.999))[0],
        opt.get("betas", (0.9, 0.999))[1], opt.get("eps", 1e-8), opt.get("mu_dtype"))
    return model


def test_unported_config_values_raise(data_root):
    port = LazyConfig.load(_config("port", "depth_11"))
    for value in ("'learnable_clip'", "'no_learnable_clip'"):
        cfg = LazyConfig.apply_overrides(LazyConfig.load(_config("port", "depth_11")),
                                         [f"model.clip_state={value}"] + overrides(data_root))
        with pytest.raises(NotImplementedError, match="clip_state"):
            instantiate(dict(cfg.model, device="cpu"))
    with pytest.raises(ValueError, match="unknown config keys"):
        instantiate(dict(port.model, device="cpu", not_a_knob=1))


# --------------------------------------------------------------------- data
def _dataset_kwargs(data_root, mode):
    common = dict(json_path=str(data_root / f"{mode}.json"), source_root_path=str(data_root),
                  target_root_path=str(data_root), train_or_test=mode, seed=0,
                  label_convert=[[0, 5], [1, 6], [2, 1], [3, 9]])
    if mode == "train":
        return dict(common, source_resize_h_w=[64, 96], source_crop_size_h_w=[48, 64],
                    target_resize_h_w=[60, 80], target_crop_size_h_w=[48, 64])
    return dict(common, test_resize_h_w=[48, 80])


def _same_sample(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("mode", ["train", "test"])
def test_dataset_and_loaders_equal_jax(mode, data_root, monkeypatch):
    """The PIL path (the JAX decoder forced off): the same samples for the
    same seed, and the first 4 loader batches."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    port, ref = CrossModalityDataset(**_dataset_kwargs(data_root, mode)), JaxDataset(**_dataset_kwargs(data_root, mode))
    assert len(port) == len(ref)
    for i in range(len(port)):
        _same_sample(port[i], ref[i])
    if mode == "train":
        loaders = (TrainLoader(CrossModalityDataset(**_dataset_kwargs(data_root, mode)), 2, seed=3),
                   JaxTrainLoader(JaxDataset(**_dataset_kwargs(data_root, mode)), 2, seed=3))
        its = [iter(x) for x in loaders]
        for _ in range(4):
            _same_sample(next(its[0]), next(its[1]))
    else:
        for a, b in zip(PortTestLoader(port), JaxTestLoader(ref)):
            _same_sample(a, b)


def test_rcs_class_probs_equal_jax(data_root):
    for temp in (0.01, 0.5):
        classes, probs = get_rcs_class_probs(str(data_root), temp)
        jclasses, jprobs = jax_rcs_probs(str(data_root), temp)
        assert classes == jclasses
        np.testing.assert_array_equal(probs, jprobs)


def test_unported_dataset_ablations_raise(data_root):
    """Every dataset ablation is ported (``tests/test_torch_ablation_cli.py``);
    the one combination the JAX dataset refuses, remove_amp with
    remove_texture, raises in both."""
    for cls in (CrossModalityDataset, JaxDataset):
        with pytest.raises(AssertionError):
            cls(**_dataset_kwargs(data_root, "train"), remove_amp=[0.01, 0.1], remove_texture=True)


# -------------------------------------------------------------- checkpoints
@pytest.fixture(scope="module")
def trained_state():
    tc = TrainConfig()
    state = init_train_state(MADMConfig(**TOY, compute_dtype=torch.float32), tc, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    train(state, synthetic_batches(1, (64, 64), 11, gen), steps=1, generator=gen)
    return state


def test_checkpoint_round_trip(trained_state, tmp_path):
    """Save, then load into a state built from another seed: the model
    (student, EMA teacher, BN statistics), the AdamW state and the step
    come back exactly; resume_or_load resumes from last_checkpoint."""
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save("model_0000000", trained_state)
    assert ckpt.last_checkpoint() == "model_0000000.pth"
    fresh = init_train_state(trained_state.model.cfg, trained_state.tc, device="cpu", seed=7)
    fresh, resumed = Checkpointer(str(tmp_path)).resume_or_load(fresh, resume=True)
    assert resumed and fresh.step == trained_state.step == 1
    want = trained_state.model.state_dict()
    got = fresh.model.state_dict()
    assert want.keys() == got.keys()
    assert any(k.startswith("ema.") for k in want) and any(k.endswith("running_mean") for k in want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    so, fo = trained_state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert so["param_groups"] == fo["param_groups"] and so["state"].keys() == fo["state"].keys()
    for i, st in so["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(fo["state"][i][k], v, rtol=0, atol=0)


def test_checkpoint_refuses_foreign_files(trained_state, tmp_path):
    """An orbax directory of the JAX package raises (released reference
    ``.pth`` files load: tests/test_torch_loaders.py)."""
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_METADATA").write_text("{}")
    ckpt = Checkpointer(str(tmp_path / "out"))
    with pytest.raises(NotImplementedError, match="orbax"):
        ckpt.resume_or_load(trained_state, init_from=str(orbax), resume=False)


class _Stub:
    """A checkpointer that records saves (the JAX and port periodic/best
    logic run against it)."""

    def __init__(self, root):
        self.root, self.saves = root, []

    def save(self, name, state):
        self.saves.append(name)

    def _path(self, name):
        return os.path.join(self.root, name)


def test_max_to_keep_and_best_behave_as_jax(tmp_path):
    from madm_tpu.checkpoint.checkpointer import BestCheckpointer as JaxBest
    from madm_tpu.checkpoint.checkpointer import PeriodicCheckpointer as JaxPeriodic

    port, ref = _Stub(str(tmp_path)), _Stub(str(tmp_path))
    pp, rp = PeriodicCheckpointer(port, 2, 7, max_to_keep=2), JaxPeriodic(ref, 2, 7, max_to_keep=2)
    for it in range(7):
        pp.step(it, None)
        rp.step(it, None)
        assert pp._kept == rp._kept
    assert port.saves == ref.saves == ["model_0000001", "model_0000003", "model_0000005", "model_0000006"]
    pb, rb = BestCheckpointer(port), JaxBest(ref)
    for m in ({"mIoU": 1.0}, {"mIoU": 0.5}, {}, {"mIoU": 2.0}, {"mIoU": 2.0}):
        assert pb.step(m, None) == rb.step(m, None)
    assert port.saves == ref.saves and port.saves.count("model_best") == 2


def test_periodic_checkpointer_keeps_max_to_keep_files(trained_state, tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    periodic = PeriodicCheckpointer(ckpt, 1, 3, max_to_keep=2)
    for it in range(3):
        periodic.step(it, trained_state)
    assert sorted(os.listdir(tmp_path)) == ["last_checkpoint", "model_0000001.pth", "model_0000002.pth"]
    assert ckpt.last_checkpoint() == "model_0000002.pth"


# ------------------------------------------------------------------- events
def test_events_equal_jax(tmp_path, caplog):
    """EventStorage + JSONWriter + CommonMetricPrinter: the same
    metrics.json lines and printer lines as the JAX package's."""
    from madm_tpu.utils import events as jax_events
    from madm_torch.utils import events as port_events

    lines, logs = {}, {}
    for name, mod in (("port", port_events), ("jax", jax_events)):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            path = tmp_path / f"{name}.json"
            st, w, p = mod.EventStorage(5), mod.JSONWriter(str(path)), mod.CommonMetricPrinter(10)
            for it in range(3):
                st.put_scalars(total_loss=1.0 / (it + 1), source_loss=0.5, lr=1e-6 * it, time=0.25 + it,
                               data_time=0.01)
                w.write(st)
                p.write(st)
                st.step()
            st.put_scalars(**{"eval/mIoU": 12.5})
            w.write(st)
            w.close()
        lines[name] = path.read_text()
        logs[name] = [r.getMessage() for r in caplog.records]
    assert lines["port"] == lines["jax"] and len(lines["port"].splitlines()) == 4
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 3


# ------------------------------------------------------------ CLI end to end
def cli_argv(data_root, out):
    return (["--config-file", _config("port", "event_11"), "--debug", "--bs", "1", "--max_iter", "2",
             "--eval_iter", "2", "--num_chips", "1", "--device", "cpu", "--output", str(out)]
            + overrides(data_root))


@pytest.fixture(scope="module")
def cli_run(data_root, tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("torch_cli_run") / "run"
    state = main(cli_argv(data_root, run_dir))
    return run_dir, state


def test_cli_trains_evaluates_and_checkpoints(cli_run):
    """--debug: 2 iterations, vis at iteration 2, eval and the periodic and
    best checkpoints; metrics.json holds the JAX step's metrics and the eval
    scalars."""
    run_dir, state = cli_run
    assert state.step == 2
    files = {str(p.relative_to(run_dir)) for p in run_dir.rglob("*")}
    assert {"config.yaml", "metrics.json", "last_checkpoint", "model_0000001.pth", "model_best.pth",
            "vis_results/000002_rank0.png", "000002/sem_seg_evaluation.json"} <= files, sorted(files)
    rows = [json.loads(line) for line in (run_dir / "metrics.json").read_text().splitlines()]
    assert [r["iteration"] for r in rows] == [0, 1, 2]
    assert set(rows[0]) == STEP_METRICS | {"iteration", "lr", "time", "data_time"}
    assert "eval/mIoU" in rows[-1] and np.isfinite(rows[-1]["eval/mIoU"])
    assert Image.open(run_dir / "vis_results/000002_rank0.png").size[0] > 0


def test_cli_eval_only_reproduces_the_training_eval(cli_run, data_root, tmp_path):
    run_dir, _ = cli_run
    argv = cli_argv(data_root, tmp_path / "eval")
    ins = argv.index("--output")
    argv[ins:ins] = ["--eval-only", "--init-from", str(run_dir / "model_best.pth")]
    results = main(argv)
    rows = [json.loads(line) for line in (run_dir / "metrics.json").read_text().splitlines()]
    assert {k: float(v) for k, v in results.items()} == {k[5:]: v for k, v in rows[-1].items()
                                                         if k.startswith("eval/")}


@pytest.mark.parametrize("flag", [["--with_clip", "learnable_clip"]])
def test_cli_refuses_unported_flags(flag, data_root, tmp_path):
    argv = cli_argv(data_root, tmp_path)
    ins = argv.index("--output")
    argv[ins:ins] = flag
    with pytest.raises(NotImplementedError, match=flag[0]):
        main(argv)


def test_cli_num_chips_2_on_cpu(data_root, tmp_path):
    """``--num_chips 2 --device cpu``: two gloo ranks take two iterations at
    --bs 2 (one row each) and evaluate; rank 0 alone writes one
    metrics.json (each iteration once), the vis grid and the checkpoints,
    whose optimizer state is whole; ``--eval-only`` from the best one in a
    single process gives the run's eval metrics."""
    argv = cli_argv(data_root, tmp_path / "w2")
    argv[argv.index("--bs") + 1] = "2"
    argv[argv.index("--num_chips") + 1] = "2"
    assert main(argv) is None
    run_dir = tmp_path / "w2"
    files = {str(p.relative_to(run_dir)) for p in run_dir.rglob("*")}
    assert {"config.yaml", "metrics.json", "model_0000001.pth", "model_best.pth",
            "vis_results/000002_rank0.png", "000002/sem_seg_evaluation.json"} <= files, sorted(files)
    assert not any("rank1" in f for f in files)
    rows = [json.loads(line) for line in (run_dir / "metrics.json").read_text().splitlines()]
    assert [r["iteration"] for r in rows] == [0, 1, 2] and all(np.isfinite(r["total_loss"]) for r in rows)
    opt = torch.load(run_dir / "model_0000001.pth", weights_only=True)["optimizer"]
    assert len(opt["state"]) == sum(len(g["params"]) for g in opt["param_groups"]) > 100
    assert all(st["step"] == 2 for st in opt["state"].values())
    ins = argv.index("--output")
    argv2 = argv[:ins] + ["--output", str(tmp_path / "eval"), "--eval-only", "--init-from",
                          str(run_dir / "model_best.pth")] + argv[ins + 2:]
    argv2[argv2.index("--num_chips") + 1] = "1"
    again = main(argv2)
    assert {k: float(v) for k, v in again.items()} == {k[5:]: v for k, v in rows[-1].items()
                                                       if k.startswith("eval/")}


def test_cli_distributed_world_size_1_on_cpu(data_root, tmp_path, monkeypatch):
    """``--distributed`` with a launcher's environment of one rank (gloo on
    the CPU): the collective paths run (ZeRO-1 state, the gradient
    all-reduce, the global BN statistics), the checkpoint holds the whole
    state, the group is left at the end, and ``--eval-only`` from the best
    checkpoint without a group gives the run's eval metrics."""
    import torch.distributed as dist

    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(dist_lib.free_port()), RANK="0",
                     WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    argv = cli_argv(data_root, tmp_path / "run")
    state = main(["--distributed"] + argv)
    assert type(state.optimizer).__name__ == "ZeroRedundancyOptimizer" and state.step == 2
    assert not dist.is_initialized()
    opt = torch.load(tmp_path / "run" / "model_best.pth", weights_only=True)["optimizer"]
    assert len(opt["state"]) == sum(len(g["params"]) for g in opt["param_groups"])
    rows = [json.loads(line) for line in (tmp_path / "run" / "metrics.json").read_text().splitlines()]
    ins = argv.index("--output")
    again = main(argv[:ins] + ["--output", str(tmp_path / "eval"), "--eval-only", "--init-from",
                               str(tmp_path / "run" / "model_best.pth")] + argv[ins + 2:])
    assert {k: float(v) for k, v in again.items()} == {k[5:]: v for k, v in rows[-1].items()
                                                       if k.startswith("eval/")}
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        main(["--distributed"] + argv)


def test_cli_default_device_needs_a_gpu(data_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    argv = cli_argv(data_root, tmp_path)
    i = argv.index("--device")
    del argv[i:i + 2]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)


# -------------------------------------------------------- do_test vs JAX's
def test_do_test_equals_jax(data_root, monkeypatch):
    """Both packages' do_test on the same toy weights (the port's, carried to
    the JAX tree by the converter) and the same test set: the confusion
    matrices agree once the pixels whose top-2 margin is <= 1e-4 are left
    out (the port's fp32 logits match JAX's to ~1e-6)."""
    from main import do_test as jax_do_test
    from madm_torch.main import do_test
    from madm_torch.models.madm import init_random_

    monkeypatch.setattr(jax_native, "available", lambda: False)
    preds = {"port": [], "jax": []}
    for cls, key in ((DSECSemSegEvaluator, "port"), (JaxEvaluator, "jax")):
        orig = cls.process

        def process(self, inputs, pred, _orig=orig, _key=key):
            preds[_key].append((inputs, np.array(pred)))
            _orig(self, inputs, pred)

        monkeypatch.setattr(cls, "process", process)
    args = types.SimpleNamespace(slide_inference=False, eval_with_noise=None, num_chips=1)
    cfg = LazyConfig.apply_overrides(LazyConfig.load(_config("port", "event_11")), overrides(data_root))
    jcfg = JaxLazyConfig.apply_overrides(JaxLazyConfig.load(_config("jax", "event_11")), overrides(data_root))
    out = os.path.dirname(str(data_root))
    cfg.train.output_dir = jcfg.train.output_dir = out
    model = init_random_(instantiate(dict(cfg.model, device="cpu")), torch.Generator().manual_seed(0))
    jmodel = jax_instantiate(jcfg.model)
    variables = jax_variables(model)
    jstate = types.SimpleNamespace(params=variables["params"], ema={}, state=variables["state"],
                                   consts=variables["consts"])
    res = do_test(cfg, model, None, args)
    jres = jax_do_test(jcfg, jmodel, jstate, args)
    assert res.keys() == jres.keys()
    n = len(cfg.dataloader.evaluator[0].stuff_classes)
    conf = {}
    for key in preds:
        conf[key] = np.zeros((n + 1, n + 1), np.int64)
        for inputs, pred in preds[key]:
            logits = model.eval_forward(inputs["target_second_modality"])[0].numpy()
            gt = np.asarray(inputs["target_label"]).copy()
            gt[gt == 255] = n
            sure = sure_pixels(logits)
            assert sure.mean() > 0.9
            conf[key] += np.bincount((n + 1) * pred[sure] + gt[sure], minlength=(n + 1) ** 2).reshape(n + 1, n + 1)
    assert len(preds["port"]) == len(preds["jax"]) == 2
    np.testing.assert_array_equal(conf["port"], conf["jax"])


# ----------------------------------------------------------- import hygiene
def test_madm_torch_imports_no_jax():
    """Every madm_torch module, the port's config files and chip_smoke.py
    import with jax, flax, orbax and madm_tpu blocked, and with safetensors,
    transformers, diffusers and peft (the loaders read their files by
    hand)."""
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "orbax", "optax", "madm_tpu", "safetensors", "transformers",
             "diffusers", "peft"):
    sys.modules[name] = None
import madm_torch
mods = [m.name for m in pkgutil.walk_packages(madm_torch.__path__, "madm_torch.")
        if ".configs" not in m.name]
for m in mods:
    importlib.import_module(m)
import glob
from madm_torch.config import LazyConfig
for f in sorted(glob.glob("madm_torch/configs/SemSeg/**/*.py", recursive=True)):
    LazyConfig.load(f)
import chip_smoke
print(len(mods))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) >= 40
