"""The ablation flags through the port's I/O layers against the JAX package
on CPU: the dataset's new keys (``remove_amp`` with ``fda_fusion_val``,
``remove_texture``, ``pl_data_path``, ``merge_more_target_data``) and the
loader's batches on PNGs the test writes; each newly ported CLI flag's
change to the config tree against the JAX launcher's; each flag still
unported raising with its ROADMAP section; and ``madm_torch.main.main``
end to end with the ported flags, in four runs that respect the exclusive
MIC loss slot."""

import copy
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import madm_tpu.data.native as jax_native
import main as jax_main
from madm_tpu.config import LazyConfig as JaxLazyConfig
from madm_tpu.data import CrossModalityDataset as JaxDataset
from madm_tpu.data import TrainLoader as JaxTrainLoader
from madm_torch import main as port_main
from madm_torch.config import LazyConfig, instantiate
from madm_torch.data import CrossModalityDataset, TrainLoader
from madm_torch.train.train_step import build_train_config
from test_torch_cli import _config, _dataset_kwargs, _same_sample, cli_argv, data_root, overrides  # noqa: F401

# ------------------------------------------------------------------ dataset


@pytest.fixture(scope="module")
def ablation_root(data_root):
    """``data_root`` plus stage-1 pl data beside the source labels' names
    and an extra target subdirectory."""
    rng = np.random.default_rng(1)
    (data_root / "pl").mkdir()
    (data_root / "extra").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)).save(data_root / "pl" / f"lbl{i}.png")
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)).save(data_root / "extra" / f"x{i}.png")
    return data_root


ABLATIONS = {
    "remove_amp_band": dict(remove_amp=[0.01, 0.1], fda_fusion_val=[0.2, 0.8]),
    "remove_amp_fixed": dict(remove_amp=[0.05, 0.05], fda_fusion_val=[0.5]),
    "remove_amp_flat": dict(remove_amp=[0.02, 0.06]),
    "remove_texture": dict(remove_texture=True),
    "pl_data_more_targets": dict(pl_data_path="pl", merge_more_target_data="extra"),
}


def _kwargs(root, name):
    kw = dict(ABLATIONS[name])
    if "pl_data_path" in kw:
        kw["pl_data_path"] = str(root / kw["pl_data_path"])
    return kw


@pytest.mark.parametrize("name", list(ABLATIONS))
def test_dataset_ablation_keys_equal_jax(name, ablation_root, monkeypatch):
    """The PIL path: the same samples, the new keys among them, for the same
    seed; and the first loader batches, the new keys stacked in [0, 1]."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    kw = _kwargs(ablation_root, name)
    base = _dataset_kwargs(ablation_root, "train")
    port, ref = CrossModalityDataset(**base, **kw), JaxDataset(**base, **kw)
    assert len(port) == len(ref)
    for i in range(len(port)):
        sample = port[i]
        _same_sample(sample, ref[i])
    new = {"source_rgb_pha", "target_second_modality_pha", "source_pl_data"} & set(sample)
    assert new
    loaders = (TrainLoader(CrossModalityDataset(**base, **kw), 2, seed=3),
               JaxTrainLoader(JaxDataset(**base, **kw), 2, seed=3))
    its = [iter(x) for x in loaders]
    for _ in range(2):
        a, b = next(its[0]), next(its[1])
        _same_sample(a, b)
        assert new <= set(a) and all(0.0 <= a[k].min() and a[k].max() <= 1.0 for k in new)


def test_test_set_takes_fda_fusion_val(ablation_root, monkeypatch):
    """``--fda_fusion_val`` reaches the test set too (JAX ``main.py:334-336``),
    which keeps it and emits the same samples."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    base = _dataset_kwargs(ablation_root, "test")
    port, ref = (cls(**base, fda_fusion_val=[0.5]) for cls in (CrossModalityDataset, JaxDataset))
    for i in range(len(port)):
        _same_sample(port[i], ref[i])


# ---------------------------------------------------------------- CLI flags
PORTED_FLAGS = [
    ["--disable_mixup"], ["--pl_crop"], ["--MIC"], ["--mask_ratio", "0.5"], ["--MIC_reg", "1.0"],
    ["--MIC_reg_wo_pl_val"], ["--FD", "0.5"], ["--noise_reg", "1.0"], ["--reg_target_palette", "discrete"],
    ["--denoise_supervise", "1.0"], ["--denoise_interval", "3"], ["--mask_prompt_ratio", "0.5"],
    ["--detach_mask_prompt"], ["--prompt_perturbation", "0.1"], ["--prompt_confidence", "0.5"],
    ["--rand_prompt_scale", "0.3"], ["--prompt_seq_len", "40"], ["--remove_texture"],
    ["--remove_amp", "0.01", "0.1"], ["--fda_fusion_val", "0.5"], ["--merge_with_pl_data", "linear_mix-0.3"],
    ["--merge_with_pl_data", "random_choice"], ["--pl_data_path", "pl"],
    ["--merge_more_target_data", "extra"], ["--finetune_without_cross_attention"], ["--finetune_no"],
    ["--add_latent_noise", "0.2"], ["--norm_latent_noise"], ["--ema_w_unet"], ["--unet_lr", "1e-5"],
    ["--warmup_lr"], ["--vae_decoder_loss_type", "L2"],
    # the model variants (the concat slot with the capture that it needs)
    ["--enable_sem_seg_head_sec_modal"], ["--slide_training"], ["--final_fuse_vae_decoder_feat"],
    ["--without_prompt"], ["--without_prompt_alpha"], ["--multi_layer_prompt"], ["--target_attention_loss"],
    ["--attention_select_index", *map(str, range(1, 12))], ["--FD_attention", "0.5"],
    ["--concat_corss_attention_feat_to_conv_seg", "--target_attention_loss", "--attention_select_index",
     *map(str, range(1, 12))],
    ["--without_vae_encoder_feat"], ["--baseline_wo_encoder_feat"], ["--single_scale_decoder"],
    ["--concat_pixel_shuffle"], ["--mask_diff", "rgb=0_Depth=1"],
]
# the toy widths of tests/test_torch_cli.py's overrides, a scale each
TOY_FEATURE_DIMS = {"s0": 3, "s3": 32, "s4": 64, "s5": 128}


def _flat(node, prefix=""):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k != "_target_":
                out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: list(node) if isinstance(node, tuple) else node}


def _changes(load, parser, mutate, flag, root):
    cfg = load()
    before = _flat(copy.deepcopy(dict(cfg)))
    args = parser.parse_args(["--config-file", "x", "--output", str(root / "out"), *flag])
    after = _flat(dict(mutate(cfg, args)))
    return {k: v for k, v in after.items() if before.get(k, "<absent>") != v and k != "train.output_dir"}


@pytest.mark.parametrize("flag", PORTED_FLAGS, ids=lambda f: "_".join(f))
def test_ported_flag_changes_the_config_as_jax(flag, data_root):
    """The flag's change to the loaded config tree equals the JAX launcher's
    (``apply_cli_mutations``); the port refuses nothing of it, and builds
    the model and the TrainConfig from the changed tree at toy width."""
    port_parser, jax_parser = port_main.build_parser(), jax_main.build_parser()
    port_main.refuse_unported(port_parser.parse_args(["--config-file", "x", *flag]), port_parser)
    port = _changes(lambda: LazyConfig.load(_config("port", "depth_11")), port_parser,
                    port_main.apply_cli_mutations, flag, data_root)
    ref = _changes(lambda: JaxLazyConfig.load(_config("jax", "depth_11")), jax_parser,
                   jax_main.apply_cli_mutations, flag, data_root)
    assert port and port == ref
    cfg = port_main.apply_cli_mutations(LazyConfig.load(_config("port", "depth_11")),
                                        port_parser.parse_args(["--config-file", "x", *flag]))
    # the toy widths of the scales the flags leave (the scale rewrites drop some)
    scales = list(cfg.model.out_features)
    toy = [o for o in overrides(data_root) if not o.startswith(("model.feature_dims", "model.projection_dim"))]
    toy += [f"model.feature_dims={[TOY_FEATURE_DIMS[k] for k in scales]}",
            f"model.projection_dim={[32] * len(scales)}"]
    cfg = LazyConfig.apply_overrides(cfg, toy)
    model = instantiate(dict(cfg.model, device="cpu"))
    tc = build_train_config(cfg)
    for key, value in port.items():
        if key in ("model.feature_dims", "model.projection_dim"):  # the toy widths replace them
            continue
        node, _, name = key.rpartition(".")
        if node == "model" and hasattr(model.cfg, name):
            assert getattr(model.cfg, name) == (tuple(value) if isinstance(value, list) else value), key
        elif node == "model" and hasattr(tc, name):
            assert getattr(tc, name) == (tuple(value) if isinstance(value, list) else value), key


@pytest.mark.parametrize("flag", list(port_main.UNPORTED_FLAGS))
def test_unported_flags_name_their_section(flag):
    """Every flag the port has not taken raises and names the ROADMAP
    section that queues it."""
    parser = port_main.build_parser()
    action = next(a for a in parser._actions if flag in a.option_strings)
    value = [] if action.nargs == 0 else (["1"] if action.type in (int, float) else
                                         ["learnable_clip"] if action.choices else ["x"])
    if action.nargs == "+":
        value = ["1"]
    args = parser.parse_args(["--config-file", "x", flag, *value])
    with pytest.raises(NotImplementedError, match=rf"{flag} .*ROADMAP {port_main.UNPORTED_FLAGS[flag]}"):
        port_main.refuse_unported(args, parser)


# ------------------------------------------------------------ CLI end to end
CLI_RUNS = {
    "mic": ["--MIC", "--MIC_reg", "1.0", "--mask_ratio", "0.5", "--MIC_reg_wo_pl_val", "--FD", "0.5",
            "--noise_reg", "1.0", "--reg_target_palette", "discrete", "--denoise_supervise", "1.0",
            "--denoise_interval", "3", "--pl_crop", "--disable_mixup", "--merge_with_pl_data",
            "linear_mix-0.3", "--pl_data_path", "pl", "--merge_more_target_data", "extra",
            "--remove_amp", "0.01", "0.1", "--fda_fusion_val", "0.5", "--unet_lr", "1e-5", "--warmup_lr",
            "--vae_decoder_loss_type", "L2", "--add_latent_noise", "0.2", "--norm_latent_noise",
            "--ema_w_unet", "--prompt_confidence", "0.5", "--rand_prompt_scale", "0.3",
            "--finetune_without_cross_attention"],
    "masked": ["--mask_prompt_ratio", "0.5", "--detach_mask_prompt", "--prompt_seq_len", "40",
               "--finetune_no"],
    "perturbed": ["--prompt_perturbation", "0.1"],
    "texture": ["--remove_texture"],
}
CLI_LOSSES = {"mic": {"masked_prompt_consistency_loss", "mic_vae_decoder_loss", "feature_distance_loss",
                      "noise_reg_loss", "denoise_consistency_loss"},
              "masked": {"masked_prompt_consistency_loss"}, "perturbed": {"masked_prompt_consistency_loss"},
              "texture": {"masked_prompt_consistency_loss"}}


@pytest.mark.parametrize("run", list(CLI_RUNS))
def test_cli_trains_with_ported_flags(run, ablation_root, tmp_path):
    """``main`` with the flags: two iterations, eval, checkpoints; the
    branches' losses in metrics.json, finite."""
    flags = [str(ablation_root / "pl") if f == "pl" else f for f in CLI_RUNS[run]]
    argv = cli_argv(ablation_root, tmp_path / "run")
    ins = argv.index("--output")
    argv[ins:ins] = flags
    state = port_main.main(argv)
    assert state.step == 2
    rows = [json.loads(line) for line in (tmp_path / "run" / "metrics.json").read_text().splitlines()]
    assert CLI_LOSSES[run] <= set(rows[0])
    assert all(np.isfinite(rows[i][k]) for i in range(2) for k in CLI_LOSSES[run])
    assert "eval/mIoU" in rows[-1]
    if run == "mic":
        assert state.consts and state.tc.schedule == "linear" and state.model.cfg.ema_w_unet
        ckpt = torch.load(tmp_path / "run" / "model_best.pth", weights_only=True)
        assert set(ckpt["consts"]) == {"ori_unet", "ori_prompt"}
    if run == "masked":
        assert state.model.prompt["clip_project_rgb"].prompt_embed.shape[1] == 40
        assert not any(n.startswith("unet.") for n, p in state.model.named_parameters() if p.requires_grad)
