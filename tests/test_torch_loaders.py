"""The port's weight loaders against the JAX package's on CPU, on files the
tests write: the ``.safetensors`` reader (F32, F16, BF16, I64, bit for bit),
``load_torch_file``, an HF SD-v1.4 snapshot (its converted path set equal to
the JAX model's parameters, then both packages' eval logits with and without
``text_encoder/``), a released MADM ``.pth`` in the reference's layout (peft
keys, nonzero B, ``ema_*``, ``num_batches_tracked``, ``in_index``), an
``ema_unet`` file of an ``--ema_w_unet`` run, the refusals (an unknown head
key, a key or a shape the model lacks), ``resume_or_load`` from a released
file, and the CLI with
``--sd-snapshot``, ``--lora_configs``, ``--init_uncond_prompt`` and
``--init-from released.pth``.

Toy widths (``torch_port_toy.TOY``); the text encoder is 768 wide (its
output is the UNet's cross-attention context) with SD's vocabulary, one
layer and a narrow MLP."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.checkpoint import converter as jconv
from madm_tpu.models import clip_text as jclip
from madm_tpu.models.madm import MADM as JaxMADM
from madm_tpu.models.madm import MADMConfig as JaxMADMConfig
from madm_torch.checkpoint import (
    Checkpointer,
    convert_madm_pth,
    load_safetensors,
    load_sd_snapshot,
    load_torch_file,
    merge_into_model,
    reference_state_dict,
    save_safetensors,
    save_sd_snapshot,
    snapshot_state_dict,
)
from madm_torch.checkpoint.converter import EMA_UNET
from madm_torch.checkpoint.from_jax import state_dict_from_jax
from madm_torch.main import build_model_and_state, build_parser, do_test, load_snapshot_, main, setup
from madm_torch.models.clip_text import compute_uncond_inputs
from madm_torch.models.madm import MADM, MADMConfig, init_random_
from madm_torch.train.train_step import make_train_state, TrainConfig
from test_torch_cli import cli_argv, data_root  # noqa: F401 (data_root: a fixture)
from test_torch_clip_text import hf_state
from torch_port_toy import TOY, jax_variables, remove_tmp_path  # noqa: F401 (an autouse fixture)

LORA = ("default_r4_a8", "Depth_r4_a4")
CLIP = dict(vocab_size=49408, width=768, layers=1, mlp_dim=256, max_len=77)
CLIP_HEADS = 12
TOL = 1e-4  # fp32 logits, XLA against torch summation orders (PERF.md §2)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _port(seed, lora=(), trainable=False):
    return init_random_(MADM(MADMConfig(**TOY, compute_dtype=torch.float32, lora_configs=lora),
                             device="cpu", trainable=trainable), _gen(seed))


def _paths(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, path + (k,)))
        else:
            out[path + (k,)] = tuple(v.shape)
    return out


def _close(port, ref, tol=TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _jax_shapes(lora=()):
    jm = JaxMADM(JaxMADMConfig(**TOY, compute_dtype=jnp.float32, lora_configs=lora))
    return jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))


def _legacy_vae(key):
    """The attention names of SD-v1.4's released ``vae/*.bin``."""
    for new, old in ((".to_q.", ".query."), (".to_k.", ".key."), (".to_v.", ".value."),
                     (".to_out.0.", ".proj_attn.")):
        key = key.replace(new, old)
    return key


def _with_nonzero_b(model, seed):
    g = _gen(seed)
    with torch.no_grad():
        for adapter in model.lora.values():
            for _, s in adapter.sites():
                s.lora_B.copy_(torch.randn(s.lora_B.shape, generator=g) * 0.05)
    return model


# ----------------------------------------------------------------- readers
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64])
def test_safetensors_reader_equals_jax(tmp_path, dtype):
    g = _gen(0)
    tensors = {"a.weight": torch.randn(3, 5, generator=g) * 100, "b": torch.randn(7, generator=g),
               "scalar": torch.randn((), generator=g), "empty": torch.zeros(0, 4)}
    tensors = {k: (v * 1000).long() if dtype == torch.int64 else v.to(dtype) for k, v in tensors.items()}
    path = str(tmp_path / "t.safetensors")
    save_safetensors(path, tensors)
    port, ref = load_safetensors(path), jconv.load_safetensors(path)
    assert port.keys() == ref.keys() == tensors.keys()
    for k, v in port.items():
        assert v.dtype == dtype and torch.equal(v, tensors[k]), k
        p = (v.float() if dtype == torch.bfloat16 else v).numpy()
        assert p.dtype == ref[k].dtype and p.shape == ref[k].shape and p.tobytes() == ref[k].tobytes(), k


def test_load_torch_file_unwraps_and_casts_like_jax(tmp_path):
    """``state_dict`` and ``model`` entries unwrapped, non-arrays dropped,
    floats of any dtype as fp32 (the JAX loader's ``.float()``); integer
    tensors keep their values."""
    g = _gen(1)
    sd = {"w16": torch.randn(4, 3, generator=g).half(), "wbf": torch.randn(5, generator=g).bfloat16(),
          "w32": torch.randn(2, 2, generator=g), "n": torch.tensor(7), "note": "not an array"}
    for i, obj in enumerate(({"state_dict": sd}, {"model": sd, "iteration": 3}, sd)):
        path = str(tmp_path / f"f{i}.pth")
        torch.save(obj, path)
        port, ref = load_torch_file(path), jconv.load_torch_file(path)
        assert port.keys() == ref.keys() == {"w16", "wbf", "w32", "n"}
        for k, v in port.items():
            assert v.dtype == (torch.int64 if k == "n" else torch.float32), k
            np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


# ---------------------------------------------------------------- snapshot
@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A toy SD snapshot written from a seeded port model: the UNet as
    safetensors, the VAE as a ``.bin`` with the legacy attention names, the
    text encoder as BF16 safetensors; and the same without ``text_encoder/``."""
    root = tmp_path_factory.mktemp("snapshot")
    writer = _port(1)
    clip = {k: torch.from_numpy(v) for k, v in hf_state(**CLIP, seed=2).items()}
    full, bare = root / "full", root / "bare"
    save_sd_snapshot(str(full), writer, clip, text_dtype=torch.bfloat16)
    vae_bin = full / "vae" / "diffusion_pytorch_model.bin"
    torch.save({_legacy_vae(k): v for k, v in torch.load(vae_bin).items()}, vae_bin)
    shutil.copytree(full, bare, ignore=shutil.ignore_patterns("text_encoder"))
    yield writer, full, bare
    shutil.rmtree(root, ignore_errors=True)


def test_snapshot_paths_equal_jax_params(snapshot):
    """The JAX converter reads the snapshot into exactly the JAX model's
    VAE and UNet parameters (shapes too), and the text encoder into the
    parameters of a CLIP text transformer of its fields: the port's file
    names are the names the JAX converter knows."""
    _, full, _ = snapshot
    sd = jconv.load_sd_snapshot(str(full))
    shapes = _jax_shapes()["params"]
    for part in ("vae_encoder", "vae_decoder", "unet"):
        assert _paths(sd[part]) == _paths(shapes[part]), part
    jm = jclip.CLIPTextTransformer(**CLIP, heads=CLIP_HEADS)
    clip_shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))
    assert _paths(sd["clip_text"]) == _paths(clip_shapes["params"])


def test_snapshot_reader_equals_jax(snapshot):
    """Every tensor the port reads equals the JAX converter's, and the
    loaded VAE and UNet equal the writer's exactly."""
    writer, full, _ = snapshot
    snap = load_sd_snapshot(str(full))
    assert set(snap) == {"vae", "unet", "clip_text"}
    model = _port(3)
    merge_into_model(model, snapshot_state_dict(snap))
    want = writer.state_dict()
    for k, v in model.state_dict().items():
        if k.startswith(("vae.", "unet.")):
            assert torch.equal(v, want[k]), k
    ref = state_dict_from_jax({"params": {k: v for k, v in jconv.load_sd_snapshot(str(full)).items()
                                          if k != "clip_text"}})
    assert ref.keys() == snapshot_state_dict(snap).keys()
    for k, v in snapshot_state_dict(snap).items():
        assert torch.equal(v.float(), ref[k]), k


@pytest.fixture(scope="module")
def jax_eval():
    jm = JaxMADM(JaxMADMConfig(**TOY, compute_dtype=jnp.float32, lora_configs=LORA))
    return jm, jax.jit(lambda v, x, name: jm.eval_forward(v, x, lora_name=name), static_argnums=2)


@pytest.mark.parametrize("text", [True, False], ids=["text_encoder", "no_text_encoder"])
def test_snapshot_logits_equal_jax(snapshot, jax_eval, text):
    """``main.load_snapshot_`` on a fresh port model against JAX
    ``main.py``'s snapshot branch (``merge_into_variables``, the empty-prompt
    embedding of the text encoder) on the same fresh weights: eval logits to
    1e-4, ``uncond_inputs`` to 1e-5."""
    _, full, bare = snapshot
    jm, fn = jax_eval
    port = _port(4, LORA)
    variables = jax_variables(port)
    load_snapshot_(port, str(full if text else bare))
    sd = jconv.load_sd_snapshot(str(full if text else bare))
    clip = sd.pop("clip_text", None)
    assert (clip is not None) == text
    variables["params"] = jconv.merge_into_variables(variables["params"], sd)
    if text:
        jclip_model = jclip.CLIPTextTransformer(**CLIP, heads=CLIP_HEADS)
        uncond = jclip_model.apply({"params": clip}, jnp.asarray(jclip.empty_prompt_ids()))
        variables["consts"]["uncond_inputs"] = uncond
        _close(port.uncond_inputs.numpy(), uncond, 1e-5)
        assert port.uncond_inputs.abs().max() > 0.1
    else:
        assert not port.uncond_inputs.any()
    x = np.random.default_rng(5).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    _close(port.eval_forward(torch.from_numpy(x)).numpy(), fn(variables, jnp.asarray(x), None))


def test_snapshot_init_uncond_prompt(snapshot):
    """``init_uncond_prompt``: each learned prompt_embed is the recomputed
    ``uncond_inputs`` (JAX ``main.py:441-449``); without a text encoder the
    prompts keep their values."""
    _, full, bare = snapshot
    for root, seeded in ((full, True), (bare, False)):
        model = init_random_(MADM(MADMConfig(**TOY, compute_dtype=torch.float32, init_uncond_prompt=True),
                                  device="cpu", trainable=True), _gen(6))
        before = model.prompt.clip_project_rgb.prompt_embed.detach().clone()
        load_snapshot_(model, str(root))
        embed = model.prompt.clip_project_rgb.prompt_embed.detach()
        assert torch.equal(embed, model.uncond_inputs) == seeded
        assert torch.equal(embed, before) != seeded


# ------------------------------------------------------------ released .pth
@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """A trainable writer with both adapters (B nonzero), a teacher that
    differs from the student, random BN statistics and counters, saved in a
    released checkpoint's layout (``{'model': ..., 'iteration': ...}``) with
    ``in_index`` (0, 1, 2, 3) and (1, 2, 3, 4)."""
    root = tmp_path_factory.mktemp("released")
    writer = _with_nonzero_b(_port(7, LORA, trainable=True), 8)
    g = _gen(9)
    with torch.no_grad():
        for k, v in writer.state_dict().items():
            if k.endswith("num_batches_tracked"):
                v.fill_(17)
            elif k.startswith("ema.") or k.endswith(("running_mean", "running_var")):
                v.add_(torch.rand(v.shape, generator=g) * 0.1)
    paths = {}
    for in_index in ((0, 1, 2, 3), (1, 2, 3, 4)):
        paths[in_index] = str(root / f"released_{''.join(map(str, in_index))}.pth")
        torch.save({"model": reference_state_dict(writer, in_index), "iteration": 99}, paths[in_index])
    yield writer, paths
    shutil.rmtree(root, ignore_errors=True)


def test_released_layout_is_the_references(released):
    """peft-wrapped attention projections, adapters under ``lora_A|B.<name>``,
    the teacher under ``ema_*``, BN counters kept, no VAE."""
    keys = set(torch.load(released[1][(0, 1, 2, 3)])["model"])
    unet = "backbone.feature_extractor.ldm_extractor.unet.down_blocks.0.attentions.0.transformer_blocks.0."
    assert {unet + "attn1.to_q.base_layer.weight", unet + "attn1.to_out.0.base_layer.bias",
            unet + "attn2.to_k.lora_A.Depth.weight", unet + "attn2.to_v.lora_B.default.weight",
            unet + "norm1.weight", "backbone.feature_projections.0.0.conv1.norm.weight",
            "backbone.ema_feature_projections.3.0.shortcut.weight",
            "backbone.feature_extractor.clip_project_rgb.prompt_embed",
            "backbone.feature_extractor.ema_clip_project_others.alpha_cond_time",
            "sem_seg_head.embed_layers.3.proj.weight", "ema_sem_seg_head.conv_seg.bias",
            "sem_seg_head.fuse_layer.aspp_modules.1.depthwise_conv.bn.num_batches_tracked"} <= keys
    assert not any(".vae." in k or k.startswith("vae") for k in keys)


def test_released_paths_equal_jax_params(released):
    """The JAX converter reads the file into exactly the JAX model's trained
    parameters, teacher and BN statistics (shapes too)."""
    conv = jconv.convert_madm_pth(released[1][(0, 1, 2, 3)])
    shapes = _jax_shapes(LORA)
    for part in ("unet", "lora", "prompt", "projections", "head"):
        assert _paths(conv["params"][part]) == _paths(shapes["params"][part]), part
    assert _paths(conv["ema"]) == _paths(shapes["ema"])
    assert _paths(conv["state"]) == _paths(shapes["state"])


def test_released_state_equals_writer(released):
    """A fresh trainable model takes every tensor of the file (student,
    adapters, teacher, BN statistics and counters); only the VAE, which the
    file leaves out, keeps its own values."""
    writer, paths = released
    model = _port(10, LORA, trainable=True)
    merge_into_model(model, convert_madm_pth(paths[(0, 1, 2, 3)]))
    want = writer.state_dict()
    for k, v in model.state_dict().items():
        if not k.startswith(("vae.", "uncond_inputs", "shared_noise")):
            assert torch.equal(v, want[k]), k
    assert not torch.equal(model.vae.encoder.conv_in.weight, writer.vae.encoder.conv_in.weight)


def test_released_in_index_equals_jax(released):
    """``embed_layers.<feature index>`` of a file written with in_index
    (1, 2, 3, 4) land at their positions, in both packages."""
    writer, paths = released
    port = convert_madm_pth(paths[(1, 2, 3, 4)], in_index=(1, 2, 3, 4))
    conv = jconv.convert_madm_pth(paths[(1, 2, 3, 4)], in_index=(1, 2, 3, 4))
    ref = state_dict_from_jax({"params": {"head": conv["params"]["head"]},
                               "state": {"head_bn": conv["state"]["head_bn"]}})
    head = {k: v for k, v in port.items() if k.startswith("sem_seg_head.")}
    assert head.keys() == ref.keys()
    for k, v in head.items():
        assert torch.equal(v.float(), ref[k].float()) or k.endswith("num_batches_tracked"), k
    assert torch.equal(head["sem_seg_head.embed_layers.0.proj.weight"],
                       writer.sem_seg_head.embed_layers["0"].proj.weight.detach())
    with pytest.raises(KeyError, match="in_index"):
        convert_madm_pth(paths[(1, 2, 3, 4)])


def test_released_logits_with_depth_adapter_equal_jax(released, jax_eval):
    """An eval model (no teacher: the ``ema.*`` keys are dropped) loaded from
    the file, against the JAX model with ``merge_into_variables`` of the JAX
    conversion: logits with ``lora_name='Depth'`` to 1e-4, and the adapter
    moves them."""
    writer, paths = released
    jm, fn = jax_eval
    port = _port(11, LORA)
    port.vae.load_state_dict(writer.vae.state_dict())
    variables = jax_variables(port)
    merge_into_model(port, convert_madm_pth(paths[(0, 1, 2, 3)]))
    variables = jconv.merge_into_variables(variables, jconv.convert_madm_pth(paths[(0, 1, 2, 3)]))
    x = np.random.default_rng(12).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    out = port.eval_forward(torch.from_numpy(x), lora_name="Depth").numpy()
    _close(out, fn(variables, jnp.asarray(x), "Depth"))
    assert np.abs(out - port.eval_forward(torch.from_numpy(x)).numpy()).max() > 1e-2


def test_ema_unet_file_converts_as_jax(released):
    """A file of an ``--ema_w_unet`` run: the teacher's UNet and adapters
    under ``ldm_extractor.ema_unet`` go to ``ema.unet`` and ``ema.lora``, as
    the JAX converter takes them into its EMA tree."""
    sd = torch.load(released[1][(0, 1, 2, 3)])["model"]
    unet = EMA_UNET.replace("ema_unet", "unet")
    for k in [k for k in sd if k.startswith(unet)]:
        sd[EMA_UNET + k[len(unet):]] = sd[k] * 1.5
    ours = convert_madm_pth(sd)
    ref = state_dict_from_jax({"ema": jconv.convert_madm_pth({k: v.numpy() for k, v in sd.items()})["ema"]})
    ema = {k: v for k, v in ours.items() if k.startswith(("ema.unet.", "ema.lora."))}
    assert ema and set(ema) == {k for k in ref if k.startswith(("ema.unet.", "ema.lora."))}
    assert any(k.startswith("ema.lora.Depth.") for k in ema)
    for k, v in ema.items():
        np.testing.assert_allclose(v.float().numpy(), ref[k].numpy(), rtol=0, atol=0, err_msg=k)
        assert torch.equal(v, ours[k[len("ema."):]] * 1.5), k


def test_unknown_head_key_raises_in_both(released):
    sd = torch.load(released[1][(0, 1, 2, 3)])["model"]
    sd["sem_seg_head.not_a_layer.weight"] = torch.zeros(3)
    with pytest.raises(KeyError, match="unhandled head key"):
        jconv.convert_madm_pth({k: v.numpy() for k, v in sd.items()})
    with pytest.raises(KeyError, match="unhandled head key"):
        convert_madm_pth(sd)


def test_merge_refuses_what_the_model_lacks(released):
    """Adapters a model does not hold, or of another rank, raise; JAX's
    overlay would add or replace them."""
    conv = convert_madm_pth(released[1][(0, 1, 2, 3)])
    with pytest.raises(KeyError, match="not in the model"):
        merge_into_model(_port(13), conv)
    with pytest.raises(ValueError, match="shape mismatch"):
        merge_into_model(_port(13, ("default_r8_a8", "Depth_r4_a4")), conv)


def test_checkpointer_initialises_from_a_released_pth(released, tmp_path):
    """``resume_or_load(init_from=<released .pth>)`` overlays the file on the
    train state's model (JAX ``checkpointer.py:105-116``); the optimizer
    and the step stay as they are."""
    writer, paths = released
    state = make_train_state(_port(14, LORA, trainable=True), TrainConfig())
    state, resumed = Checkpointer(str(tmp_path)).resume_or_load(state, init_from=paths[(0, 1, 2, 3)],
                                                              resume=False)
    assert not resumed and state.step == 0
    want = writer.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in state.model.state_dict().items()
               if k.startswith(("unet.", "lora.", "ema.", "sem_seg_head.", "prompt.")))


# --------------------------------------------------------------------- CLI
def test_cli_loads_a_snapshot_adapters_and_a_released_pth(data_root, tmp_path):
    """``python -m madm_torch.main --eval-only --init-from released.pth
    --sd-snapshot <dir> --lora_configs default_r4_a8,Event_r4_a4
    --init_uncond_prompt`` (the event config: the target adapter is
    'Event') gives the metrics of ``do_test`` on the model that wrote the
    files; then two train iterations with the snapshot and the adapters."""
    lora = "default_r4_a8,Event_r4_a4"
    argv = cli_argv(data_root, tmp_path / "writer")
    ins = argv.index("--output")
    parser = build_parser()
    args = parser.parse_args(argv[:ins] + ["--lora_configs", lora] + argv[ins:])
    cfg = setup(args)
    writer, _, _ = build_model_and_state(cfg, args)
    _with_nonzero_b(writer, 15)
    clip = {k: torch.from_numpy(v) for k, v in hf_state(**CLIP, seed=16).items()}
    clip = {k: v.bfloat16().float() if v.is_floating_point() else v for k, v in clip.items()}
    with torch.no_grad():
        writer.uncond_inputs.copy_(compute_uncond_inputs(clip, device="cpu"))
    save_sd_snapshot(str(tmp_path / "sd"), writer, clip, text_dtype=torch.bfloat16)
    torch.save({"model": reference_state_dict(writer)}, tmp_path / "released.pth")
    want = do_test(cfg, writer, None, args)

    flags = ["--lora_configs", lora, "--sd-snapshot", str(tmp_path / "sd"), "--init_uncond_prompt"]
    ev = cli_argv(data_root, tmp_path / "eval")
    ev[ins:ins] = flags + ["--eval-only", "--init-from", str(tmp_path / "released.pth")]
    got = main(ev)
    assert got.keys() == want.keys() and all(np.isfinite(v) for v in want.values())
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}

    tr = cli_argv(data_root, tmp_path / "train")
    tr[ins:ins] = flags
    state = main(tr)
    assert state.step == 2 and state.model.lora_specs.keys() == {"default", "Event"}
    assert torch.equal(state.model.uncond_inputs, writer.uncond_inputs)
    ckpt = torch.load(tmp_path / "train" / "model_best.pth", weights_only=True)["model"]
    assert any(k.startswith("lora.Event.") for k in ckpt)
