"""Attention capture and the prompt structures, the port against the JAX
package at toy width in fp32 (``tests/torch_port_toy.py``):

- the UNet's cross-attention capture at every location and res (each
  captured layer's head-mean probabilities), the captured pass's output
  equal to the kernel pass's, and the 'in' taps;
- ``MADM.collect_attention``'s three outputs against JAX
  ``_collect_attention``;
- the per-layer, prompt-less and alpha-less prompts: the conditioning and
  the eval logits;
- ``slide_training``: a head loss's gradients through the differentiable
  sliding window at twice the crop's width, against ``jax.grad``, and the
  step's dispatch and refusals.

Tolerances: maps 1e-5, logits 1e-4 x max(1, max|logit|), gradients 2e-3 of
the largest entry (``tests/test_torch_train.py``'s)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.models import prompt as jax_prompt
from madm_tpu.models.madm import MADM as JaxMADM
from madm_tpu.models.madm import MADMConfig as JaxMADMConfig
from madm_tpu.models.sd.unet import UNet2DCondition as JaxUNet
from madm_tpu.train import criterion as jax_criterion
from madm_torch.checkpoint.from_jax import state_dict_from_jax
from madm_torch.models import prompt as prompt_lib
from madm_torch.models.madm import MADM, MADMConfig, trainable_parameters
from madm_torch.models.sd.unet import AttentionCapture, UNet2DCondition
from madm_torch.train import criterion
from madm_torch.train.loop import synthetic_batches
from madm_torch.train.train_step import TrainConfig, make_train_state, train_step
from test_torch_train import GRAD_ATOL_OF_MAX
from torch_port_toy import TOY, assert_close, toy_pair

ALL_RES, ALL_LOC = (8, 16, 32, 64), ("down", "mid", "up")
# the 16 cross-attentions in the order a pass runs them: (JAX module, location, res)
LAYERS = ([(f"down_blocks_{b}", f"attentions_{i}", "down", 64 >> b) for b in range(3) for i in range(2)]
          + [("mid_block", "attentions_0", "mid", 8)]
          + [(f"up_blocks_{b}", f"attentions_{i}", "up", 8 << b) for b in range(1, 4) for i in range(3)])
SELECT = (3, 7, 12, 20, 26, 33, 41, 48, 55, 63, 76)
MAP_TOL = 1e-5


def _images(b=2, h=64, w=64, seed=7):
    return np.random.default_rng(seed).uniform(size=(b, h, w, 3)).astype(np.float32)


# ------------------------------------------------------------------- UNet
@pytest.fixture(scope="module")
def unet_run():
    """One pass of the toy UNet that captures every cross-attention, on each
    side, plus the port's pass without capture and both packages' 'in'
    taps."""
    port, _, jvars = toy_pair()
    rng = np.random.default_rng(1)
    sample = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 768)).astype(np.float32)
    ts = np.array([0, 500], np.int32)
    params = {"params": jvars["params"]["unet"]}
    junet = JaxUNet(block_out_channels=TOY["unet_channels"], attention_features_res=ALL_RES,
                    attention_features_location=ALL_LOC)
    (j_eps, j_taps), mut = jax.jit(lambda p, *a: junet.apply(p, *a, mutable=["attn_probs"]))(
        params, sample, ts, ctx)
    j_in = jax.jit(JaxUNet(block_out_channels=TOY["unet_channels"], unet_block_indices_type="in").apply)(
        params, sample, ts, ctx)[1]
    x = torch.from_numpy(sample).permute(0, 3, 1, 2)
    cap = AttentionCapture(ALL_RES, ALL_LOC)
    with torch.no_grad():
        eps, taps = port.unet(x, torch.from_numpy(ts).long(), torch.from_numpy(ctx), capture=cap)
        eps_plain, taps_plain = port.unet(x, torch.from_numpy(ts).long(), torch.from_numpy(ctx))
        unet_in = UNet2DCondition(TOY["unet_channels"], unet_block_indices_type="in")
        unet_in.load_state_dict(port.unet.state_dict())
        taps_in = unet_in(x, torch.from_numpy(ts).long(), torch.from_numpy(ctx))[1]
    return dict(j_eps=np.asarray(j_eps), j_taps=[np.asarray(t) for t in j_taps], j_probs=mut["attn_probs"],
                j_in=[np.asarray(t) for t in j_in], eps=eps, taps=taps, eps_plain=eps_plain,
                taps_plain=taps_plain, entries=cap.entries, taps_in=taps_in)


@pytest.mark.parametrize("layer", range(len(LAYERS)), ids=lambda i: f"{LAYERS[i][2]}{LAYERS[i][3]}_{i}")
def test_capture_at_every_location_and_res_matches_jax(unet_run, layer):
    block, attn, location, res = LAYERS[layer]
    assert len(unet_run["entries"]) == len(LAYERS)
    loc, r, probs = unet_run["entries"][layer]
    assert (loc, r) == (location, res)
    ref = unet_run["j_probs"][block][attn]["transformer_blocks_0"]["attn2"]["probs"][0]
    assert_close(probs, ref, MAP_TOL)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)


def test_captured_pass_output_equals_the_kernel_pass(unet_run):
    """The explicit-softmax layers give the kernel path's eps and taps, and
    JAX's."""
    eps, ref = unet_run["eps"], unet_run["eps_plain"]
    assert_close(eps, ref, 1e-5)
    for a, b in zip(unet_run["taps"], unet_run["taps_plain"]):
        assert_close(a, b, 1e-5)
    assert_close(eps.permute(0, 2, 3, 1), unet_run["j_eps"], 1e-4)


def test_in_taps_match_jax(unet_run):
    """'in' taps: the concat of the hidden state and its skip entering up
    resnets 5, 8 and 11."""
    assert len(unet_run["taps_in"]) == 3
    for a, b in zip(unet_run["taps_in"], unet_run["j_in"]):
        assert_close(a.permute(0, 2, 3, 1), b, 1e-4)
    assert [t.shape[1] for t in unet_run["taps_in"]] == [192, 96, 64]


def test_in_taps_madm_check_as_jax():
    """MADM checks feature_dims against the 'after' taps' channels whatever
    the tap type, as JAX does (ROADMAP §C): 'in' channels raise with JAX's
    message."""
    kw = dict(TOY, unet_block_indices_type="in", feature_dims=(3, 64, 96, 192))
    with pytest.raises(ValueError) as port_err:
        MADM(MADMConfig(**kw, compute_dtype=torch.float32), device="cpu")
    with pytest.raises(ValueError) as jax_err:
        JaxMADM(JaxMADMConfig(**kw, compute_dtype=jnp.float32))
    assert str(port_err.value) == str(jax_err.value)


# ------------------------------------------------------ collect_attention
@pytest.fixture(scope="module")
def collected():
    variant = dict(attention_features_res=ALL_RES, attention_features_location=ALL_LOC,
                   attention_select_index=SELECT)
    port, jm, jvars = toy_pair(**variant)
    images = _images()
    ref = jax.jit(lambda v, x: jm.backbone_forward(v, x, input_modal="others", capture_attention=True))(
        jvars, images)
    with torch.no_grad():
        out = port.backbone_forward(torch.from_numpy(images), capture_attention=True)
    return out, ref


def test_collected_attention_features_match_jax(collected):
    out, ref = collected
    assert list(out["attention_features"]) == sorted(ref["attention_features"]) == list(ALL_RES)
    for res, m in out["attention_features"].items():
        assert_close(m, ref["attention_features"][res], MAP_TOL)


def test_collected_up_cross_matches_jax(collected):
    out, ref = collected
    assert len(out["up_cross"]) == len(ref["up_cross"]) == 9
    for a, b in zip(out["up_cross"], ref["up_cross"]):
        assert_close(a, b, MAP_TOL)


def test_collected_cross_attention_feat_matches_jax(collected):
    """The largest res's map at the selected tokens, channels-first for the
    head."""
    out, ref = collected
    feat = out["cross_attention_feat"]
    assert feat.shape == (2, 11, 8, 8)
    assert_close(feat.permute(0, 2, 3, 1), ref["cross_attention_feat"], MAP_TOL)


# ----------------------------------------------------------------- prompts
PROMPTS = {"multi_layer_prompt": dict(multi_layer_prompt=True), "without_prompt": dict(without_prompt=True),
           "without_prompt_alpha": dict(without_prompt_alpha=True)}


@pytest.mark.parametrize("name", list(PROMPTS))
def test_prompt_conditioning_matches_jax(name):
    """cond_prompt and cond_time of each prompt structure, on a nonzero
    empty-prompt embedding, against JAX's on the same parameters; the
    parameters present are JAX's."""
    port, _, jvars = toy_pair(**PROMPTS[name])
    p = port.prompt["clip_project_rgb"]
    jp = jvars["params"]["prompt"]["clip_project_rgb"]
    assert set(jp) == {n for n, _ in p.named_parameters()}
    jax_init = jax_prompt.init_clip_feature_project(
        0, learnable_cond_prompt=name != "without_prompt", learnable_cond_time=name != "without_prompt",
        without_prompt_alpha=name == "without_prompt_alpha", time_embed_dim=128,
        multi_layer_prompt=name == "multi_layer_prompt")
    assert {k: v.shape for k, v in jax_init.items()} == {k: v.shape for k, v in jp.items()}
    uncond = np.random.default_rng(3).standard_normal((1, 77, 768)).astype(np.float32)
    cp = prompt_lib.cond_prompt(p, torch.from_numpy(uncond))
    assert_close(cp.detach(), jax_prompt.cond_prompt(jp, jnp.asarray(uncond)), 1e-6)
    ct, jct = prompt_lib.cond_time(p), jax_prompt.cond_time(jp)
    assert (ct is None) == (jct is None)
    if ct is not None:
        assert_close(ct.detach(), jct, 1e-6)
    cp_b, ct_b = prompt_lib.conditioning_of(p, torch.from_numpy(uncond), 3)
    assert cp_b.shape == (((16,) if name == "multi_layer_prompt" else ()) + (3, 77, 768))


@pytest.mark.parametrize("name", list(PROMPTS))
def test_prompt_structure_eval_logits_match_jax(name):
    port, jm, jvars = toy_pair(**PROMPTS[name])
    uncond = np.random.default_rng(3).standard_normal((1, 77, 768)).astype(np.float32)
    port.uncond_inputs.copy_(torch.from_numpy(uncond))
    jvars["consts"]["uncond_inputs"] = uncond
    images = _images(1)
    ref = np.asarray(jax.jit(jm.eval_forward)(jvars, images))
    out = port.eval_forward(torch.from_numpy(images)).numpy()
    assert_close(out, ref, 1e-4)


# ------------------------------------------------------------ slide_training
@pytest.fixture(scope="module")
def slide_grads():
    """A head loss (eval-mode BN, CE against labels) through the sliding
    window at [1, 64, 128, 3] (three windows as one batch of crops, the
    'batch' form: JAX's ``MADM_SLIDE_MAJOR=batch``, one backbone to
    compile), differentiated by each package."""
    port, jm, jvars = toy_pair(slide_training=True)
    images = _images(1, 64, 128, seed=11)
    labels = np.random.default_rng(12).integers(0, 11, (1, 64, 128)).astype(np.int32)

    def loss(params):
        v = {**jvars, "params": {**jvars["params"], **params}}
        feats = jm.slide_backbone_forward(v, images, input_modal="rgb", train=True)["output_features"]
        return jax_criterion.cross_entropy(jm.head_forward(v, feats), labels)

    trained = {k: jvars["params"][k] for k in ("unet", "prompt", "projections", "head")}
    major = os.environ.get("MADM_SLIDE_MAJOR")
    os.environ["MADM_SLIDE_MAJOR"] = "batch"  # read when the slide pass is traced
    try:
        ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss))(trained)
    finally:
        if major is None:
            del os.environ["MADM_SLIDE_MAJOR"]
        else:
            os.environ["MADM_SLIDE_MAJOR"] = major
    model = MADM(MADMConfig(**TOY, compute_dtype=torch.float32, slide_training=True), device="cpu",
                 trainable=True)
    model.load_state_dict(port.state_dict(), strict=False)
    model.reset_ema_()
    feats = model.slide_backbone_forward(torch.from_numpy(images), input_modal="rgb", train=True,
                                         form="batch")["output_features"]
    out_loss = criterion.cross_entropy(model.head_forward(feats), torch.from_numpy(labels))
    out_loss.backward()
    grads = {n: p.grad for n, p in trainable_parameters(model)}
    return out_loss.item(), float(ref_loss), grads, state_dict_from_jax({"params": ref_grads})


def test_slide_training_loss_matches_jax(slide_grads):
    out, ref, _, _ = slide_grads
    assert abs(out - ref) <= 1e-4 * abs(ref)


@pytest.mark.parametrize("prefix", ["unet.", "prompt.", "feature_projections.", "sem_seg_head."])
def test_slide_training_gradients_match_jax(slide_grads, prefix):
    _, _, grads, ref = slide_grads
    keys = [k for k in grads if k.startswith(prefix)]  # the trained tensors
    assert keys
    gmax = max(v.abs().max().item() for v in ref.values())
    for k in keys:
        g = grads[k] if grads[k] is not None else torch.zeros_like(ref[k])
        err = (g - ref[k]).abs().max().item()
        assert err <= GRAD_ATOL_OF_MAX * gmax, (k, err, gmax)


def test_slide_training_step_takes_the_window_and_refuses_decoder_losses(monkeypatch):
    """Inputs wider than the crop take slide_backbone_forward on every pass;
    the decoder-output losses raise at make_train_state, as JAX's
    make_train_step refuses them."""
    cfg = MADMConfig(**TOY, compute_dtype=torch.float32, slide_training=True)
    model = MADM(cfg, device="cpu", trainable=True)
    with pytest.raises(ValueError, match="slide_training is incompatible"):
        make_train_state(model, TrainConfig())
    state = make_train_state(model, TrainConfig(vae_decoder_loss="", reg_uncertain=False))
    calls = []
    slide = model.slide_backbone_forward
    monkeypatch.setattr(model, "slide_backbone_forward", lambda *a, **kw: calls.append(kw["form"]) or slide(*a, **kw))
    g = torch.Generator().manual_seed(3)
    m = train_step(state, next(synthetic_batches(1, (64, 128), 11, g)), g)
    assert calls == ["window"] * 3 and np.isfinite(m["total_loss"])


# --------------------------------------------------------------------- vis
def test_vis_overlays_the_teacher_attention(tmp_path):
    """The training vis of a concat-slot model: the teacher's maps at the
    first captured res, averaged over the tokens, as JAX ``vis_fn``
    computes them, drawn over the target image; its prediction panels read
    the concat slot.  JAX's ``vis_fn`` calls the concat head without the
    maps and raises (ROADMAP §C)."""
    from madm_tpu.train import TrainConfig as JaxTrainConfig
    from madm_tpu.train.vis import make_vis_fn as jax_make_vis_fn
    from madm_torch.train.train_step import sample_draws
    from madm_torch.train.vis import build_vis_data, make_vis_fn
    from madm_torch.utils.visualization import save_vis_grid

    variant = dict(attention_features_res=(16, 32), attention_features_location=("up",),
                   concat_attention_to_conv_seg=True, attention_select_index=SELECT)
    port, jm, jvars = toy_pair(**variant)
    model = MADM(MADMConfig(**TOY, compute_dtype=torch.float32, **variant), device="cpu", trainable=True)
    model.load_state_dict(port.state_dict(), strict=False)
    model.reset_ema_()
    tc = TrainConfig()
    g = torch.Generator().manual_seed(2)
    batch = next(synthetic_batches(1, (64, 64), 11, g))
    draws = sample_draws(g, tc, batch["source_label"], 11, model.sem_seg_head, model.cfg)
    host = make_vis_fn(model, tc)(batch, draws, 0)
    with torch.no_grad():
        tch = model.backbone_forward(batch["target_second_modality"], ema_forward=True,
                                     timesteps=torch.full((1,), int(host["rev_noise_t"])),
                                     capture_attention=True)
    np.testing.assert_array_equal(host["attention_map"], tch["attention_features"][16].mean(-1).numpy())
    vis = build_vis_data(host, tc, 0)
    assert vis[-1]["data_type"] == "attention_maps" and vis[-1]["data"].shape == (1, 2, 2)
    assert save_vis_grid(vis, str(tmp_path), 0, list(range(33)))
    jvars["ema"] = jm.init_ema(jvars["params"])
    jvars["state"]["ema_head_bn"] = jvars["state"]["head_bn"]
    jbatch = {k: v.numpy() for k, v in batch.items()}
    jax_vis = jax_make_vis_fn(jm, JaxTrainConfig())
    with pytest.raises(Exception, match="conv_seg"):
        jax_vis(jvars, jbatch, jax.random.PRNGKey(0), jnp.zeros((), jnp.int32))
