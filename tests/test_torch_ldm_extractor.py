"""The port's LDM path (``madm_torch/models/ldm_extractor.py``, the VAE's
feature taps, ``from_jax``'s extractor tree) against the JAX package's on
the CPU.

The JAX trees take their shapes from ``jax.eval_shape`` of the JAX
``init_params`` (no flax init is compiled) and seeded values; they reach the
port through ``state_dict_from_jax``.  The JAX extractors run op by op with
each flax module's ``apply`` compiled alone (``torch_port_toy``'s
``_CompiledApply``, shared by every extractor of a test so each compiles
once): compiling a whole extractor is what keeps
``tests/test_ldm_extractor.py`` slow-tier.  Toy widths (that test's
``TINY``), 128x128 images, fp32; every feature within 1e-5 x max(1,
max|ref|).  JAX features are NHWC, the port's NCHW."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.models.clip_image import ClipAdapter as JaxClipAdapter
from madm_tpu.models.clip_image import CLIPVisionTransformer as JaxCLIPVision
from madm_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from madm_tpu.models.ldm_extractor import LatentDiffusion as JaxLatentDiffusion
from madm_tpu.models.ldm_extractor import LdmExtractor as JaxLdmExtractor
from madm_tpu.models.ldm_extractor import LdmImplicitCaptionerExtractor as JaxCaptioner
from madm_tpu.models.sd.vae import Encoder as JaxEncoder
from madm_torch.checkpoint.from_jax import state_dict_from_jax
from madm_torch.models.diffusion import GaussianDiffusion
from madm_torch.models.ldm_extractor import (
    LatentDiffusion,
    LdmExtractor,
    LdmImplicitCaptionerExtractor,
    init_random_,
)
from madm_torch.models.sd.vae import AutoencoderKL
from torch_port_toy import SMALL_CLIP, _CompiledApply

UNET_CH, VAE_CH = (32, 64, 128, 128), (32, 32, 64, 64)  # tests/test_ldm_extractor.py's TINY
TINY = dict(unet_channels=UNET_CH, vae_channels=VAE_CH)
IMG = 128
LATENT = IMG // 8
TOL = 1e-5


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def assert_close(got: torch.Tensor, ref, what="", tol=TOL):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().permute(0, 2, 3, 1).numpy() if got.ndim == 4 else got.detach().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), f"{what}: {err} of max|ref| {np.abs(ref).max()}"


def assert_features(got, ref, what=""):
    assert len(got) == len(ref), (len(got), len(ref))
    for i, (g, r) in enumerate(zip(got, ref)):
        assert_close(g, r, f"{what} feature {i}")


def seeded_tree(shapes, seed: int):
    """Values for a tree of ``jax.ShapeDtypeStruct``: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2), blend weights
    N(0, 0.5^2) (nonzero, so that every lift moves the output), tables
    N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1]
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.standard_normal(s.shape).astype(np.float32) * fan_in ** -0.5
        if name == "scale":
            return 1 + 0.1 * rng.standard_normal(s.shape).astype(np.float32)
        if name == "bias":
            return 0.1 * rng.standard_normal(s.shape).astype(np.float32)
        if name.startswith("alpha"):
            return 0.5 * rng.standard_normal(s.shape).astype(np.float32)
        return 0.02 * rng.standard_normal(s.shape).astype(np.float32)

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else fill(path + (k,), v)
                for k, v in tree.items()}

    return walk(shapes)


def test_feature_metadata_matches_jax_at_full_width():
    """``tests/test_ldm_extractor.py``'s values (encoder (5, 7), UNet (2, 5, 8,
    11), decoder (2, 5)) and other tap sets, steps and widths, against the
    JAX extractor's arithmetic; the port's modules are built on 'meta'."""
    ex = LdmExtractor(device="meta")
    assert ex.feature_dims == [512, 512, 2560, 1920, 960, 640, 512, 512]
    assert ex.feature_strides == [4, 8, 64, 32, 16, 8, 8, 4]
    assert ex.num_groups == 8
    ex2 = LdmExtractor(steps=(0, 100), device="meta")
    assert ex2.grouped_indices[2] == [2, 6] and len(ex2.feature_dims) == 12
    cases = [dict(), dict(steps=(0, 100)), dict(steps=(-1, 0, 500)),
             dict(encoder_block_indices=(0, 1, 2, 3, 4, 5, 6, 7), unet_block_indices=tuple(range(12)),
                  decoder_block_indices=tuple(range(12))),
             dict(encoder_block_indices=(1, 3), unet_block_indices=(0, 11), decoder_block_indices=(0, 11),
                  steps=(0, 10, 20), **TINY)]
    for kw in cases:
        port, ref = LdmExtractor(device="meta", **kw), JaxLdmExtractor(**kw)
        for name in ("feature_dims", "feature_strides", "num_groups", "grouped_indices", "feature_size"):
            assert getattr(port, name) == getattr(ref, name), (kw, name)
    ld, jld = LatentDiffusion(), JaxLatentDiffusion()
    assert (ld.image_size, ld.latent_image_size, ld.latent_dim) == (jld.image_size, jld.latent_image_size, 4)
    assert ld.LDM_CONFIGS == jld.LDM_CONFIGS
    for got, ref in zip(ld.diffusion.tables(), jld.diffusion._tables()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("tap_type", ["in", "after"])
def test_vae_taps_match_jax(tap_type, jax_modules, extractor_variables):
    """The encoder's taps ('in' 0-based at a resnet's input: the extractor's
    (5, 7), compiled once for the module; 'after' 1-based after it) and the
    decoder's (2, 5) (before a resnet, 3 a level), with and without
    ``output_final``; the latent and the image too."""
    enc_idx = (5, 7) if tap_type == "in" else (1, 4, 8)
    je = jax_modules["vae_encoder"]
    if tap_type == "after":
        je = _CompiledApply(JaxEncoder(encoder_block_indices=enc_idx, block_out_channels=VAE_CH, tap_type="after"))
    jd = jax_modules["vae_decoder"]
    params = extractor_variables["params"]
    vae = AutoencoderKL(VAE_CH, enc_idx, tap_type, (2, 5))
    sd = state_dict_from_jax({"params": {k: params[k] for k in ("vae_encoder", "vae_decoder")}})
    vae.load_state_dict({k[len("vae."):]: v for k, v in sd.items()}, strict=True)
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    ref_lat, ref_enc = je.apply({"params": params["vae_encoder"]}, img)
    with torch.no_grad():
        got_lat, got_enc = vae.encode_features(nchw(img))
        assert torch.equal(vae.encode(nchw(img)), got_lat)
    assert_close(got_lat, ref_lat, "latent")
    assert_features(got_enc, ref_enc, "encoder")
    lat = np.asarray(ref_lat)
    for final in (True, False):
        ref_img, ref_dec = jd.apply({"params": params["vae_decoder"]}, lat, output_final=final)
        with torch.no_grad():
            got_img, got_dec = vae.decode_features(nchw(lat), output_final=final)
        assert_features(got_dec, ref_dec, f"decoder output_final={final}")
        if final:
            assert_close(got_img, ref_img, "image")
            with torch.no_grad():
                assert torch.equal(vae.decode(nchw(lat)), got_img)
        else:
            assert got_img is None and ref_img is None


@pytest.fixture(scope="module")
def jax_modules():
    """The toy extractor's flax modules, each ``apply`` compiled alone and
    shared by every JAX extractor of this module; and a narrow CLIP tower."""
    jex = JaxLdmExtractor(compute_dtype=jnp.float32, **TINY)
    vision = JaxCLIPVision(**dataclasses.asdict(SMALL_CLIP))
    return {"vae_encoder": _CompiledApply(jex.vae_encoder), "vae_decoder": _CompiledApply(jex.vae_decoder),
            "unet": _CompiledApply(jex.unet), "vision": vision, "vision_apply": _CompiledApply(vision)}


def jax_extractor(mods, **kw):
    jex = JaxLdmExtractor(compute_dtype=jnp.float32, **TINY, **kw)
    for name in ("vae_encoder", "vae_decoder", "unet"):
        setattr(jex, name, mods[name])
    return jex


def jax_captioner(mods, steps=(0,), **kw):
    ext = JaxCaptioner(ldm_extractor=jax_extractor(mods, steps=steps), **kw)
    ext.clip = JaxClipAdapter()
    ext.clip.vision = mods["vision"]
    return ext


def noise_const(share_noise: bool):
    """The shared noise at the test's latent size (JAX makes it at 512 px)."""
    if not share_noise:
        return None
    return np.random.default_rng(3).standard_normal((1, LATENT, LATENT, 4)).astype(np.float32)


def port_from(variables, **kw) -> LdmExtractor:
    """A port extractor (or captioner, given ``vision``) holding
    ``variables`` through ``state_dict_from_jax``, every key of both."""
    cls = LdmImplicitCaptionerExtractor if "vision" in kw else LdmExtractor
    port = cls(compute_dtype=torch.float32, device="cpu", **TINY, **kw)
    sd = state_dict_from_jax(variables)
    if "shared_noise" in sd:
        port.shared_noise = torch.empty_like(sd["shared_noise"])
    port.load_state_dict(sd, strict=True)
    return port


@pytest.fixture(scope="module")
def extractor_variables(jax_modules):
    shapes = jax.eval_shape(jax_extractor(jax_modules).init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    return {"params": seeded_tree(shapes["params"], 5),
            "consts": {"uncond_inputs": rng.standard_normal((1, 77, 768)).astype(np.float32)}}


@pytest.mark.parametrize("steps", [(0,), (-1,), (0, 100)])
@pytest.mark.parametrize("share_noise,cond", [(True, False), (False, True)])
def test_extractor_matches_jax(steps, share_noise, cond, jax_modules, extractor_variables):
    """The feature list at each step set, with and without the shared noise
    (zeros without it, as JAX), with the empty prompt or given prompts and
    time embeddings, B=2."""
    variables = {"params": extractor_variables["params"],
                 "consts": dict(extractor_variables["consts"], shared_noise=noise_const(share_noise))}
    jex = jax_extractor(jax_modules, steps=steps, share_noise=share_noise)
    port = port_from(variables, steps=steps, share_noise=share_noise)
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    kw = {}
    if cond:
        kw = {"cond_inputs": rng.standard_normal((2, 77, 768)).astype(np.float32),
              "cond_emb": rng.standard_normal((2, len(steps), UNET_CH[0] * 4)).astype(np.float32)}
    ref = jex(variables, img, **kw)
    with torch.no_grad():
        got = port(torch.from_numpy(img), **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert [tuple(g.shape[1:]) for g in got] == [(d, IMG // s, IMG // s) for d, s in
                                                 zip(port.feature_dims, port.feature_strides)]
    assert_features(got, ref, f"steps {steps} share_noise {share_noise} cond {cond}")


def captioner_variables(mods, extractor_variables, **kw):
    """The captioner's tree: the extractor's, and the tower, the two
    projection sets and their EMA copies, shaped by the JAX ``init_params``
    with the extractor's own init (already shaped) left out."""
    ext = jax_captioner(mods, **kw)
    ext.ldm_extractor.init_params = lambda rng: {"params": {}, "consts": {}}
    shapes = jax.eval_shape(ext.init_params, jax.random.PRNGKey(0))["params"]
    params = dict(extractor_variables["params"], **seeded_tree(shapes, 7))
    ema = {f"ema_{k}": seeded_tree(shapes[k], 8) for k in ("clip_project_rgb", "clip_project_others")}
    return {"params": params, "ema": ema,
            "consts": dict(extractor_variables["consts"], shared_noise=noise_const(True))}


CAPTIONER_CASES = {
    "rgb": dict(input_modal="rgb"),
    "depth": dict(input_modal="depth"),
    "ema_rgb": dict(input_modal="rgb", ema_forward=True),
    "ema_depth": dict(input_modal="depth", ema_forward=True),
    "without_prompt": dict(input_modal="depth", init=dict(without_prompt=True)),
    "no_time_embed": dict(input_modal="rgb", init=dict(learnable_time_embed=False)),
    "broadcast": dict(input_modal="rgb", steps=(0, 100)),  # num_timesteps 1 against 2 steps
    "two_timesteps": dict(input_modal="depth", steps=(0, 100), init=dict(num_timesteps=2)),
}


@pytest.mark.parametrize("case", list(CAPTIONER_CASES))
def test_implicit_captioner_matches_jax(case, jax_modules, extractor_variables):
    """The narrow tower (``SMALL_CLIP``) in front of the toy extractor: the 'rgb' and
    other sets, the EMA sets, ``without_prompt``, no time lift, and the
    time lift broadcast over the steps or one row a step."""
    spec = dict(CAPTIONER_CASES[case])
    init, steps = spec.pop("init", {}), spec.pop("steps", (0,))
    variables = captioner_variables(jax_modules, extractor_variables, steps=steps, **init)
    ext = jax_captioner(jax_modules, steps=steps, **init)
    ext.clip.vision = jax_modules["vision_apply"]
    port = port_from(variables, steps=steps, vision=SMALL_CLIP, ema=True, **init)
    img = np.random.default_rng(8).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    ref = ext(variables, img, **spec)
    with torch.no_grad():
        got = port(torch.from_numpy(img), **spec)
    assert_features(got, ref, case)


def test_seeded_init_follows_init_params():
    """``clip_project_others`` starts as a copy of ``clip_project_rgb``,
    ``alpha_cond_time`` at 0, the other blend weights in [0, 1), the EMA
    sets as copies; draws are seeded."""
    def make(seed):
        return init_random_(LdmImplicitCaptionerExtractor(vision=SMALL_CLIP, ema=True, device="cpu", **TINY),
                            torch.Generator().manual_seed(seed))

    a, b = make(0), make(0)
    for (k, v), (_, w) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(v, w), k
    rgb, others = a.clip_project_rgb.state_dict(), a.clip_project_others.state_dict()
    assert all(torch.equal(rgb[k], others[k]) for k in rgb)
    assert all(torch.equal(rgb[k], v) for k, v in a.ema["clip_project_others"].state_dict().items())
    assert not a.clip_project_rgb.alpha_cond_time.any()
    for p in (a.clip_project_rgb.alpha_cond_prompt, a.clip_project_rgb.alpha_uncond_prompt):
        assert 0 <= p.min() and p.max() < 1 and p.std() > 0.1
    assert a.shared_noise.shape == (1, 4, 64, 64)
    assert LdmExtractor(share_noise=False, device="meta").shared_noise is None


def test_apply_model_with_guidence_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 3, 3, 4)).astype(np.float32)
    cond = rng.standard_normal((4, 5)).astype(np.float32)
    t = np.array([3, 3, 7, 7], np.int32)

    def jmodel(xx, tt, c):
        return xx * jnp.tanh(c.sum(-1))[:, None, None, None] + tt[:, None, None, None] * 0.01

    def tmodel(xx, tt, c):
        return xx * torch.tanh(c.sum(-1))[:, None, None, None] + tt[:, None, None, None] * 0.01

    ref = JaxLatentDiffusion(guidance_scale=2.5).apply_model_with_guidence(jmodel, x, t, cond)
    got = LatentDiffusion(guidance_scale=2.5).apply_model_with_guidence(
        tmodel, nchw(x), torch.from_numpy(t), torch.from_numpy(cond))
    assert_close(got, ref, "guided eps")
    assert torch.equal(got[:2], got[2:])


def test_ddim_over_the_toy_unet_matches_jax(jax_modules, extractor_variables):
    """Two DDIM steps ('ddim2': t = 500, 0) over the toy UNet with
    classifier-free guidance (the batch [cond | uncond] halves), eta 0.5,
    JAX's draws handed in.  The guided eps of the first step within 1e-5;
    the sample, whose first step divides the eps difference by sqrt(acp[500])
    and scales it by 2 x guidance - 1, within 1e-4."""
    ld, jld = LatentDiffusion(guidance_scale=3.0), JaxLatentDiffusion(guidance_scale=3.0)
    jg = JaxDiffusion.create(1000, "ldm_linear", "ddim2")
    tg = GaussianDiffusion.create(1000, "ldm_linear", "ddim2")
    params = extractor_variables["params"]["unet"]
    port = port_from({"params": extractor_variables["params"], "consts": extractor_variables["consts"]},
                     share_noise=False)
    rng = np.random.default_rng(10)
    cond = np.concatenate([rng.standard_normal((1, 77, 768)), extractor_variables["consts"]["uncond_inputs"]])
    cond = cond.astype(np.float32)
    tcond = torch.from_numpy(cond)
    shape = (2, LATENT, LATENT, 4)
    unet = jax_modules["unet"]

    def jmodel(x, t):
        return jld.apply_model_with_guidence(lambda xx, tt, c: unet.apply({"params": params}, xx, tt, c, None)[0],
                                             x, t, cond)

    def tmodel(x, t):
        return ld.apply_model_with_guidence(lambda xx, tt, c: port.unet(xx, tt, c)[0], x, t, tcond)

    key = jax.random.PRNGKey(11)
    draws = [jax.random.normal(key, shape)]
    for _ in range(2):
        key, k = jax.random.split(key)
        draws.append(jax.random.normal(k, shape))
    t0 = np.full((2,), int(jg.timestep_map[-1]), np.int32)
    with torch.no_grad():
        assert_close(tmodel(nchw(draws[0]), torch.from_numpy(t0)), jmodel(draws[0], t0), "guided eps")
        got = tg.ddim_sample_loop(tmodel, (2, 4, LATENT, LATENT), eta=0.5, draws=[nchw(d) for d in draws])

    def host_model(x, t):  # the compiled UNet from inside JAX's scan, not compiled into it again
        return jax.pure_callback(lambda a, b: np.asarray(jmodel(a, b)), jax.ShapeDtypeStruct(shape, jnp.float32),
                                 x, t)

    ref = jg.ddim_sample_loop(host_model, shape, jax.random.PRNGKey(11), eta=0.5)
    assert_close(got, ref, "ddim", tol=1e-4)
