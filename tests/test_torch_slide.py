"""The port's sliding-window eval against the JAX package on CPU, on a toy
model at crop 64 over 64x128 images: three windows, as at 512x1024 with the
shipped crop of 512."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.evaluation.inference import SLIDE_WINDOWS as JAX_SLIDE_WINDOWS
from madm_tpu.evaluation.inference import make_slide_eval_fn as jax_make_slide_eval_fn
from madm_tpu.models.madm import MADM as JaxMADM
from madm_tpu.models.madm import MADMConfig as JaxMADMConfig
from madm_torch.evaluation import make_slide_eval_fn
from madm_torch.evaluation.inference import SLIDE_WINDOWS
from madm_torch.models.madm import MADM, MADMConfig
from torch_port_toy import TOY, sure_pixels, toy_pair

FEATURE_ATOL = 1e-4  # fp32 both sides, other summation orders (measured ~4e-5 at s0)


@pytest.fixture(scope="module")
def slide():
    """The toy pair, one 64x128 image, and JAX's stitched features at t = 0
    and t = 900, slide-eval ids at t = 900 and head logits on those
    features.  JAX runs its 'batch' form (one backbone in the traced
    program, a third of the 'window' form's compile time; its own tests
    hold the two forms equal)."""
    port, jm, variables = toy_pair()
    images = np.random.default_rng(3).uniform(size=(1, 64, 128, 3)).astype(np.float32)
    x = jnp.asarray(images)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MADM_SLIDE_MAJOR", "batch")
        backbone = jax.jit(lambda v, x, t: jm.slide_backbone_forward(
            v, x, input_modal="others", timesteps=t)["output_features"])
        feats = {t: {k: np.asarray(f) for k, f in
                     backbone(variables, x, jnp.full((1,), t, jnp.int32)).items()} for t in (0, 900)}
        ids900 = np.asarray(jax_make_slide_eval_fn(jm, eval_with_noise=900)(variables, x))
    head = jax.jit(lambda v, f: jm.head_forward(v, f, use_sec_modal=True))
    logits900 = np.asarray(head(variables, {k: jnp.asarray(f) for k, f in feats[900].items()}))
    return port, images, feats, ids900, logits900


@pytest.mark.parametrize("crop", [64, 512])
@pytest.mark.parametrize("hw", [(512, 1024), (64, 128), (448, 640), (64, 64)])
def test_slide_windows_match_jax(crop, hw):
    cfg = {**TOY, "crop_size": (crop, crop)}
    port = MADM(MADMConfig(**cfg, compute_dtype=torch.float32), device="cpu")
    ref = JaxMADM(JaxMADMConfig(**cfg, compute_dtype=jnp.float32)).slide_windows(*hw)
    assert port.slide_windows(*hw) == ref
    if crop == 512 and hw == (512, 1024):
        assert ref == SLIDE_WINDOWS == JAX_SLIDE_WINDOWS


def _nhwc(features):
    return {k: v.permute(0, 2, 3, 1).numpy() for k, v in features.items()}


@pytest.mark.parametrize("form", ["window", "batch"])
@pytest.mark.parametrize("t", [0, 900])
def test_stitched_features_match_jax(slide, form, t):
    port, images, feats, _, _ = slide
    timesteps = None if t == 0 else torch.full((1,), t)
    out = _nhwc(port.slide_backbone_forward(images, timesteps=timesteps, form=form)["output_features"])
    assert list(out) == ["s0", "s3", "s4", "s5"]
    for name, ref in feats[t].items():
        assert out[name].shape == ref.shape
        np.testing.assert_allclose(out[name], ref, atol=FEATURE_ATOL * max(1.0, np.abs(ref).max()),
                                   rtol=0, err_msg=name)


def test_eval_with_noise_reaches_the_backbone(slide):
    """t = 900 noises every window's latent: the stitched features move far
    beyond the parity tolerance (and match JAX's at t = 900, above)."""
    port, images, feats, _, _ = slide
    out0 = port.slide_backbone_forward(images)["output_features"]
    out9 = port.slide_backbone_forward(images, timesteps=torch.full((1,), 900))["output_features"]
    diffs = [(out9[k] - out0[k]).abs().max().item() for k in out0]
    assert min(diffs) > 100 * FEATURE_ATOL, diffs
    assert max(np.abs(feats[900][k] - feats[0][k]).max() for k in feats[0]) > 1e-1


@pytest.mark.parametrize("eval_head", [None, "full"])
def test_slide_eval_ids_match_jax(slide, eval_head):
    """Port slide eval (the default 'aspp' head, K2's twin at W=128, and
    the 'full' head) against JAX ``make_slide_eval_fn`` (its module head on
    CPU), at eval_with_noise=900, where the top-2 margin settles the argmax."""
    port, images, _, ids_ref, logits = slide
    if eval_head is not None:
        model = MADM(dataclasses.replace(port.cfg, eval_head=eval_head), device="cpu")
        model.load_state_dict(port.state_dict())
        port = model
    ids = make_slide_eval_fn(port, eval_with_noise=900)(images).numpy()
    assert ids.shape == (1, 64, 128) and ids.dtype == np.int32
    sure = sure_pixels(logits)
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(ids[sure], ids_ref[sure])


def test_slide_forms_agree_for_a_batch(slide):
    """Two images, timesteps tiled over the windows in 'batch' form."""
    port, images, _, _, _ = slide
    two = np.concatenate([images, images[:, :, ::-1]], axis=0)
    t = torch.tensor([0, 900])
    a = port.slide_backbone_forward(two, timesteps=t, form="window")["output_features"]
    b = port.slide_backbone_forward(two, timesteps=t, form="batch")["output_features"]
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=FEATURE_ATOL, rtol=0, err_msg=k)
    single = port.slide_backbone_forward(two[1:], timesteps=t[1:], form="window")["output_features"]
    for k in a:
        np.testing.assert_allclose(a[k][1:].numpy(), single[k].numpy(), atol=FEATURE_ATOL, rtol=0)


def test_slide_form_is_checked(slide):
    port, images, _, _, _ = slide
    with pytest.raises(ValueError, match="form"):
        port.slide_backbone_forward(images, form="rows")


def test_head_chunks_are_exact(slide):
    """The 'aspp' head takes one image a call on stitched (wider than a
    crop) features, up to eight 512x512 crops' worth otherwise; ids
    concatenated over chunks equal one call's."""
    from madm_torch.models.madm import _chunk_over_batch, _head_chunk
    from madm_torch.ops.aspp import aspp_head_forward

    port, images, _, _, _ = slide
    assert (_head_chunk((512, 1024)), _head_chunk((512, 512)), _head_chunk((64, 128))) == (1, 8, 256)
    two = np.concatenate([images, images[:, :, ::-1]], axis=0)
    feats = port.slide_backbone_forward(two)["output_features"]
    calls = []

    def head(f):
        calls.append(next(iter(f.values())).shape[0])
        return aspp_head_forward(port.sem_seg_head, f)

    with torch.no_grad():
        one_by_one = _chunk_over_batch(head, feats, 1)
        whole = _chunk_over_batch(head, feats, 2)
    assert calls == [1, 1, 2]
    np.testing.assert_array_equal(one_by_one.numpy(), whole.numpy())
