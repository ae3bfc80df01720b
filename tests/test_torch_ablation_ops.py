"""The ablation branches' ops and model pieces, the port against the JAX
package on CPU, each fed the same inputs (made with numpy) and the random
values the JAX functions draw from their keys: the MIC block mask, the FDA
and edge-texture functions, the regression palette, the prompt ablations
and ``prompt_seq_len``'s resize, the decoder and feature losses, the
``--warmup_lr`` schedule, the ``unet_lr`` group, the ``finetune_unet``
sets, the EMA tree of ``ema_w_unet`` and its teacher pass, and the latent
noise options."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from madm_tpu.checkpoint import converter as jconv
from madm_tpu.models.madm import MADM as JaxMADM
from madm_tpu.models.madm import MADMConfig as JaxMADMConfig
from madm_tpu.models import prompt as jprompt
from madm_tpu.models.sd import lora as jlora
from madm_tpu.ops import dacs as jdacs
from madm_tpu.ops import fda as jfda
from madm_tpu.ops import palette as jpalette
from madm_tpu.train import criterion as jcrit
from madm_tpu.train import ema as jema
from madm_tpu.train import optimizer as jopt
from madm_torch.checkpoint import reference_state_dict
from madm_torch.checkpoint.from_jax import state_dict_from_jax
from madm_torch.models import prompt
from madm_torch.models.madm import FINETUNE_UNET, MADM, MADMConfig, init_random_, trainable_parameters
from madm_torch.ops import dacs, fda, palette
from madm_torch.train import criterion, optimizer
from torch_port_toy import TOY, jax_variables

ATOL = 1e-6  # fp32 elementwise maths on both sides
LORA = ("default_r4_a8", "Depth_r4_a4")


def _np(x):
    return np.array(x)  # a writable copy


# ------------------------------------------------------------ MIC masking
@pytest.mark.parametrize("shape", [(2, 80, 112), (1, 48, 100), (2, 64, 64)])
def test_block_mask_and_mask_image_equal_jax(shape):
    """Block counts round half to even (80/32 -> 2, 112/32 -> 4, 48/32 -> 2)
    and blocks resize to pixels at their centres ('nearest-exact')."""
    b, h, w = shape
    key = jax.random.PRNGKey(sum(shape))
    mh, mw = round(h / 32), round(w / 32)
    scores = torch.from_numpy(_np(jax.random.uniform(key, (b, mh, mw, 1))))
    assert dacs.draw_block_mask(torch.Generator().manual_seed(0), b, h, w).shape == scores.shape
    ref = _np(jdacs.block_mask(key, shape, 0.6))
    got = dacs.block_mask(scores, (h, w), 0.6).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.mean() < 1 or b * mh * mw < 4
    img = np.random.default_rng(1).uniform(size=(b, h, w, 3)).astype(np.float32)
    np.testing.assert_allclose(dacs.mask_image(torch.from_numpy(img), scores, 0.6).numpy(),
                               _np(jdacs.mask_image(key, jnp.asarray(img), 0.6)), atol=ATOL, rtol=0)


# -------------------------------------------------------------------- FDA
@pytest.mark.parametrize("fusion", [None, 0.3])
def test_remove_array_amp_equals_jax(fusion):
    img = np.random.default_rng(2).uniform(0, 255, size=(3, 50, 70)).astype(np.float32)
    np.testing.assert_array_equal(fda.remove_array_amp(img, 0.08, fusion),
                                  jfda.remove_array_amp(img, 0.08, fusion))


def test_edge_texture_equals_jax():
    rng = np.random.default_rng(3)
    gray = rng.uniform(size=(31, 45)).astype(np.float32)
    np.testing.assert_array_equal(fda.extract_edge_info(gray), jfda.extract_edge_info(gray))
    np.testing.assert_array_equal(fda._edge_region(gray.copy()), jfda._edge_region(gray.copy()))
    flat = np.full((7, 9), 0.5, np.float32)  # no positive response: the region maps to 127.5
    np.testing.assert_array_equal(fda._edge_region(flat.copy()), jfda._edge_region(flat.copy()))
    img = rng.uniform(0, 255, size=(3, 64, 96)).astype(np.float32)
    out = fda.extract_edge_info_local(img)
    np.testing.assert_array_equal(out, jfda.extract_edge_info_local(img))
    assert out.shape == (3, 64, 96) and 0 <= out.min() and out.max() <= 255


# ---------------------------------------------------------------- palette
@pytest.mark.parametrize("which", [None, "discrete"])
def test_reg_target_table_equals_jax(which):
    train = palette.DELIVER_11_PALETTE
    np.testing.assert_array_equal(palette.reg_target_table(train, which),
                                  jpalette.reg_target_table(train, which))
    assert palette.DISCRETE_PALETTE == jpalette.DISCRETE_PALETTE
    with pytest.raises(ValueError, match="discrete"):
        palette.reg_target_table(train, "bright")


# ----------------------------------------------------------------- prompts
@pytest.mark.parametrize("mode", ["masked_prompt", "prompt_perturbation", "rand_prompt"])
def test_prompt_ablations_equal_jax(mode):
    key = jax.random.PRNGKey(5)
    p = np.random.default_rng(4).standard_normal((1, 40, 768)).astype(np.float32)
    if mode == "masked_prompt":
        ref = jprompt.mask_prompt(key, jnp.asarray(p), 0.4)
        got = prompt.mask_prompt(torch.from_numpy(p), torch.from_numpy(_np(jax.random.uniform(key, (1, 40, 1)))), 0.4)
        assert 0 < (got[0, :, 0] == 0).float().mean() < 1
    elif mode == "prompt_perturbation":
        ref = jprompt.perturb_prompt(key, jnp.asarray(p), 0.3)
        got = prompt.perturb_prompt(torch.from_numpy(p), torch.from_numpy(_np(jax.random.normal(key, p.shape))), 0.3)
    else:
        ref = jprompt.rand_prompt(key, jnp.asarray(p), 0.5)
        got = prompt.rand_prompt(torch.from_numpy(p), torch.from_numpy(_np(jax.random.uniform(key, p.shape))), 0.5)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=ATOL, rtol=0)
    draw = prompt.draw_prompt_ablation(torch.Generator().manual_seed(0), mode, 40)
    assert draw.shape == ((1, 40, 1) if mode == "masked_prompt" else (1, 40, 768))


@pytest.mark.parametrize("seq_len", [40, 100])
@pytest.mark.parametrize("antialias", [False, True])
def test_resize_prompt_equals_jax(seq_len, antialias):
    """The 77-token prompt resized along the sequence as ``jax.image.resize``
    bilinear: without antialiasing in ``cond_prompt``, with it (JAX's
    default, which matters when shrinking) for ``init_uncond_prompt``."""
    u = np.random.default_rng(6).standard_normal((1, 77, 768)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(u), (1, seq_len, 768), method="bilinear", antialias=antialias)
    got = prompt.resize_prompt(torch.from_numpy(u), seq_len, antialias=antialias)
    # fp32 interpolation weights computed in another order: 1e-5 of the
    # largest entry (measured 4.5e-6 at 77 -> 40)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5 * np.abs(u).max(), rtol=0)


@pytest.fixture(scope="module")
def seq40():
    """A toy model with 40-token prompts and every prompt ablation set, a
    nonzero empty-prompt embedding, and the JAX MADM of the same config."""
    kw = dict(prompt_seq_len=40, mask_prompt_ratio=0.5, detach_mask_prompt=True,
              prompt_perturbation=0.2, rand_prompt_scale=0.3)
    port = init_random_(MADM(MADMConfig(**TOY, compute_dtype=torch.float32, **kw), device="cpu"),
                        torch.Generator().manual_seed(0))
    with torch.no_grad():
        port.uncond_inputs.normal_(generator=torch.Generator().manual_seed(1))
    jm = JaxMADM(JaxMADMConfig(**TOY, compute_dtype=jnp.float32, **kw))
    return port, jm, jax_variables(port)


@pytest.mark.parametrize("mode", [None, "masked_prompt", "prompt_perturbation", "rand_prompt"])
def test_conditioning_with_ablations_equals_jax(seq40, mode):
    """JAX ``MADM.conditioning`` with ``prompt_mode`` against the port's
    ``conditioning_of`` with ``prompt_ablation``: the learned 40-token
    prompt blended with the resized 77-token one, then the ablation; the
    masked prompt is detached under ``detach_mask_prompt`` and the perturbed
    one always, the others keep their graph."""
    port, jm, variables = seq40
    key = jax.random.PRNGKey(8)
    draw = (jax.random.normal(key, (1, 40, 768)) if mode == "prompt_perturbation"
            else jax.random.uniform(key, (1, 40, 1) if mode == "masked_prompt" else (1, 40, 768)))
    cp, ct = jm.conditioning(variables, "others", batch_size=2, prompt_mode=mode, prompt_rng=key)
    p = port.prompt["clip_project_rgb"]
    p.requires_grad_(True)
    got_cp, got_ct = prompt.conditioning_of(p, port.uncond_inputs, 2,
                                            port.prompt_ablation(mode, torch.from_numpy(_np(draw))))
    p.requires_grad_(False)
    assert tuple(got_cp.shape) == (2, 40, 768)
    np.testing.assert_allclose(got_cp.detach().numpy(), _np(cp), atol=1e-5 * np.abs(_np(cp)).max(), rtol=0)
    np.testing.assert_allclose(got_ct.detach().numpy(), _np(ct), atol=ATOL, rtol=0)
    assert got_cp.requires_grad == (mode is None)


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("loss_type", ["L1", "L2"])
def test_decoder_losses_equal_jax(loss_type):
    rng = np.random.default_rng(9)
    pred, gt = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(2, 64, 64, 1)) > 0.3).astype(np.float32)
    t = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    got = criterion.denoise_consistency_loss(t(pred), t(gt), torch.tensor(0.37), loss_type, 2.0)
    ref = jcrit.denoise_consistency_loss(jnp.asarray(pred), jnp.asarray(gt), 0.37, loss_type, 2.0)
    assert abs(got.item() - float(ref)) <= 1e-6 * abs(float(ref))
    got = criterion.vae_decoder_loss(t(pred), t(gt), torch.from_numpy(mask), 0.5, loss_type)
    ref = jcrit.vae_decoder_loss(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask), loss_type, 0.5)
    assert abs(got.item() - float(ref)) <= 1e-6 * abs(float(ref))


@pytest.mark.parametrize("weighted", [False, True])
def test_label_smooth_cross_entropy_equals_jax(weighted):
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((2, 16, 16, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 32, 32)).astype(np.int32)
    labels[:, :3] = 255
    w = rng.uniform(size=(2, 32, 32)).astype(np.float32) if weighted else None
    got = criterion.label_smooth_cross_entropy(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                               torch.from_numpy(labels), 0.1,
                                               None if w is None else torch.from_numpy(w))
    ref = jcrit.label_smooth_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 0.1,
                                           None if w is None else jnp.asarray(w))
    assert abs(got.item() - float(ref)) <= 1e-6 * abs(float(ref))


def test_feature_distance_loss_equals_jax():
    rng = np.random.default_rng(11)
    shapes = [(2, 8, 4, 4), (2, 16, 8, 8), (2, 4, 16, 16)]
    a = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    b = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    got = criterion.feature_distance_loss([torch.from_numpy(x) for x in a], [torch.from_numpy(x) for x in b], 0.5)
    ref = jcrit.feature_distance_loss([jnp.asarray(x) for x in a], [jnp.asarray(x) for x in b], 0.5)
    assert abs(got.item() - float(ref)) <= 1e-6 * abs(float(ref))


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("count", [0, 1, 100, 374, 375, 376, 5000, 9999, 10000, 12000])
def test_linear_schedule_equals_jax(count):
    ref = float(jopt.linear_lr_schedule(5e-6, 10000)(count))
    got = optimizer.get_lr_schedule(5e-6, 10000, "linear")(count)
    assert abs(got - ref) <= 1e-6 * max(ref, 1e-12)
    assert optimizer.get_lr_schedule(5e-6, 10000)(count) == optimizer.lr_schedule(5e-6, 10000)(count)


class _Parts(nn.Module):
    """The UNet, an adapter and the rest, under the names the unet_lr
    groups read."""

    def __init__(self):
        super().__init__()
        self.unet = nn.ModuleDict({"lin": nn.Linear(5, 4)})
        self.lora = nn.ModuleDict({"a": nn.Linear(4, 3, bias=False)})
        self.head = nn.ModuleDict({"lin": nn.Linear(4, 2), "norm": nn.LayerNorm(2)})


def test_unet_lr_group_equals_optax():
    """optax scales the whole AdamW update of 'unet' and 'lora', decay
    included, by unet_lr / lr; the port's groups at lr * that ratio give the
    same parameters over two clipped updates."""
    torch.manual_seed(0)
    model = _Parts()
    for p in model.parameters():
        p.data.normal_()
    named = list(model.named_parameters())

    def flax(name):
        mod, sub, leaf = name.split(".")
        return mod, sub, {"weight": "kernel" if sub != "norm" else "scale", "bias": "bias"}[leaf]

    def tree(arrays):
        out = {}
        for name, a in arrays.items():
            mod, sub, leaf = flax(name)
            out.setdefault(mod, {}).setdefault(sub, {})[leaf] = jnp.asarray(a)
        return out

    params = tree({n: p.detach().numpy() for n, p in named})
    tx = jopt.make_optimizer(params, base_lr=1e-3, weight_decay=0.05, max_iter=100, grad_clip=0.01,
                             unet_lr=4e-3)
    opt_state = tx.init(params)
    port = optimizer.make_optimizer(model, named, lr=1e-3, weight_decay=0.05, unet_lr=4e-3)
    assert sorted(g["lr_scale"] for g in port.param_groups) == [1.0, 1.0, 4.0, 4.0]
    sched = optimizer.get_lr_schedule(1e-3, 100)
    rng = np.random.default_rng(1)
    for count in range(2):
        grads = {n: (rng.normal(size=tuple(p.shape)) * 0.1).astype(np.float32) for n, p in named}
        updates, opt_state = tx.update(tree(grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        for n, p in named:
            p.grad = torch.from_numpy(grads[n].copy())
        optimizer.clip_by_global_norm_([p for _, p in named], 0.01)
        optimizer.set_lr(port, sched(count))
        port.step()
    for n, p in named:
        mod, sub, leaf = flax(n)
        np.testing.assert_allclose(p.detach().numpy(), _np(params[mod][sub][leaf]), atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("mode", FINETUNE_UNET)
def test_finetune_unet_trained_names_equal_jax(mode):
    """The UNet weights that train under each ``finetune_unet`` mode: the
    port's ``trainable_parameters`` against JAX ``split_trainable``."""
    model = MADM(MADMConfig(**TOY, compute_dtype=torch.float32, finetune_unet=mode), device="cpu")
    unet = jconv.convert_unet_state({k: v.numpy() for k, v in model.unet.state_dict().items()})
    trained, _ = jopt._partition(unet, jopt.unet_trainable_mask(unet, mode))
    want = set(state_dict_from_jax({"params": {"unet": trained}})) if trained else set()
    got = {n for n, _ in trainable_parameters(model) if n.startswith("unet.")}
    assert got == want
    if mode == "no":
        assert not got
    if mode == "all":
        assert {n for n, _ in model.unet.named_parameters() if not n.startswith("conv_")} <= \
            {n[len("unet."):] for n in got}
    if mode == "without cross-attention":
        assert got and not any(".attn2." in n for n in got) and any(".attn1." in n for n in got)
    if mode == "attention":
        assert got and all(".attentions." in n for n in got)


# ---------------------------------------------------------- ema_w_unet
@pytest.fixture(scope="module")
def ema_model():
    """A trainable toy model with ``ema_w_unet`` and two adapters (B drawn
    nonzero), its teacher UNet and adapters moved off the student's, and
    the same weights as JAX variables through the released-checkpoint
    layout (``reference_state_dict`` -> JAX ``convert_madm_pth``)."""
    model = init_random_(MADM(MADMConfig(**TOY, compute_dtype=torch.float32, lora_configs=LORA,
                                         ema_w_unet=True), device="cpu", trainable=True),
                         torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_B"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
            if name.startswith(("ema.unet.", "ema.lora.")):
                p.mul_(1 + 0.05 * torch.randn(p.shape, generator=g))
    released = {k: v.numpy() for k, v in reference_state_dict(model).items()}
    conv = jconv.convert_madm_pth(released)
    variables = jax_variables(model)
    variables["params"].update(conv["params"])
    variables["ema"] = conv["ema"]
    variables["state"].update(conv["state"])
    return model, variables


def test_student_subtree_equals_jax(ema_model):
    """The port's (EMA, student) pairs hold JAX ``student_subtree``'s
    tensors under ``ema_w_unet``: projections, head, the target prompt, the
    UNet and the adapters, each beside the student tensor of its name."""
    model, variables = ema_model
    tree = jema.student_subtree(variables["params"], True, ema_w_unet=True)
    want = {k for k in state_dict_from_jax({"ema": tree}) if not k.endswith("num_batches_tracked")}
    pairs = model.student_ema_pairs()
    got = set()
    prefix = {id(m): n for n, m in model.named_modules()}
    for e, s in pairs:
        sp = dict(s.named_parameters())
        for n, p in e.named_parameters():
            got.add(f"{prefix[id(e)]}.{n}")
            assert sp[n].shape == p.shape
    assert got == want and any(k.startswith("ema.unet.") for k in got)
    assert any(k.startswith("ema.lora.Depth.") for k in got)


def test_ema_w_unet_teacher_pass_equals_jax(ema_model):
    """A teacher pass with the Depth adapter runs the teacher's UNet and
    adapter (JAX ``madm.py:698-708``): features equal JAX's, and not the
    student's."""
    model, variables = ema_model
    jm = JaxMADM(JaxMADMConfig(**TOY, compute_dtype=jnp.float32, lora_configs=LORA, ema_w_unet=True))
    x = np.random.default_rng(12).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    fn = jax.jit(lambda v, im: jm.backbone_forward(v, im, input_modal="others", lora_name="Depth",
                                                   ema_forward=True)["output_features"])
    ref = fn(variables, jnp.asarray(x))
    out = model.backbone_forward(torch.from_numpy(x), lora_name="Depth", ema_forward=True)["output_features"]
    student = model.backbone_forward(torch.from_numpy(x), lora_name="Depth")["output_features"]
    for k, v in out.items():
        r = _np(ref[k]).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(v.numpy(), r, atol=1e-4 * max(1.0, np.abs(r).max()), rtol=0)
    assert max((out[k] - student[k]).abs().max().item() for k in out) > 1e-3


def test_reference_state_dict_round_trips_the_teacher_unet(ema_model):
    """The released layout carries the teacher's UNet and adapters under
    ``ldm_extractor.ema_unet`` and converts back onto them."""
    model, _ = ema_model
    from madm_torch.checkpoint import convert_madm_pth

    ref = reference_state_dict(model)
    assert any(k.startswith("backbone.feature_extractor.ldm_extractor.ema_unet.") for k in ref)
    back = convert_madm_pth(ref)
    own = model.state_dict()
    keys = [k for k in own if k.startswith(("ema.unet.", "ema.lora."))]
    assert keys and all(torch.equal(back[k], own[k]) for k in keys)


# ------------------------------------------------------------ latent noise
@pytest.mark.parametrize("modal", ["mixed", "others"])
def test_latent_noise_options_equal_jax(modal):
    """``add_latent_noise`` (the 'mixed' pass only, with the drawn noise) and
    ``norm_latent_noise`` (global mean and population std, every pass)."""
    kw = dict(add_latent_noise=0.3, norm_latent_noise=True)
    port = init_random_(MADM(MADMConfig(**TOY, compute_dtype=torch.float32, **kw), device="cpu"),
                        torch.Generator().manual_seed(4))
    jm = JaxMADM(JaxMADMConfig(**TOY, compute_dtype=jnp.float32, **kw))
    variables = jax_variables(port)
    key = jax.random.PRNGKey(13)
    x = np.random.default_rng(14).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    fn = jax.jit(lambda v, im: jm.backbone_forward(v, im, input_modal=modal, latent_noise_rng=key))
    ref = fn(variables, jnp.asarray(x))
    noise = torch.from_numpy(_np(jax.random.normal(key, (2, 8, 8, 4)))).permute(0, 3, 1, 2)
    out = port.backbone_forward(torch.from_numpy(x), input_modal=modal, latent_noise=noise)
    eps = _np(ref["before_vae_decoder"]).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(out["before_vae_decoder"].numpy(), eps, atol=1e-4 * np.abs(eps).max(), rtol=0)
    for k, v in out["output_features"].items():
        r = _np(ref["output_features"][k]).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(v.numpy(), r, atol=1e-4 * max(1.0, np.abs(r).max()), rtol=0)
    with pytest.raises(ValueError, match="latent_noise"):
        port.backbone_forward(torch.from_numpy(x), input_modal="mixed")
