"""The port's LoRA adapters against the JAX package's on CPU: parsing the
configs, the adapted sites, the merge W + (alpha/r) B A in the port's
[out, in] layout (B drawn nonzero: at init B = 0 and the merge is the
identity, which would hide a transposed factor), an eval model's single
rounding, the functional merge's gradients, and one whole toy train step
with ``lora_configs=('default_r4_a8', 'Depth_r4_a4')`` against
``make_train_step`` at ``tests/test_torch_train.py``'s tolerances, the
adapters' gradients included.  Adapters reach the port from the JAX tree
through ``state_dict_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.checkpoint.converter import convert_unet_state
from madm_tpu.models.madm import MADM as JaxMADM
from madm_tpu.models.madm import MADMConfig as JaxMADMConfig
from madm_tpu.models.sd import lora as jlora
from madm_tpu.ops import dacs as jdacs
from madm_tpu.train import TrainConfig as JaxTrainConfig
from madm_tpu.train import make_optimizer, make_train_state, make_train_step, split_trainable
from madm_torch.checkpoint.from_jax import state_dict_from_jax
from madm_torch.models.madm import MADM, MADMConfig, init_random_, trainable_parameters
from madm_torch.models.sd import lora as plora
from madm_torch.ops import dacs, palette
from madm_torch.train.train_step import TrainConfig, make_train_state as port_state, pass_adapters, train_step
from test_torch_train import (ADAM_EPS, GRAD_ATOL_OF_MAX, GRAD_L2_RTOL, LR, RTOL, SEG_SCALE, STEP_KW,
                              _batch)
from torch_port_toy import TOY

LORA = ("default_r4_a8", "Depth_r4_a4")  # alpha != rank: scales 2 and 1
B_STD = 0.05


def _nonzero_b(lora_tree, seed):
    """The JAX adapters with every lora_b drawn N(0, B_STD^2)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * B_STD)
                    if k == "lora_b" else walk(v) if isinstance(v, dict) else v)
                for k, v in node.items()}

    return walk(lora_tree)


@pytest.fixture(scope="module")
def toy():
    """A toy eval model with adapters, its UNet as a JAX tree, and JAX
    adapters (peft init, then B nonzero)."""
    port = init_random_(MADM(MADMConfig(**TOY, compute_dtype=torch.float32, lora_configs=LORA),
                             device="cpu"), torch.Generator().manual_seed(0))
    unet = convert_unet_state({k: v.numpy() for k, v in port.unet.state_dict().items()})
    specs = jlora.parse_lora_configs(LORA)
    loras = {name: _nonzero_b(jlora.init_lora(unet, s["rank"], s["alpha"], rng=i), i)
             for i, (name, s) in enumerate(specs.items())}
    return port, unet, loras


@pytest.mark.parametrize("configs", [(), ("Depth_r16_a16",), LORA, ("Infrared_r8_a16", "Event_r2_a1")])
def test_parse_lora_configs_equals_jax(configs):
    assert plora.parse_lora_configs(configs) == jlora.parse_lora_configs(configs)


def test_parse_lora_configs_refuses_other_names():
    with pytest.raises(AssertionError):
        jlora.parse_lora_configs(["Thermal_r4_a4"])
    for bad in ("Thermal_r4_a4", "Depth_4_4", "Depth_r4"):
        with pytest.raises(ValueError, match="lora config"):
            plora.parse_lora_configs([bad])


def test_adapter_sites_and_init_equal_jax(toy):
    """The same sites with the same shapes as JAX ``init_lora``; peft's
    gaussian init: A ~ N(0, 1) / rank, B = 0."""
    port, unet, _ = toy
    ref = state_dict_from_jax({"params": {"lora": {"x": jlora.init_lora(unet, 4, rng=0)}}})
    adapter = plora.init_lora(port.unet, 4, torch.Generator().manual_seed(0))
    got = {f"lora.x.{k}": v for k, v in adapter.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in ref.items()}
    assert len(got) == 2 * 4 * 32  # q, k, v, out of 16 transformer blocks x 2 attentions
    a = torch.cat([v.flatten() for k, v in got.items() if k.endswith("lora_A")])
    assert all(not v.any() for k, v in got.items() if k.endswith("lora_B"))
    assert abs(a.std().item() * 4 - 1) < 0.05 and abs(a.mean().item()) < 0.01


@pytest.mark.parametrize("name", ["default", "Depth"])
def test_merge_lora_equals_jax(toy, name):
    """W + (alpha/r) (B @ A) on every adapted site against JAX's kernel +
    (a @ b) scale, with nonzero B; the other weights pass through."""
    port, unet, loras = toy
    spec = plora.parse_lora_configs(LORA)[name]
    scale = spec["alpha"] / spec["rank"]
    sd = state_dict_from_jax({"params": {"lora": {name: loras[name]}}})
    with torch.device("cpu"):
        adapter = plora.LoRAAdapter(port.unet, spec["rank"])
    adapter.load_state_dict({k[len(f"lora.{name}."):]: v for k, v in sd.items()}, strict=True)
    weights = dict(port.unet.named_parameters())
    merged = plora.merge_lora(weights, adapter, scale)
    ref = state_dict_from_jax({"params": {"unet": jlora.merge_lora(unet, loras[name], scale)}})
    changed = 0
    for k, w in merged.items():
        want = ref[f"unet.{k}"]
        assert w.shape == want.shape, k
        np.testing.assert_allclose(w.detach().numpy(), want.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
        changed += not torch.equal(w, weights[k])
    assert changed == 4 * 32
    assert plora.merge_lora(weights, None) == weights


def test_eval_model_merges_in_fp32_and_rounds_once():
    """A bf16 eval model keeps its adapters fp32; a merged weight is
    bf16(W + delta) with W the bf16 weight and the sum in fp32."""
    model = init_random_(MADM(MADMConfig(**TOY, compute_dtype=torch.bfloat16, lora_configs=LORA),
                              device="cpu"), torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    path, site = next(model.lora["default"].sites())
    with torch.no_grad():
        site.lora_B.copy_(torch.randn(site.lora_B.shape, generator=g))
    assert site.lora_A.dtype == torch.float32 and model.unet.conv_in.weight.dtype == torch.bfloat16
    w = model.unet.get_parameter(f"{path}.weight")
    merged = model.lora_weights("default")[f"{path}.weight"]
    want = (w.float() + (site.lora_B @ site.lora_A) * 2.0).bfloat16()
    assert merged.dtype == torch.bfloat16 and torch.equal(merged, want)
    assert model.lora_weights(None) == {} and model.lora_weights("Event") == {}


def test_merge_is_functional_and_reaches_a_and_b():
    """A train pass through an adapter leaves the module's weights as they
    were and puts a gradient on W, A and B; switching adapters between
    passes changes the features."""
    model = init_random_(MADM(MADMConfig(**TOY, compute_dtype=torch.float32, lora_configs=LORA),
                              device="cpu", trainable=True), torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for adapter in model.lora.values():
            for _, s in adapter.sites():
                s.lora_B.copy_(torch.randn(s.lora_B.shape, generator=g) * B_STD)
    names = {n for n, _ in model.named_parameters() if n.startswith("lora.")}
    trained = {n for n, _ in trainable_parameters(model)}
    assert names and names <= trained
    before = {k: v.clone() for k, v in model.unet.state_dict().items()}
    x = torch.rand(1, 64, 64, 3, generator=g)
    feats = {n: model.backbone_forward(x, lora_name=n, train=True)["output_features"]
             for n in ("default", "Depth")}
    sum(f.float().square().mean() for f in feats["Depth"].values()).backward()
    assert all(torch.equal(v, model.unet.state_dict()[k]) for k, v in before.items())
    site = dict(model.lora["Depth"].sites())
    path = next(iter(site))
    assert site[path].lora_A.grad.abs().sum() > 0 and site[path].lora_B.grad.abs().sum() > 0
    assert model.unet.get_parameter(f"{path}.weight").grad.abs().sum() > 0
    assert all(p.grad is None for _, p in model.lora["default"].named_parameters())
    assert not torch.equal(feats["default"]["s3"], feats["Depth"]["s3"])


def test_pass_adapters_follow_jax():
    """Source pass 'default', teacher and mixed passes the target modality's,
    each only where the model holds it (JAX ``train_step.py:290-292``)."""
    cases = {(): (None, None), ("Depth_r4_a4",): (None, "Depth"), ("default_r4_a4",): ("default", None),
             LORA: ("default", "Depth"), ("default_r4_a4", "Event_r4_a4"): ("default", None)}
    for configs, want in cases.items():
        model = MADM(MADMConfig(**TOY, compute_dtype=torch.float32, lora_configs=configs), device="cpu")
        assert pass_adapters(model) == want, configs


# ------------------------------------------------------ one toy train step
@pytest.fixture(scope="module")
def stepped():
    """``tests/test_torch_train.py``'s step with the two adapters: the JAX
    model's variables (B drawn nonzero) carried into the port by
    ``state_dict_from_jax``; both take one step from the same batch and DACS
    mask."""
    jm = JaxMADM(JaxMADMConfig(**TOY, compute_dtype=jnp.float32, lora_configs=LORA,
                               target_modality="Depth", train_palette=palette.DELIVER_11_PALETTE))
    jm.head = jm.head.clone(dropout_ratio=0.0)
    variables = jm.init_params(jax.random.PRNGKey(0))
    params = variables["params"]
    conv_seg = dict(params["head"]["conv_seg"], kernel=params["head"]["conv_seg"]["kernel"] * SEG_SCALE)
    lora = {name: _nonzero_b(tree, i) for i, (name, tree) in enumerate(params["lora"].items())}
    variables["params"] = dict(params, head=dict(params["head"], conv_seg=conv_seg), lora=lora)
    tc = JaxTrainConfig(**STEP_KW)
    trainable, _ = split_trainable(variables)
    tx = make_optimizer(trainable, base_lr=LR, max_iter=tc.max_iter)
    state = make_train_state(jm, variables, tx)
    batch = _batch()
    rng = jax.random.PRNGKey(42)
    new_state, metrics = jax.jit(make_train_step(jm, tc, tx))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    adam = [x for x in jax.tree_util.tree_leaves(new_state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(x, "mu")]
    mask = jdacs.sample_class_masks(jax.random.split(rng, 15)[0], jnp.asarray(batch["source_label"]), 11)

    model = MADM(MADMConfig(**TOY, compute_dtype=torch.float32, lora_configs=LORA), device="cpu",
                 trainable=True)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pstate = port_state(model, TrainConfig(lr=LR, **STEP_KW))
    draws = {"mix_mask": torch.from_numpy(np.array(mask)),
             "jitter": dacs.JitterDraw(False, 1.0, 1.0, 1.0, 0.0, (0, 1, 2, 3)),
             "blur": None, "t_pl": 60, "dropout": [None, None, None]}
    port_metrics = train_step(pstate, {k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
    grads = {n: pstate.optimizer.state[p]["exp_avg"] / 0.1 for n, p in model.named_parameters()
             if p.requires_grad}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "port_metrics": port_metrics,
            "grads": grads,
            "jax_grads": {k: v / 0.1 for k, v in state_dict_from_jax({"params": adam[0].mu}).items()},
            "new": state_dict_from_jax({"params": new_state.params}),
            "before": before, "model": model, "pstate": pstate}


def test_lora_step_losses_and_grad_norm_match_jax(stepped):
    ref, out = stepped["metrics"], stepped["port_metrics"]
    assert set(ref) == set(out) - {"step_ms"}
    assert 0.1 < ref["pseudo_val"] < 0.9 and ref["vae_decoder_target_loss"] > 0
    for key, val in ref.items():
        assert abs(out[key] - val) <= RTOL * max(abs(val), 1e-3), (key, out[key], val)


PREFIXES = ["lora.default.", "lora.Depth.", "unet.", "prompt.", "feature_projections.", "sem_seg_head."]


@pytest.mark.parametrize("prefix", PREFIXES)
def test_lora_step_gradients_match_jax(stepped, prefix):
    """Gradients to 2e-3 of the largest entry, and to 1e-2 in l2 for each
    tensor above fp32 noise; both adapters' A and B get one (the source pass
    takes 'default', the teacher and mixed passes 'Depth')."""
    grads, ref = stepped["grads"], stepped["jax_grads"]
    keys = [k for k in grads if k.startswith(prefix)]
    assert keys and set(grads) == set(ref)
    gmax = max(r.abs().max().item() for r in ref.values())
    for k in keys:
        err = (grads[k] - ref[k]).abs().max().item()
        assert err <= GRAD_ATOL_OF_MAX * gmax, (k, err, gmax)
        if ref[k].abs().max().item() > 1e-3 * gmax:
            rel = ((grads[k] - ref[k]).norm() / ref[k].norm()).item()
            assert rel <= GRAD_L2_RTOL, (k, rel)
    if prefix.startswith("lora."):
        for leaf in ("lora_A", "lora_B"):
            assert any(grads[k].abs().max() > 0 for k in keys if k.endswith(leaf)), leaf


@pytest.mark.parametrize("prefix", ["lora.default.", "lora.Depth."])
def test_lora_step_updates_match_jax(stepped, prefix):
    """The adapters' AdamW update within the bound of the gradients'
    difference (``tests/test_torch_train.py``), and every tensor moved."""
    lr0 = stepped["pstate"].schedule(0)
    new, state, before = stepped["new"], stepped["model"].state_dict(), stepped["before"]
    for k in (k for k in stepped["grads"] if k.startswith(prefix)):
        allowed = 1e-2 * lr0 + lr0 * (stepped["grads"][k] - stepped["jax_grads"][k]).abs() / ADAM_EPS
        assert ((state[k] - new[k]).abs() - allowed).max().item() <= 0, k
        assert not torch.equal(state[k], before[k]), k
