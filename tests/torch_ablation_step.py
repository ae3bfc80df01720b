"""One toy UDA step with ablation branches, the port against the JAX
package's ``make_train_step``, shared by ``tests/test_torch_ablation_step_*.py``.

``tests/test_torch_train.py``'s recipe: a toy MADM initialised by the JAX
package (fp32, the head's dropout 0, conv_seg scaled so that the teacher is
confident on part of the image), its variables carried into a trainable port
model by ``state_dict_from_jax``, one step on each side from the same batch.
The port takes every random value the JAX step drew from
``jax.random.split(rng, 15)``: the DACS mask, the teacher, denoise and
noise-reg timesteps (drawn from a range here), the MIC block scores, the
latent noise, the prompt ablations' values and the random_choice uniform.
Colour jitter (p = 1) and blur stay off, as in that test.  With ``fd`` or
``fd_attention`` the student's UNet and prompt are perturbed after the
baseline is taken, so that the feature distance and its gradient are not
zero.  ``tests/test_torch_variant_step_*.py`` run the model variants
through the same recipe.  The checks hold the
port to ``tests/test_torch_train.py``'s tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from madm_tpu.models.madm import MADM as JaxMADM
from madm_tpu.models.madm import MADMConfig as JaxMADMConfig
from madm_tpu.ops import dacs as jdacs
from madm_tpu.train import TrainConfig as JaxTrainConfig
from madm_tpu.train import make_optimizer, make_train_state, make_train_step, split_trainable
from madm_tpu.train.train_step import add_feature_distance_baseline as jax_add_baseline
from madm_torch.checkpoint.from_jax import state_dict_from_jax
from madm_torch.models.madm import MADM, MADMConfig, init_random_, trainable_parameters
from madm_torch.ops import dacs, palette
from madm_torch.train.train_step import TrainConfig, add_feature_distance_baseline, make_train_state as port_state
from madm_torch.train.train_step import train_step
from test_torch_lora import _nonzero_b
from test_torch_train import ADAM_EPS, GRAD_ATOL_OF_MAX, GRAD_L2_RTOL, LR, RTOL, SEG_SCALE, _batch
from torch_port_toy import TOY, jax_variables

STEP_KW = dict(color_jitter_probability=1.0, blur=False, denoise_timestep_range=(50, 70))
# relative N(0, 1) noise on the student's UNet and prompt under fd, so that
# the feature distance is not 0.  At 0.05 it perturbs every norm weight too
# and grad_norm reads 98: the fp32 gradient then sits 3.0e-3 of its largest
# entry from the fp64 one (the port in fp64, measured on the CPU), beyond the
# tolerance whichever side computes it; at 0.01, 7.9e-4
PERTURB = 0.01
NO_JITTER = dacs.JitterDraw(False, 1.0, 1.0, 1.0, 0.0, (0, 1, 2, 3))


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: v * (1 + PERTURB * jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))), tree)


def jax_draws(rng, labels, seq_len, tc):
    """The port's draws dict with the values the JAX step draws from ``rng``."""
    keys = jax.random.split(rng, 15)
    b, h, w = labels.shape
    lo, hi = tc.denoise_timestep_range

    def t(x):
        return torch.from_numpy(np.array(x))

    return {
        "mix_mask": t(jdacs.sample_class_masks(keys[0], jnp.asarray(labels), 11)),
        "jitter": NO_JITTER, "blur": None,
        "t_pl": int(jax.random.randint(keys[2], (), lo, hi + 1)),
        "dropout": [None] * 4,
        "mic_jitter": NO_JITTER, "mic_blur": None,
        "mic_mask": t(jax.random.uniform(keys[7], (b, round(h / 32), round(w / 32), 1))),
        "t_ds": t(jax.random.randint(keys[9], (b,), lo, hi + 1)),
        "nr_jitter": NO_JITTER, "nr_blur": None,
        "t_nr": t(jax.random.randint(keys[11], (b,), lo, hi + 1)),
        "latent_noise": t(jax.random.normal(keys[12], (b, h // 8, w // 8, 4))).permute(0, 3, 1, 2),
        "prompt": t(jax.random.uniform(keys[13], (1, seq_len, 1)) if tc.mask_prompt_ratio
                    else jax.random.normal(keys[13], (1, seq_len, 768))),
        "rand_prompt": t(jax.random.uniform(keys[14], (1, seq_len, 768))),
        "pl_choice": float(jax.random.uniform(jax.random.fold_in(rng, 99), ())),
    }


def run_group(model_kw, tc_kw, lora=(), unet_lr=None, jax_init=True):
    """One step of each package with the ablation settings ``model_kw``
    (MADMConfig fields, the same names in both) and ``tc_kw`` (TrainConfig
    fields); returns what the checks below read.  ``jax_init=False`` starts
    from the port's seeded weights through the JAX converter
    (``torch_port_toy.jax_variables``) instead of a flax init, ~70 s less."""
    jm = JaxMADM(JaxMADMConfig(**TOY, compute_dtype=jnp.float32, lora_configs=lora,
                               target_modality="Depth", train_palette=palette.DELIVER_11_PALETTE,
                               **model_kw))
    jm.head = jm.head.clone(dropout_ratio=0.0)
    if jax_init:
        variables = jm.init_params(jax.random.PRNGKey(0))
    else:
        seeded = init_random_(MADM(MADMConfig(**TOY, compute_dtype=torch.float32, **model_kw), device="cpu"),
                              torch.Generator().manual_seed(0))
        variables = jax_variables(seeded)
        variables["params"]["lora"] = {}
        variables["state"]["ema_head_bn"] = variables["state"]["head_bn"]
    params = variables["params"]
    conv_seg = dict(params["head"]["conv_seg"], kernel=params["head"]["conv_seg"]["kernel"] * SEG_SCALE)
    params = dict(params, head=dict(params["head"], conv_seg=conv_seg))
    if lora:
        params["lora"] = {name: _nonzero_b(tree, i) for i, (name, tree) in enumerate(params["lora"].items())}
    variables["params"] = params
    variables["ema"] = jm.init_ema(params)
    # a nonzero empty-prompt embedding: alpha_uncond_prompt gets a gradient,
    # and a prompt of another length reads it resized
    uncond = np.random.default_rng(3).standard_normal((1, 77, 768)).astype(np.float32)
    variables["consts"] = dict(variables["consts"], uncond_inputs=jnp.asarray(uncond))
    tc = JaxTrainConfig(**STEP_KW, **tc_kw)
    trainable, _ = split_trainable(variables, jm.cfg.finetune_unet)
    tx = make_optimizer(trainable, base_lr=LR, max_iter=tc.max_iter, unet_lr=unet_lr)
    state = make_train_state(jm, variables, tx)
    if tc.fd or tc.fd_attention:
        state = jax_add_baseline(state)
        state = state.replace(params=dict(state.params, unet=_perturbed(state.params["unet"], 1),
                                          prompt=_perturbed(state.params["prompt"], 2)))
    batch = _batch()
    extra = np.random.default_rng(5).uniform(size=(2, 2, 64, 64, 3)).astype(np.float32)
    batch.update(source_pl_data=extra[0], target_second_modality_pha=extra[1])
    rng = jax.random.PRNGKey(42)
    new_state, metrics = jax.jit(make_train_step(jm, tc, tx))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    adam = [x for x in jax.tree_util.tree_leaves(new_state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(x, "mu")]
    assert len(adam) == 1

    model = MADM(MADMConfig(**TOY, compute_dtype=torch.float32, lora_configs=lora, **model_kw),
                 device="cpu", trainable=True)
    model.load_state_dict(state_dict_from_jax({"params": state.params, "ema": state.ema,
                                               "state": state.state, "consts": state.consts}),
                          strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ptc = TrainConfig(lr=LR, unet_lr=unet_lr, **STEP_KW, **tc_kw)
    pstate = port_state(model, ptc)
    if ptc.fd or ptc.fd_attention:
        add_feature_distance_baseline(pstate)
        ori = state_dict_from_jax({"params": {"unet": state.consts["ori_unet"],
                                              "prompt": state.consts["ori_prompt"]}})
        for name, prefix in (("ori_unet", "unet."), ("ori_prompt", "prompt.")):
            pstate.consts[name].load_state_dict(
                {k[len(prefix):]: v for k, v in ori.items() if k.startswith(prefix)}, strict=True)
    seq_len = model.cfg.prompt_seq_len or 77
    draws = jax_draws(rng, batch["source_label"], seq_len, ptc)
    port_metrics = train_step(pstate, {k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
    grads = {n: pstate.optimizer.state[p]["exp_avg"] / 0.1 for n, p in model.named_parameters()
             if p.requires_grad}
    lr0 = pstate.schedule(0)
    lr_of = {n: lr0 * (unet_lr / LR if unet_lr is not None and n.startswith(("unet.", "lora.")) else 1.0)
             for n in grads}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "port_metrics": port_metrics,
            "grads": grads,
            "jax_grads": {k: v / 0.1 for k, v in state_dict_from_jax({"params": adam[0].mu}).items()},
            "new": state_dict_from_jax({"params": new_state.params, "ema": new_state.ema,
                                        "state": new_state.state}),
            "before": before, "model": model, "pstate": pstate, "lr": lr_of}


# ------------------------------------------------------------------- checks
def check_metrics(stepped, branch_keys):
    """Every loss, total_loss, pseudo_val, reg_prob_mean and grad_norm to
    1e-4 relative; the branches' losses present and nonzero."""
    ref, out = stepped["metrics"], stepped["port_metrics"]
    assert set(ref) == set(out) - {"step_ms"}
    assert 0.05 < ref["pseudo_val"] < 0.95  # the pseudo-weighted terms are live
    for key in branch_keys:
        assert abs(ref[key]) > 0, key
    for key, val in ref.items():
        assert abs(out[key] - val) <= RTOL * max(abs(val), 1e-3), (key, out[key], val)
    assert stepped["pstate"].step == 1


def check_gradients(stepped, prefix):
    """Gradients (Adam's first moment / 0.1) to 2e-3 of the largest entry,
    and to 1e-2 in l2 for every tensor above fp32 noise; the same trained
    names on both sides."""
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


def check_updates(stepped, prefix):
    """The AdamW update at each group's learning rate within the bound of
    the gradients' difference (``tests/test_torch_train.py``); each tensor
    moved."""
    new, state, before = stepped["new"], stepped["model"].state_dict(), stepped["before"]
    for k in (k for k in stepped["grads"] if k.startswith(prefix)):
        lr = stepped["lr"][k]
        allowed = 1e-2 * lr + lr * (stepped["grads"][k] - stepped["jax_grads"][k]).abs() / ADAM_EPS
        assert ((state[k] - new[k]).abs() - allowed).max().item() <= 0, k
        assert not torch.equal(state[k], before[k]), k


def check_frozen(stepped):
    """Every student tensor the optimizer does not hold is unchanged (the
    VAE, and the UNet weights ``finetune_unet`` freezes)."""
    model = stepped["model"]
    trained = {n for n, _ in trainable_parameters(model)}
    state, before = model.state_dict(), stepped["before"]
    frozen = [n for n, _ in model.named_parameters() if n not in trained and not n.startswith("ema.")]
    assert frozen
    for n in frozen:
        assert torch.equal(state[n], before[n]), n


def check_ema_and_bn(stepped):
    """The EMA tree after the step (step 0 copies the student) and the BN
    statistics of both heads, as ``tests/test_torch_train.py`` holds them."""
    new, state = stepped["new"], stepped["model"].state_dict()
    ema_keys = [k for k in new if k.startswith("ema.")
                and not k.endswith(("num_batches_tracked", "running_mean", "running_var"))]
    assert ema_keys and set(ema_keys) == {n for n, _ in stepped["model"].named_parameters()
                                          if n.startswith("ema.")}
    for k in ema_keys:
        assert (state[k] - new[k]).abs().max().item() <= 1e-6 * max(1.0, new[k].abs().max().item()), k
    for k in new:
        if k.endswith(("running_mean", "running_var")):
            assert (state[k] - new[k]).abs().max().item() <= 1e-5 * max(1.0, new[k].abs().max().item()), k
