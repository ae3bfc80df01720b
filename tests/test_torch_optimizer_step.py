"""One toy UDA step with ``optimizer.name='adafactor'`` (bf16 momentum, the
JAX package's default for it) against JAX's ``make_train_step`` with
``make_optimizer(name='adafactor')``, on CPU, in the setting of
``tests/test_torch_train.py`` (its toy model, batch, draws and tolerances):
the losses and grad_norm, the optimizer's state (factored rows and columns
where the rule factors, the momentum), the updated parameters, and the
frozen ones.  A module of its own, so that its JAX compile runs on a worker
of its own."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from madm_tpu.ops import dacs as jdacs
from madm_tpu.train import TrainConfig as JaxTrainConfig, make_optimizer, make_train_state, split_trainable
from madm_torch.checkpoint.from_jax import state_dict_from_jax
from madm_torch.models.madm import MADM, MADMConfig
from madm_torch.ops import dacs, palette
from madm_torch.train.optimizer import factored_dims
from madm_torch.train.train_step import TrainConfig, make_train_state as port_state, train_step
from test_torch_train import GRAD_ATOL_OF_MAX, LR, RTOL, SEG_SCALE, STEP_KW, TOY, _batch
from torch_port_toy import jax_madm, jax_train_step

B1 = 0.9
# The momentum after one step is (1 - b1) lr u, read back from bf16 (half
# an ulp: 2^-8 of it at most, on each side).  u has the gradient's sign
# (the rule's factors are positive): it must agree wherever the gradient
# stands clear of the two sides' gradient error (2 * GRAD_ATOL_OF_MAX of
# the largest entry).  Where the rule does not factor, u = g / sqrt(g^2 +
# 1e-30) is that sign: the two agree to the bf16 read-back, 2^-7.  Where it
# factors, u = g (r / mean r)^-1/2 c^-1/2 is the gradient in units of its
# row's and column's rms; a row of fp32 noise is scaled up to O(1) too, so
# u is compared only on a tensor's large entries (a quarter of its largest
# gradient or more) of tensors whose gradient is more than fp32 noise,
# relatively, to 2^-6 (measured 2^-7: the read-back).
U_SIGN_TOL = 2 ** -7
U_FACTORED_TOL = 2 ** -6


@pytest.fixture(scope="module")
def stepped():
    jm = jax_madm(**TOY, compute_dtype=jnp.float32, train_palette=palette.DELIVER_11_PALETTE)
    jm.head = jm.head.clone(dropout_ratio=0.0)
    # a flax init: on the port's seeded weights one pixel of the teacher's
    # confidence sits at the pseudo-label threshold, within fp32 noise, and
    # the two packages put it on either side (pseudo_val 1/8192 apart)
    variables = jm.init_params(jax.random.PRNGKey(0))
    params = variables["params"]
    conv_seg = dict(params["head"]["conv_seg"], kernel=params["head"]["conv_seg"]["kernel"] * SEG_SCALE)
    variables["params"] = dict(params, head=dict(params["head"], conv_seg=conv_seg))
    tc = JaxTrainConfig(**STEP_KW)
    trainable, _ = split_trainable(variables)
    tx = make_optimizer(trainable, base_lr=LR, max_iter=tc.max_iter, b1=B1, name="adafactor")
    state = make_train_state(jm, variables, tx)
    batch = _batch()
    rng = jax.random.PRNGKey(42)
    new_state, metrics = jax_train_step(jm, tc, tx)(state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    (ema,) = [x for x in jax.tree_util.tree_leaves(
        new_state.opt_state, is_leaf=lambda x: isinstance(x, optax.EmaState))
        if isinstance(x, optax.EmaState)]
    mask = jdacs.sample_class_masks(jax.random.split(rng, 15)[0],
                                    jnp.asarray(batch["source_label"]), 11)

    model = MADM(MADMConfig(**TOY, compute_dtype=torch.float32), device="cpu", trainable=True)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pstate = port_state(model, TrainConfig(lr=LR, optimizer="adafactor", **STEP_KW))
    draws = {"mix_mask": torch.from_numpy(np.array(mask)),
             "jitter": dacs.JitterDraw(False, 1.0, 1.0, 1.0, 0.0, (0, 1, 2, 3)),
             "blur": None, "t_pl": 60, "dropout": [None, None, None]}
    port_metrics = train_step(pstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                              draws=draws)
    lr0 = pstate.schedule(0)
    named = {n: p for n, p in model.named_parameters() if p.requires_grad}
    jax_m = state_dict_from_jax({"params": jax.tree.map(lambda a: a.astype(jnp.float32), ema.ema)})
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "port_metrics": port_metrics,
            "lr0": lr0, "named": named, "pstate": pstate,
            "u": {n: pstate.optimizer.state[p]["exp_avg"].float() / ((1 - B1) * lr0)
                  for n, p in named.items()},
            "jax_u": {n: jax_m[n] / ((1 - B1) * lr0) for n in named},
            "grads": {n: p.grad.clone() for n, p in named.items()},  # clipped, as the rule saw them
            "new": state_dict_from_jax({"params": new_state.params, "ema": new_state.ema,
                                        "state": new_state.state}),
            "before": before, "model": model}


def test_adafactor_step_losses_and_grad_norm_match_jax(stepped):
    ref, out = stepped["metrics"], stepped["port_metrics"]
    assert set(ref) == set(out)
    assert 0.1 < ref["pseudo_val"] < 0.9
    for key, val in ref.items():
        assert abs(out[key] - val) <= RTOL * max(abs(val), 1e-3), (key, out[key], val)
    assert stepped["pstate"].step == 1


def test_adafactor_state_layout(stepped):
    """The factored statistics on the two largest axes where the second is
    at least 128, one v elsewhere; a bf16 momentum; nothing of Adam's."""
    opt = stepped["pstate"].optimizer
    factored = 0
    for n, p in stepped["named"].items():
        st = opt.state[p]
        dims = factored_dims(tuple(p.shape))
        if dims is None:
            assert set(st) == {"step", "v", "exp_avg"} and st["v"].shape == p.shape, n
        else:
            factored += 1
            shape = list(p.shape)
            assert set(st) == {"step", "v_row", "v_col", "exp_avg"}, n
            assert list(st["v_row"].shape) == shape[:dims[1]] + shape[dims[1] + 1:], n
            assert list(st["v_col"].shape) == shape[:dims[0]] + shape[dims[0] + 1:], n
        assert st["exp_avg"].dtype == torch.bfloat16 and st["step"] == 1, n
    assert factored > 50  # the toy UNet's 128-wide and wider kernels


PREFIXES = ["unet.", "prompt.", "feature_projections.", "sem_seg_head."]


@pytest.mark.parametrize("prefix", PREFIXES)
def test_adafactor_momentum_matches_jax(stepped, prefix):
    grads, u, ref = stepped["grads"], stepped["u"], stepped["jax_u"]
    gmax = max(g.abs().max().item() for g in grads.values())
    keys = [k for k in u if k.startswith(prefix)]
    assert keys and set(u) == set(ref)
    for k in keys:
        sure = grads[k].abs() > 2 * GRAD_ATOL_OF_MAX * gmax
        assert torch.equal(u[k][sure].sign(), ref[k][sure].sign()), k
        if factored_dims(tuple(u[k].shape)) is None:
            err = (u[k] - ref[k]).abs()[sure]
            assert not sure.any() or err.max().item() <= U_SIGN_TOL, (k, err.max().item())
        elif grads[k].abs().max().item() > 1e-3 * gmax:
            big = grads[k].abs() >= 0.25 * grads[k].abs().max()
            err = ((u[k] - ref[k]).abs()[big] / ref[k].abs()[big]).max().item()
            assert err <= U_FACTORED_TOL, (k, err)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_adafactor_updated_parameters_match_jax(stepped, prefix):
    """p - (lr (1 - b1) u + wd p): the two sides may part by lr (1 - b1)
    |u_port - u_jax| (each side's u, read back from its bf16 momentum, so
    plus half a bf16 ulp, 2^-8 of it, on each side), 1% of lr, and two fp32
    ulps of the weight."""
    lr0 = stepped["lr0"]
    new, state, before = stepped["new"], stepped["model"].state_dict(), stepped["before"]
    u, ref = stepped["u"], stepped["jax_u"]
    for k in [k for k in u if k.startswith(prefix)]:
        allowed = (1e-2 * lr0 + lr0 * (1 - B1) * ((u[k] - ref[k]).abs()
                                                  + 2 ** -7 * torch.maximum(u[k].abs(), ref[k].abs()))
                   + 2 * torch.finfo(torch.float32).eps * new[k].abs())
        excess = ((state[k] - new[k]).abs() - allowed).max().item()
        assert excess <= 0, (k, excess)
        assert not torch.equal(state[k], before[k]), k


def test_adafactor_frozen_parameters_unchanged(stepped):
    state, before = stepped["model"].state_dict(), stepped["before"]
    for k in state:
        if k.startswith(("vae.", "unet.conv_out.", "unet.conv_norm_out.")):
            assert torch.equal(state[k], before[k]), k
