"""The port's optimizer rules against optax 0.2.6 as the JAX package's
``make_optimizer`` calls it, on CPU: adamw (fp32 and bf16 first moment) and
adafactor (bf16 and fp32 momentum, and none), with ``unet_lr`` and the
weight-decay mask, over several clipped steps of one toy tree; and the
rules' traps one by one (the first update's zero decay, eps on g^2, the
factored axes by size, the bf16 ``b1 * m``, decay after the learning rate),
``state_dict`` round trips and the ``no_momentum`` refusal."""

import io

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from madm_tpu.train import optimizer as jopt
from madm_torch.train import optimizer
from madm_torch.train.train_step import TrainConfig

LR, WD, MAX_ITER, STEPS = 2e-2, 0.05, 100, 6


class _Toy(nn.Module):
    """A factored [in 256, out 320] dense, a square [128, 128] one under
    ``unet``, a [3,3,4,320] conv (under the factoring threshold), a 1-D
    bias and a norm scale."""

    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(256, 320)
        self.unet = nn.Linear(128, 128, bias=False)
        self.conv = nn.Conv2d(4, 320, 3)
        self.norm = nn.LayerNorm(320)


# port name -> (flax path, torch array -> flax array)
_FLAX = {
    "dense.weight": (("dense", "kernel"), lambda a: a.T),
    "dense.bias": (("dense", "bias"), lambda a: a),
    "unet.weight": (("unet", "kernel"), lambda a: a.T),
    "conv.weight": (("conv", "kernel"), lambda a: a.transpose(2, 3, 1, 0)),
    "conv.bias": (("conv", "bias"), lambda a: a),
    "norm.weight": (("norm", "scale"), lambda a: a),
    "norm.bias": (("norm", "bias"), lambda a: a),
}


def _to_flax(name, a):
    return _FLAX[name][1](a)


def _from_flax(name, a):
    """The inverse layout change (each map above is a transpose)."""
    if name == "conv.weight":
        return a.transpose(3, 2, 0, 1)
    return _FLAX[name][1](a)


def _tree(arrays):
    out = {}
    for name, a in arrays.items():
        (mod, leaf), _ = _FLAX[name]
        out.setdefault(mod, {})[leaf] = jnp.asarray(_to_flax(name, a))
    return out


def _leaf(tree, name):
    mod, leaf = _FLAX[name][0]
    return _from_flax(name, np.asarray(tree[mod][leaf]))


def _states(state, kind):
    """Every optax state of type ``kind`` inside a chain's nested tuples."""
    if isinstance(state, kind):
        return [state]
    if isinstance(state, tuple):
        return [s for x in state for s in _states(x, kind)]
    if hasattr(state, "inner_state"):
        return _states(state.inner_state, kind)
    return []


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (the spacing of bf16 numbers there)."""
    e = np.floor(np.log2(np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _bf16_moments(name, b1, mu_dtype):
    return b1 is not None and (mu_dtype == "bfloat16" or (name == "adafactor" and mu_dtype is None))


def _moment(opt_state, name, n):
    """optax's first moment (adamw's mu, adafactor's momentum) of ``n``."""
    if name == "adamw":
        return _leaf(_states(opt_state, optax.ScaleByAdamState)[0].mu, n)
    return _leaf(_states(opt_state, optax.EmaState)[0].ema, n)


def _within_bf16_ulp(got, ref):
    """One bf16 ulp of each stored moment, plus 1e-6 of the tensor's largest
    (an entry where (1 - b1) u and b1 m nearly cancel keeps fp32's error in
    u, many ulps of the small result)."""
    return bool((np.abs(got - ref) <= _bf16_ulp(ref) + 1e-6 * np.abs(ref).max()).all())


def _run(name, b1, mu_dtype, unet_lr, lr=LR, steps=STEPS):
    """``steps`` clipped updates of the toy tree by optax and by the port,
    from the same weights on the same gradients; returns both sides.

    A bf16 first moment rounds: where the two sides' fp32 moments straddle a
    rounding boundary, they store neighbours one bf16 ulp apart, and the
    next update differs by b1 times that ulp, far beyond fp32 rounding.  So
    with a bf16 moment each step checks the stored moments to one ulp, then
    hands the port optax's moments and parameters: every step's update is
    then held to 1e-6 from one state."""
    torch.manual_seed(0)
    model = _Toy()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_()
    named = list(model.named_parameters())
    # copies: jnp.asarray may alias a contiguous numpy buffer, which the
    # port then updates in place
    params = _tree({n: p.detach().numpy().copy() for n, p in named})
    tx = jopt.make_optimizer(params, base_lr=lr, weight_decay=WD, max_iter=MAX_ITER,
                             grad_clip=0.01, unet_lr=unet_lr, b1=b1, mu_dtype=mu_dtype, name=name)
    opt_state = tx.init(params)
    port = optimizer.make_optimizer(model, named, lr=lr, weight_decay=WD, betas=(b1, 0.999),
                                    unet_lr=unet_lr, name=name, mu_dtype=mu_dtype)
    sched = optimizer.lr_schedule(lr, MAX_ITER)
    rng = np.random.default_rng(1)
    for count in range(steps):
        grads = {n: (rng.normal(size=tuple(p.shape)) * 0.1).astype(np.float32) for n, p in named}
        if count == 2:
            grads["conv.bias"][:] = 0.0  # a zero gradient: eps keeps v > 0
        updates, opt_state = tx.update(_tree(grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        for n, p in named:
            p.grad = torch.from_numpy(grads[n].copy())
        optimizer.clip_by_global_norm_([p for _, p in named], 0.01)
        optimizer.set_lr(port, sched(count))
        port.step()
        if _bf16_moments(name, b1, mu_dtype) and count < steps - 1:
            with torch.no_grad():
                for n, p in named:
                    ref, m = _moment(opt_state, name, n), port.state[p]["exp_avg"]
                    got, ref32 = m.float().numpy(), ref.astype(np.float32)
                    assert _within_bf16_ulp(got, ref32), (count, n)
                    m.copy_(torch.from_numpy(ref32))
                    p.copy_(torch.from_numpy(_leaf(params, n).copy()))
    return dict(named), params, opt_state, port


CASES = [("adamw", 0.9, None), ("adamw", 0.9, "bfloat16"), ("adafactor", 0.9, None),
         ("adafactor", 0.9, "float32"), ("adafactor", None, None)]


@pytest.mark.parametrize("unet_lr", [None, 4 * LR])
@pytest.mark.parametrize("name,b1,mu_dtype", CASES)
def test_rule_matches_optax(name, b1, mu_dtype, unet_lr):
    named, params, opt_state, port = _run(name, b1, mu_dtype, unet_lr)
    for n, p in named.items():
        ref = _leaf(params, n)
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max(),
                                   err_msg=n)
    st = {n: port.state[p] for n, p in named.items()}
    if name == "adamw":
        (adam,) = _states(opt_state, optax.ScaleByAdamState)
        for n in named:
            ref = _leaf(adam.nu, n)
            np.testing.assert_allclose(st[n]["exp_avg_sq"].numpy(), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max(), err_msg=n)
        moments = {n: (st[n]["exp_avg"], _leaf(adam.mu, n)) for n in named}
    else:
        (fac,) = _states(opt_state, optax._src.factorized.FactoredState)
        for n in named:
            mod, leaf = _FLAX[n][0]
            if "v" in st[n]:
                pairs = [(_to_flax(n, st[n]["v"].numpy()), fac.v[mod][leaf])]
            else:  # 2-D: which of optax's vectors holds the means over torch's d0
                d0 = optimizer.factored_dims(tuple(named[n].shape))[1]
                same = 1 - d0 == optax._src.factorized._factored_dims(
                    tuple(fac.v_row[mod][leaf].shape) + (0,), True, 0) or True
                flax_d0 = optimizer.factored_dims(_to_flax(n, named[n].detach().numpy()).shape)[1]
                same = (1 - d0) == flax_d0
                pairs = [(st[n]["v_row"].numpy(), (fac.v_row if same else fac.v_col)[mod][leaf]),
                         (st[n]["v_col"].numpy(), (fac.v_col if same else fac.v_row)[mod][leaf])]
            for k, (got, ref) in enumerate(pairs):
                ref = np.asarray(ref)
                np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max(),
                                           err_msg=f"{n} {k}")
        emas = _states(opt_state, optax.EmaState)
        if b1 is None:
            assert not emas and all("exp_avg" not in s for s in st.values())
            return
        moments = {n: (st[n]["exp_avg"], _leaf(emas[0].ema, n)) for n in named}
    for n, (got, ref) in moments.items():
        want = torch.bfloat16 if _bf16_moments(name, b1, mu_dtype) else torch.float32
        assert got.dtype == want and str(ref.dtype) == str(want).split(".")[-1], n
        got, ref = got.float().numpy(), ref.astype(np.float32)
        # a moment sums gradients of either sign: 1e-6 of its largest entry
        # absolutely (the clip's scale rounds differently on each side)
        tol = 1e-6 * np.abs(ref).max()
        if want == torch.bfloat16:
            assert _within_bf16_ulp(got, ref), n
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=tol, err_msg=n)


def test_factored_dims_by_size():
    # optax's picks on the flax layouts, and the port's on torch's
    assert optimizer.factored_dims((256, 320)) == (0, 1)      # flax [in, out]
    assert optimizer.factored_dims((320, 256)) == (1, 0)      # torch [out, in]
    assert optimizer.factored_dims((3, 3, 320, 640)) == (2, 3)
    assert optimizer.factored_dims((640, 320, 3, 3)) == (1, 0)
    assert optimizer.factored_dims((320, 4, 3, 3)) is None    # second largest 4 < 128
    assert optimizer.factored_dims((128, 128)) == (0, 1)
    assert optimizer.factored_dims((320,)) is None
    for shape in ((256, 320), (3, 3, 320, 640), (3, 3, 4, 320), (128, 128), (127, 500)):
        assert optimizer.factored_dims(shape) == optax._src.factorized._factored_dims(shape, True, 128)


def test_first_update_has_no_decay_and_eps_on_g2():
    """d = 1 - 1^-0.8 = 0 at the first update: v is g^2 + eps itself, and a
    zero gradient leaves v = eps and the update 0 (eps on g^2, not on the
    root)."""
    p = nn.Parameter(torch.ones(5))
    opt = optimizer.Adafactor([p], lr=0.1, b1=None, weight_decay=0.0)
    p.grad = torch.tensor([0.0, 1.0, -2.0, 3e-20, 0.5])
    opt.step()
    np.testing.assert_array_equal(opt.state[p]["v"].numpy(), (p.grad * p.grad + 1e-30).numpy())
    assert p[0].item() == 1.0 and torch.isfinite(p).all()
    p.grad = torch.tensor([0.0, 1.0, 1.0, 1.0, 1.0])
    v0 = opt.state[p]["v"].clone()
    opt.step()  # d = 1 - 2^-0.8 at the second
    d = np.float32(1) - np.float32(2) ** np.float32(-0.8)
    np.testing.assert_allclose(opt.state[p]["v"].numpy(),
                               (d * v0 + (1 - d) * (p.grad * p.grad + 1e-30)).numpy(), rtol=1e-7)


def test_bf16_momentum_product_is_bf16():
    """optax on a bf16 moment: b1 * m rounds to bf16 before the fp32 add."""
    m = torch.tensor([1.2345678], dtype=torch.bfloat16)
    g = torch.tensor([0.1])
    port = (g * (1 - 0.9) + optimizer._decayed_moment(m, 0.9)).item()
    ref = float(optax.tree.update_moment(jnp.asarray([0.1], jnp.float32),
                                         jnp.asarray([1.2345678], jnp.bfloat16), 0.9, 1)[0])
    assert port == ref == pytest.approx(1.119375, abs=1e-7)
    assert abs(ref - 1.1209375) > 1e-3  # not the fp32 product


@pytest.mark.parametrize("name,b1", [("adafactor", 0.9), ("adafactor", None)])
def test_decay_after_lr(name, b1):
    """Weight decay is added after the learning rate: at lr = 0 a decayed
    weight still shrinks by wd a step, as in optax; biases and norm scales
    stay."""
    named, params, _, _ = _run(name, b1, None, None, lr=0.0, steps=2)
    for n, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), _leaf(params, n), rtol=1e-6, atol=1e-7)
    torch.manual_seed(0)
    start = dict(_Toy().named_parameters())  # the same seed's first draw, before normal_
    for n, p in named.items():
        ref = _leaf(params, n)
        if n in ("dense.bias", "conv.bias", "norm.weight", "norm.bias"):
            continue
        assert not np.allclose(ref, start[n].detach().numpy())
    # one step by hand: p * (1 - wd) exactly as optax rounds p - wd * p
    p = nn.Parameter(torch.tensor([1.0, -2.0, 0.5]))
    opt = optimizer.Adafactor([p], lr=0.0, b1=b1, weight_decay=WD)
    p.grad = torch.tensor([1.0, 1.0, 1.0])
    w = p.detach().clone()
    opt.step()
    np.testing.assert_array_equal(p.detach().numpy(), (w + -(w * WD)).numpy())


@pytest.mark.parametrize("name,b1,mu_dtype", CASES)
def test_state_dict_round_trip(name, b1, mu_dtype):
    """Three steps, state_dict into a fresh optimizer over copies of the
    parameters, one more step on each: equal parameters and states, the
    moments in their own dtype, the factored rows and columns kept."""
    named, _, _, port = _run(name, b1, mu_dtype, 4 * LR, steps=3)
    copy = _Toy()
    copy.load_state_dict({n: p.detach().clone() for n, p in named.items()})
    cnamed = list(copy.named_parameters())
    other = optimizer.make_optimizer(copy, cnamed, lr=LR, weight_decay=WD, betas=(b1, 0.999),
                                     unet_lr=4 * LR, name=name, mu_dtype=mu_dtype)
    buf = io.BytesIO()  # through a file, as a checkpoint goes
    torch.save(port.state_dict(), buf)
    buf.seek(0)
    other.load_state_dict(torch.load(buf, weights_only=True))
    rng = np.random.default_rng(5)
    for (n, p), (_, q) in zip(named.items(), cnamed):
        p.grad = torch.from_numpy((rng.normal(size=tuple(p.shape)) * 0.1).astype(np.float32))
        q.grad = p.grad.clone()
    for opt in (port, other):
        optimizer.set_lr(opt, LR)
        opt.step()
    for (n, p), (_, q) in zip(named.items(), cnamed):
        assert torch.equal(p, q), n
        a, b = port.state[p], other.state[q]
        assert a.keys() == b.keys() and a["step"] == b["step"] == 4
        for k in a:
            if k != "step":
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (n, k)
    if name == "adafactor":
        assert "v_row" in port.state[named["dense.weight"]] and "v" in port.state[named["conv.weight"]]


def test_no_momentum_is_adafactor_only():
    model = _Toy()
    with pytest.raises(ValueError, match="no_momentum"):
        optimizer.make_optimizer(model, list(model.named_parameters()), betas=(None, 0.999))
    with pytest.raises(ValueError, match="no_momentum"):
        jopt.make_optimizer(_tree({n: p.detach().numpy() for n, p in model.named_parameters()}),
                            b1=None)
    with pytest.raises(ValueError, match="no_momentum"):
        TrainConfig(b1=None)
    assert TrainConfig(optimizer="adafactor", b1=None).b1 is None
