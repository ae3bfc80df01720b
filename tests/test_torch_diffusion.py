"""The port's diffusion library (``madm_torch/models/diffusion.py``) against
the JAX package's (``madm_tpu/models/diffusion.py``) on the CPU.

Schedules, respacing and the fp32 tables exactly; the moments, the
variational bound, the training losses and the samplers at 1e-5 x max(1,
max|ref|), on the same inputs and, where JAX draws, on its draws handed in.
Each JAX function is compiled alone with ``jax.jit``.  JAX tensors are NHWC,
the port's NCHW; the model functions are analytic and elementwise but for a
learned-range model's extra channels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from madm_tpu.models import diffusion as jd
from madm_torch.models import diffusion as td

TOL = 1e-5
SHAPE = (2, 4, 4, 3)  # JAX [B, H, W, C]; the port's [B, C, H, W]


def nchw(a) -> torch.Tensor:
    a = torch.from_numpy(np.array(a, np.float32))
    return a.permute(0, 3, 1, 2) if a.ndim == 4 else a


def nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


def assert_close(got: torch.Tensor, ref, tol=TOL, what=""):
    ref = np.asarray(ref)
    got = nhwc(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), f"{what}: {err} against max|ref| {np.abs(ref).max()}"


def jax_eps(x, t):  # analytic eps model, t the model-facing timestep
    return 0.4 * jnp.tanh(x) + (t.astype(jnp.float32) / 1000.0 - 0.5)[:, None, None, None] * 0.2


def port_eps(x, t):
    return 0.4 * torch.tanh(x) + (t.float() / 1000.0 - 0.5)[:, None, None, None] * 0.2


def jax_learned(x, t):
    return jnp.concatenate([jax_eps(x, t), 0.9 * jnp.sin(x + t.astype(jnp.float32)[:, None, None, None])], -1)


def port_learned(x, t):
    return torch.cat([port_eps(x, t), 0.9 * torch.sin(x + t.float()[:, None, None, None])], 1)


MODELS = {"fixed_small": (jax_eps, port_eps), "fixed_large": (jax_eps, port_eps),
          "learned_range": (jax_learned, port_learned)}


def x0_like(seed):
    """Images in [-1, 1] with exact +-1 pixels (the likelihood's edge bins)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    a[0, 0, :2] = 1.0
    a[1, 1, :2] = -1.0
    return a


def pair(steps=1000, schedule="ldm_linear", respacing=None):
    return (jd.GaussianDiffusion.create(steps, schedule, respacing),
            td.GaussianDiffusion.create(steps, schedule, respacing))


@pytest.mark.parametrize("name", ["linear", "ldm_linear", "scaled_linear", "cosine"])
@pytest.mark.parametrize("steps", [1000, 50])
def test_beta_schedules_equal(name, steps):
    np.testing.assert_array_equal(td.get_named_beta_schedule(name, steps),
                                  jd.get_named_beta_schedule(name, steps))


@pytest.mark.parametrize("spec", ["ddim25", "ldm_ddim8", "10,5", "7", "ddim50", "3,0,4"])
@pytest.mark.parametrize("steps", [1000, 100])
def test_space_timesteps_equal(spec, steps):
    assert td.space_timesteps(steps, spec) == jd.space_timesteps(steps, spec)


def test_space_timesteps_rounds_ties_to_even():
    """'3' over 6 steps strides 2.5: round(2.5) is 2 (Python's ties to
    even), not 3; '3' over 4 steps strides 1.5: round(1.5) is 2."""
    assert td.space_timesteps(6, "3") == jd.space_timesteps(6, "3") == {0, 2, 5}
    assert td.space_timesteps(4, "3") == jd.space_timesteps(4, "3") == {0, 2, 3}
    with pytest.raises(ValueError):
        td.space_timesteps(10, "ddim7")


@pytest.mark.parametrize("schedule", ["ldm_linear", "linear", "cosine"])
@pytest.mark.parametrize("respacing", [None, "ddim25", "ldm_ddim8", "10,5"])
def test_tables_exact(schedule, respacing):
    """betas, alphas_cumprod and its shift equal JAX's fp32 tables bit for
    bit, eager and compiled; the respaced betas and the map too."""
    jg, tg = pair(1000, schedule, respacing)
    np.testing.assert_array_equal(tg.betas, jg.betas)
    if respacing is None:
        assert tg.timestep_map is None and jg.timestep_map is None
    else:
        np.testing.assert_array_equal(tg.timestep_map, jg.timestep_map)
    for ref in (jg._tables(), jax.jit(jg._tables)()):
        for got, r in zip(tg.tables(), ref):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(r))


@pytest.mark.parametrize("respacing", [None, "ldm_ddim8"])
def test_forward_moments(respacing):
    jg, tg = pair(1000, "ldm_linear", respacing)
    n = jg.num_timesteps
    x0, xt, noise = x0_like(0), x0_like(1) * 1.3, np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    t = np.array([0, n - 1], np.int32)
    tt = torch.from_numpy(t)
    assert_close(tg.q_sample(nchw(x0), tt, nchw(noise)), jax.jit(jg.q_sample)(x0, t, noise), what="q_sample")
    jm, jv = jax.jit(jg.q_posterior_mean_variance)(x0, xt, t)
    tm, tv = tg.q_posterior_mean_variance(nchw(x0), nchw(xt), tt)
    assert_close(tm, jm, what="posterior mean")
    assert_close(tv.reshape(-1), np.asarray(jv).reshape(-1), what="posterior var")
    assert_close(tg.predict_x0_from_eps(nchw(xt), tt, nchw(noise)),
                 jax.jit(jg.predict_x0_from_eps)(xt, t, noise), what="x0 from eps")
    jm, jv, jl = jax.jit(jg.q_mean_variance)(x0, t)
    tm, tv, tl = tg.q_mean_variance(nchw(x0), tt)
    assert_close(tm, jm, what="q mean")
    for got, ref in ((tv, jv), (tl, jl)):
        assert_close(got.reshape(-1), np.asarray(ref).reshape(-1), what="q var / log var")
    assert_close(tg._prior_bpd(nchw(x0)), jax.jit(jg._prior_bpd)(x0), what="prior bpd")


@pytest.mark.parametrize("var_type", list(MODELS))
@pytest.mark.parametrize("clip", [True, False])
def test_p_mean_variance(var_type, clip):
    jg, tg = pair(1000, "ldm_linear", "ddim25")
    jf, tf = MODELS[var_type]
    xt = x0_like(3) * 2.0
    fn = jax.jit(lambda x, t: jg.p_mean_variance(jf, x, t, clip, var_type))
    for t in (np.array([0, 1], np.int32), np.array([24, 7], np.int32)):
        ref = fn(xt, t)
        got = tg.p_mean_variance(tf, nchw(xt), torch.from_numpy(t), clip, var_type)
        for k in ("mean", "pred_xstart"):
            assert_close(got[k], ref[k], what=f"{var_type} {k} t={t}")
        for k in ("variance", "log_variance"):
            r = np.broadcast_to(np.asarray(ref[k]), SHAPE)
            assert_close(got[k].expand(SHAPE[0], SHAPE[3], *SHAPE[1:3]), r, what=f"{var_type} {k} t={t}")


@pytest.mark.parametrize("var_type", list(MODELS))
def test_vb_terms_bpd(var_type):
    """The KL terms and, at t = 0, the decoder NLL, with x_t near x0 (the
    model's mean within a few of its std of x0, as at t = 0 in use)."""
    jg, tg = pair(1000, "ldm_linear", "ldm_ddim8")
    jf, tf = MODELS[var_type]
    x0 = x0_like(4)
    xt = x0 + 0.02 * np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    fn = jax.jit(lambda a, b, t: jg._vb_terms_bpd(jf, a, b, t, True, var_type))
    for t in (np.array([0, 0], np.int32), np.array([1, 7], np.int32), np.array([0, 5], np.int32)):
        ref = fn(x0, xt, t)
        got = tg._vb_terms_bpd(tf, nchw(x0), nchw(xt), torch.from_numpy(t), True, var_type)
        assert_close(got["output"], ref["output"], what=f"vb {var_type} t={t}")
        assert_close(got["pred_xstart"], ref["pred_xstart"], what="pred_xstart")


def test_vb_terms_bpd_decoder_nll_in_the_fp32_tails():
    """With the model's mean far from x0 (std 0.041 at t = 0, |x0 - mean| up
    to ~1), the fp32 likelihood's cdf saturates: XLA's and torch's fp32 tanh
    saturate at different points, and the two fp32 NLLs part by ~0.7 bits.
    Both are held to JAX's fp64 evaluation of the same terms, and the
    port's error must not exceed JAX's fp32 error."""
    jg, tg = pair(1000, "ldm_linear", "ldm_ddim8")
    x0 = x0_like(4)
    xt = x0 * 0.8 + 0.3 * np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    t = np.array([0, 0], np.int32)
    ref32 = np.asarray(jax.jit(lambda a, b, t: jg._vb_terms_bpd(jax_eps, a, b, t)["output"])(x0, xt, t))
    with jax.enable_x64(True):
        ref64 = np.asarray(jax.jit(lambda a, b, t: jg._vb_terms_bpd(jax_eps, a, b, t)["output"])(
            x0.astype(np.float64), xt.astype(np.float64), t))
    assert ref64.dtype == np.float64
    got = tg._vb_terms_bpd(port_eps, nchw(x0), nchw(xt), torch.from_numpy(t))["output"].numpy()
    assert (np.abs(got - ref64) <= np.abs(ref32 - ref64) + TOL * np.abs(ref64)).all(), (got, ref32, ref64)


@pytest.mark.parametrize("loss_type", ["mse", "rescaled_mse", "kl", "rescaled_kl"])
@pytest.mark.parametrize("mean_type", ["epsilon", "xstart", "xprev"])
def test_training_losses(loss_type, mean_type):
    jg, tg = pair(1000, "ldm_linear", "ddim25")
    x0 = x0_like(6)
    noise = np.random.default_rng(7).standard_normal(SHAPE).astype(np.float32)
    t = np.array([0, 13], np.int32)
    ref = jax.jit(lambda a, t, n: jg.training_losses(jax_eps, a, t, n, loss_type=loss_type,
                                                     model_mean_type=mean_type))(x0, t, noise)
    got = tg.training_losses(port_eps, nchw(x0), torch.from_numpy(t), nchw(noise), loss_type=loss_type,
                             model_mean_type=mean_type)
    assert got.keys() == ref.keys()
    for k in ref:
        assert_close(got[k], ref[k], what=f"{loss_type} {mean_type} {k}")


@pytest.mark.parametrize("loss_type", ["mse", "rescaled_mse"])
def test_training_losses_learned_range_detaches_the_mean(loss_type):
    """The vb term sees the model's eps detached: the losses and their
    gradient in the model's two scalar weights equal ``jax.grad``'s."""
    jg, tg = pair(1000, "ldm_linear", "ddim25")
    x0 = x0_like(8)
    noise = np.random.default_rng(9).standard_normal(SHAPE).astype(np.float32)
    t = np.array([3, 20], np.int32)
    w0 = np.array([0.7, 0.3], np.float32)

    def jloss(w, x0, t, noise):
        f = lambda x, tt: jnp.concatenate([w[0] * jnp.tanh(x), w[1] * jnp.sin(x)], -1)
        terms = jg.training_losses(f, x0, t, noise, loss_type=loss_type, model_var_type="learned_range")
        return terms["loss"].sum(), terms

    (_, ref), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(w0, x0, t, noise)
    w = torch.tensor(w0, requires_grad=True)
    f = lambda x, tt: torch.cat([w[0] * torch.tanh(x), w[1] * torch.sin(x)], 1)
    got = tg.training_losses(f, nchw(x0), torch.from_numpy(t), nchw(noise), loss_type=loss_type,
                             model_var_type="learned_range")
    got["loss"].sum().backward()
    assert set(got) == set(ref) == {"vb", "mse", "loss"}
    for k in ref:
        assert_close(got[k], ref[k], what=k)
    assert_close(w.grad, jgrad, what="grad")


def jax_draws(rng, n, shape, split_first):
    """The normals a JAX loop draws: the initial x (from a split of ``rng``
    when ``split_first``, else ``rng`` itself), then one a step."""
    out = []
    if split_first:
        rng, k0 = jax.random.split(rng)
        out.append(jax.random.normal(k0, shape))
    else:
        out.append(jax.random.normal(rng, shape))
    for _ in range(n):
        rng, k = jax.random.split(rng)
        out.append(jax.random.normal(k, shape))
    return [nchw(a) for a in out]


@pytest.mark.parametrize("respacing", ["ldm_ddim8"])
def test_p_sample_loop(respacing):
    jg, tg = pair(1000, "ldm_linear", respacing)
    rng = jax.random.PRNGKey(11)
    ref = jax.jit(lambda r: jg.p_sample_loop(jax_eps, SHAPE, r))(rng)
    draws = jax_draws(rng, jg.num_timesteps, SHAPE, split_first=True)
    got = tg.p_sample_loop(port_eps, (SHAPE[0], SHAPE[3], *SHAPE[1:3]), draws=draws)
    assert_close(got, ref, what="p_sample_loop")


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("respacing", ["ddim10", "ldm_ddim8"])
def test_ddim_sample_loop(eta, respacing):
    jg, tg = pair(1000, "ldm_linear", respacing)
    rng = jax.random.PRNGKey(12)
    ref = jax.jit(lambda r: jg.ddim_sample_loop(jax_eps, SHAPE, r, eta=eta))(rng)
    draws = jax_draws(rng, jg.num_timesteps, SHAPE, split_first=False)
    got = tg.ddim_sample_loop(port_eps, (SHAPE[0], SHAPE[3], *SHAPE[1:3]), eta=eta, draws=draws)
    assert_close(got, ref, what=f"ddim eta={eta}")


def test_sample_loops_draw_from_a_generator():
    """Without handed-in draws the loops draw from the generator: seeded,
    reproducible, finite."""
    _, tg = pair(1000, "ldm_linear", "ddim10")
    shape = (2, 3, 4, 4)
    for loop in (tg.p_sample_loop, tg.ddim_sample_loop):
        a = loop(port_eps, shape, torch.Generator().manual_seed(0), device="cpu")
        b = loop(port_eps, shape, torch.Generator().manual_seed(0), device="cpu")
        assert torch.equal(a, b) and torch.isfinite(a).all() and a.shape == shape


@pytest.mark.parametrize("var_type", list(MODELS))
def test_calc_bpd_loop(var_type):
    """The whole bound over an 8-step respacing, [B, T] in timestep order.
    The t = 0 column of ``vb`` (and ``total_bpd``, its sum) holds the
    decoder NLL of x0's exact +-1 pixels, whose edge bins take 1 + tanh(z)
    in fp32 near z = -3: XLA's and torch's tanh part it by up to ~1.5e-5
    relative ('fixed_large'; the tails test above holds it to fp64).  That
    column is held at 1e-4, the rest at 1e-5."""
    jg, tg = pair(1000, "ldm_linear", "ddim8")
    jf, tf = MODELS[var_type]
    x0 = x0_like(13)
    rng = jax.random.PRNGKey(14)
    ref = jax.jit(lambda a, r: jg.calc_bpd_loop(jf, a, r, True, var_type))(x0, rng)
    draws = jax_draws(rng, jg.num_timesteps, SHAPE, split_first=False)[1:]  # no initial x
    got = tg.calc_bpd_loop(tf, nchw(x0), clip_denoised=True, model_var_type=var_type, draws=draws)
    assert got.keys() == ref.keys()
    assert got["vb"].shape == (SHAPE[0], 8)
    for k in ("prior_bpd", "xstart_mse", "mse"):
        assert_close(got[k], ref[k], what=f"{var_type} {k}")
    assert_close(got["vb"][:, 1:], np.asarray(ref["vb"])[:, 1:], what=f"{var_type} vb t > 0")
    assert_close(got["vb"][:, 0], np.asarray(ref["vb"])[:, 0], tol=1e-4, what=f"{var_type} vb t = 0")
    assert_close(got["total_bpd"], ref["total_bpd"], tol=1e-4, what=f"{var_type} total_bpd")


def test_kl_and_likelihood_helpers():
    rng = np.random.default_rng(15)
    a, b, c, d = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4))
    assert_close(td.normal_kl(nchw(a), nchw(b), nchw(c), nchw(d)), jax.jit(jd.normal_kl)(a, b, c, d))
    assert_close(td.normal_kl(nchw(a), nchw(b), 0.0, 0.0), jax.jit(lambda a, b: jd.normal_kl(a, b, 0.0, 0.0))(a, b))
    assert_close(td.approx_standard_normal_cdf(nchw(a) * 3), jax.jit(jd.approx_standard_normal_cdf)(a * 3))
    x = x0_like(16)  # std e^(0.1 d - 0.5) against |x - mean| <~ 1.3: off the fp32 tails (see above)
    ref = jax.jit(lambda x, m, s: jd.discretized_gaussian_log_likelihood(x, means=m, log_scales=s))(
        x, b * 0.1, 0.1 * d - 0.5)
    got = td.discretized_gaussian_log_likelihood(nchw(x), means=nchw(b * 0.1), log_scales=nchw(0.1 * d - 0.5))
    assert_close(got, ref)


def test_uniform_sampler():
    t, w = td.UniformSampler(50).sample(torch.Generator().manual_seed(0), 4096)
    assert t.shape == (4096,) and 0 <= t.min() and t.max() < 50 and torch.equal(w, torch.ones(4096))
    counts = np.bincount(t.numpy(), minlength=50)
    assert scipy.stats.chisquare(counts).pvalue >= 1e-3


def test_loss_second_moment_resampler():
    """History and weights equal JAX's after the same updates (before and
    after warm-up, and once the history rolls); the draws follow the
    weights (a seeded chi-square, p >= 1e-3) with weights 1 / (N p[t])."""
    n, hist = 12, 3
    port, ref = td.LossSecondMomentResampler(n, hist), jd.LossSecondMomentResampler(n, hist)
    rng = np.random.default_rng(17)
    np.testing.assert_array_equal(port.weights(), ref.weights())
    for step in range(12):
        ts = rng.integers(0, n, 8) if step < 8 else np.arange(n)
        losses = rng.uniform(0.1, 3.0, len(ts)) * (1 + ts / n)
        port.update_with_all_losses(ts, losses)
        ref.update_with_all_losses(ts, losses)
        np.testing.assert_array_equal(port._history, ref._history)
        np.testing.assert_array_equal(port._counts, ref._counts)
        np.testing.assert_array_equal(port.weights(), ref.weights())
    assert port._warmed_up()
    p = port.weights() / port.weights().sum()
    t, w = port.sample(torch.Generator().manual_seed(18), 20000)
    counts = np.bincount(t.numpy(), minlength=n)
    assert scipy.stats.chisquare(counts, 20000 * p).pvalue >= 1e-3
    np.testing.assert_allclose(w.numpy(), 1.0 / (n * p[t.numpy()].astype(np.float32)), rtol=1e-6)
    jt, jw = ref.sample(jax.random.PRNGKey(19), 64)  # JAX's own weights, the same rule
    np.testing.assert_allclose(np.asarray(jw), 1.0 / (n * p[np.asarray(jt)]), rtol=1e-6)
