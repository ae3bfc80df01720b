"""Gaussian diffusion math library (port of ``madm_tpu/models/diffusion.py``;
reference ``modeling/diffusion/``: the OpenAI guided-diffusion toolbox the
reference carries for its legacy CompVis path).

- beta schedules: ``linear``, ``cosine``, ``ldm_linear`` / ``scaled_linear``
  (linear in sqrt space);
- forward ``q_sample``, the posterior moments, eps -> x0;
- ancestral (DDPM) and DDIM sampling as Python loops over the timesteps;
- timestep respacing (``space_timesteps``) as gather tables
  (``timestep_map``);
- the variational bound (``_vb_terms_bpd``, ``training_losses``,
  ``calc_bpd_loop``) in bits;
- Uniform / loss-second-moment importance samplers.

The tables are fp32 as the JAX package's are: betas rounded to fp32, then
the cumulative product of 1 - beta in fp32, its products associated as
XLA:CPU computes ``jnp.cumprod`` (``_cumprod_f32``), so the tables equal the
JAX package's bit for bit (``madm_torch.models.sd.scheduler`` takes the
product in fp64 and differs by up to ~1e-6 relative).

Random draws come from an explicit ``torch.Generator``, or are handed in
(``draws``: the tensors in the order the JAX functions draw them), so that
a test can feed the JAX package's.  Tensors are NCHW: a learned-range
model's output splits along dim 1 (JAX: the last axis).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

CUMPROD_BLOCK = 16  # XLA:CPU's reduce-window rewrite splits a scan into blocks of 16


# ------------------------------------------------------------- schedules
def get_named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    if name == "linear":
        scale = 1000 / num_steps
        return np.linspace(scale * 1e-4, scale * 2e-2, num_steps, dtype=np.float64)
    if name in ("ldm_linear", "scaled_linear"):
        return np.linspace(0.00085**0.5, 0.012**0.5, num_steps, dtype=np.float64) ** 2
    if name == "cosine":
        def acp(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        betas = [min(1 - acp((i + 1) / num_steps) / acp(i / num_steps), 0.999)
                 for i in range(num_steps)]
        return np.asarray(betas, np.float64)
    raise NotImplementedError(name)


def _cumprod_f32(x: np.ndarray) -> np.ndarray:
    """fp32 cumulative product with XLA:CPU's association: blocks of 16
    each multiplied in order, the blocks' totals scanned the same way
    (recursively), each block then multiplied by the product of the blocks
    before it."""
    x = np.asarray(x, np.float32)
    n = len(x)
    if n <= CUMPROD_BLOCK:
        return np.cumprod(x, dtype=np.float32)
    m = -(-n // CUMPROD_BLOCK)
    padded = np.ones(m * CUMPROD_BLOCK, np.float32)
    padded[:n] = x
    inner = np.cumprod(padded.reshape(m, CUMPROD_BLOCK), axis=1, dtype=np.float32)
    totals = _cumprod_f32(inner[:, -1])
    before = np.concatenate([np.ones(1, np.float32), totals[:-1]])
    return (before[:, None] * inner).reshape(-1)[:n]


def _draw(draws: Optional[Iterator[torch.Tensor]], generator: Optional[torch.Generator],
          shape, like: Optional[torch.Tensor] = None, device=None, dtype=torch.float32) -> torch.Tensor:
    """The next handed-in draw, or a standard normal from ``generator``."""
    if draws is not None:
        t = next(draws)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"a handed-in draw has shape {tuple(t.shape)}, expected {tuple(shape)}")
        return t.to(device=device, dtype=dtype)
    return torch.randn(shape, generator=generator, device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Schedule tables and the diffusion functions over them.

    ``timestep_map`` implements respacing: model-facing timesteps index into
    the original schedule (the reference's ``SpacedDiffusion``)."""

    betas: np.ndarray
    timestep_map: Optional[np.ndarray] = None

    @classmethod
    def create(cls, steps: int = 1000, schedule: str = "ldm_linear",
               timestep_respacing: Optional[str] = None) -> "GaussianDiffusion":
        betas = get_named_beta_schedule(schedule, steps)
        if not timestep_respacing:
            return cls(betas=betas)
        use = sorted(space_timesteps(steps, timestep_respacing))
        acp = np.cumprod(1 - betas)  # respaced betas: 1 - acp[t] / acp[prev]
        last = 1.0
        new_betas = []
        for t in use:
            new_betas.append(1 - acp[t] / last)
            last = acp[t]
        return cls(betas=np.asarray(new_betas), timestep_map=np.asarray(use))

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    # ------------------------------------------------------------ tables
    @functools.cached_property
    def _tables_np(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        betas = np.asarray(self.betas).astype(np.float32)
        acp = _cumprod_f32(np.float32(1.0) - betas)
        acp_prev = np.concatenate([np.ones(1, np.float32), acp[:-1]])
        return betas, acp, acp_prev

    def tables(self, device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(betas, alphas_cumprod, alphas_cumprod_prev), fp32 on ``device``."""
        return tuple(torch.as_tensor(a, device=device) for a in self._tables_np)

    @staticmethod
    def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
        return table[t.to(table.device).long()].reshape(tuple(t.shape) + (1,) * (ndim - 1))

    def _model_t(self, t: torch.Tensor) -> torch.Tensor:
        if self.timestep_map is None:
            return t
        return torch.as_tensor(self.timestep_map, device=t.device)[t.long()]

    def _full_t(self, b: int, t: int, device) -> torch.Tensor:
        return torch.full((b,), t, dtype=torch.int32, device=device)

    # ----------------------------------------------------------- forward
    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        _, acp, _ = self.tables(x0.device)
        return (self._extract(acp.sqrt(), t, x0.ndim) * x0
                + self._extract((1 - acp).sqrt(), t, x0.ndim) * noise)

    def q_posterior_mean_variance(self, x0, xt, t):
        betas, acp, acp_prev = self.tables(x0.device)
        var = betas * (1 - acp_prev) / (1 - acp)
        coef1 = betas * acp_prev.sqrt() / (1 - acp)
        coef2 = (1 - acp_prev) * (1 - betas).sqrt() / (1 - acp)
        mean = self._extract(coef1, t, x0.ndim) * x0 + self._extract(coef2, t, x0.ndim) * xt
        return mean, self._extract(var, t, x0.ndim)

    def predict_x0_from_eps(self, xt, t, eps):
        _, acp, _ = self.tables(xt.device)
        return (self._extract((1.0 / acp).sqrt(), t, xt.ndim) * xt
                - self._extract((1.0 / acp - 1).sqrt(), t, xt.ndim) * eps)

    # ---------------------------------------------------------- sampling
    def p_sample_loop(self, model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                      shape: Sequence[int], generator: Optional[torch.Generator] = None,
                      clip_denoised: bool = True, device=None,
                      draws: Optional[Iterable[torch.Tensor]] = None) -> torch.Tensor:
        """Ancestral DDPM sampling, t = T-1 .. 0.  ``draws``: the initial x,
        then one noise a step (drawn at t = 0 too, where it is unused)."""
        it = None if draws is None else iter(draws)
        x = _draw(it, generator, shape, device=device)
        for t in range(self.num_timesteps - 1, -1, -1):
            tb = self._full_t(shape[0], t, x.device)
            eps = model_fn(x, self._model_t(tb))
            x0 = self.predict_x0_from_eps(x, tb, eps)
            if clip_denoised:
                x0 = x0.clamp(-1.0, 1.0)
            mean, var = self.q_posterior_mean_variance(x0, x, tb)
            noise = _draw(it, generator, shape, device=x.device)
            x = mean + (var.sqrt() if t > 0 else torch.zeros_like(var)) * noise
        return x

    def ddim_sample_loop(self, model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                         shape: Sequence[int], generator: Optional[torch.Generator] = None,
                         eta: float = 0.0, clip_denoised: bool = True, device=None,
                         draws: Optional[Iterable[torch.Tensor]] = None) -> torch.Tensor:
        """DDIM sampling (reference ``gaussian_diffusion.py:673-841``);
        ``draws`` as ``p_sample_loop``'s."""
        it = None if draws is None else iter(draws)
        x = _draw(it, generator, shape, device=device)
        _, acp, acp_prev = self.tables(x.device)
        for t in range(self.num_timesteps - 1, -1, -1):
            tb = self._full_t(shape[0], t, x.device)
            eps = model_fn(x, self._model_t(tb))
            x0 = self.predict_x0_from_eps(x, tb, eps)
            if clip_denoised:
                x0 = x0.clamp(-1.0, 1.0)
            a_t = self._extract(acp, tb, x.ndim)
            a_prev = self._extract(acp_prev, tb, x.ndim)
            sigma = eta * ((1 - a_prev) / (1 - a_t)).sqrt() * (1 - a_t / a_prev).sqrt()
            eps_hat = (x - a_t.sqrt() * x0) / (1 - a_t).sqrt()
            mean = a_prev.sqrt() * x0 + (1 - a_prev - sigma**2).sqrt() * eps_hat
            noise = _draw(it, generator, shape, device=x.device)
            x = mean + (sigma if t > 0 else torch.zeros_like(sigma)) * noise
        return x

    # ------------------------------------------ variational-bound losses
    # (reference ``gaussian_diffusion.py:842-1021`` and guided-diffusion's
    # ``losses.py``; bits, as the original)
    def q_mean_variance(self, x0, t):
        _, acp, _ = self.tables(x0.device)
        mean = self._extract(acp.sqrt(), t, x0.ndim) * x0
        var = self._extract(1.0 - acp, t, x0.ndim)
        return mean, var, var.log()

    def _posterior_log_variance_clipped(self, t, ndim, device=None):
        betas, acp, acp_prev = self.tables(device)
        var = betas * (1 - acp_prev) / (1 - acp)
        logv = torch.cat([var[1:2], var[1:]]).log()  # var[0] == 0: t = 0 takes t = 1's
        return self._extract(logv, t, ndim)

    def p_mean_variance(self, model_fn: Callable, x: torch.Tensor, t: torch.Tensor,
                        clip_denoised: bool = True, model_var_type: str = "fixed_small"):
        """Model posterior p(x_{t-1} | x_t) of an eps-predicting model
        (reference ``gaussian_diffusion.py:450-560``): a dict of mean,
        variance, log_variance and pred_xstart.  'learned_range' models
        return [eps, v] along dim 1."""
        betas, acp, acp_prev = self.tables(x.device)
        out = model_fn(x, self._model_t(t))
        if model_var_type == "learned_range":
            eps, v = out.chunk(2, dim=1)
            min_log = self._posterior_log_variance_clipped(t, x.ndim, x.device)
            max_log = self._extract(betas.log(), t, x.ndim)
            frac = (v + 1) / 2
            log_variance = frac * max_log + (1 - frac) * min_log
            variance = log_variance.exp()
        else:
            eps = out
            if model_var_type == "fixed_large":
                var_l = torch.cat([betas[1:2] * (1 - acp_prev[1:2]) / (1 - acp[1:2]), betas[1:]])
                variance = self._extract(var_l, t, x.ndim)
                log_variance = variance.log()
            else:  # fixed_small: the true posterior variance
                if model_var_type != "fixed_small":
                    raise ValueError(f"model_var_type {model_var_type!r}")
                var = betas * (1 - acp_prev) / (1 - acp)
                variance = self._extract(var, t, x.ndim)
                log_variance = self._posterior_log_variance_clipped(t, x.ndim, x.device)
        x0 = self.predict_x0_from_eps(x, t, eps)
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        mean, _ = self.q_posterior_mean_variance(x0, x, t)
        return {"mean": mean, "variance": variance, "log_variance": log_variance, "pred_xstart": x0}

    def _vb_terms_bpd(self, model_fn, x0, xt, t, clip_denoised=True,
                      model_var_type: str = "fixed_small"):
        """KL(q(x_{t-1}|x_t,x_0) || p(x_{t-1}|x_t)) per batch element in
        bits, the decoder NLL at t = 0 (reference
        ``gaussian_diffusion.py:842-872``)."""
        true_mean, _ = self.q_posterior_mean_variance(x0, xt, t)
        true_logv = self._posterior_log_variance_clipped(t, x0.ndim, x0.device)
        out = self.p_mean_variance(model_fn, xt, t, clip_denoised, model_var_type)
        kl = _mean_flat(normal_kl(true_mean, true_logv, out["mean"], out["log_variance"])) / math.log(2.0)
        nll = -discretized_gaussian_log_likelihood(x0, means=out["mean"],
                                                   log_scales=0.5 * out["log_variance"])
        nll = _mean_flat(nll) / math.log(2.0)
        return {"output": torch.where(t.to(kl.device) == 0, nll, kl), "pred_xstart": out["pred_xstart"]}

    def training_losses(self, model_fn, x0: torch.Tensor, t: torch.Tensor,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None, loss_type: str = "mse",
                        model_mean_type: str = "epsilon", model_var_type: str = "fixed_small"):
        """Per-timestep training losses (reference
        ``gaussian_diffusion.py:873-947``): ``loss_type`` 'mse',
        'rescaled_mse', 'kl' or 'rescaled_kl'; an eps model with
        'learned_range' variance returns 2C channels and gains a 'vb' term
        computed on its detached mean, as the original."""
        if noise is None:
            if generator is None:
                raise ValueError("training_losses needs noise or a generator")
            noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
        xt = self.q_sample(x0, t, noise)
        terms = {}
        if loss_type in ("kl", "rescaled_kl"):
            terms["loss"] = self._vb_terms_bpd(model_fn, x0, xt, t, clip_denoised=False,
                                               model_var_type=model_var_type)["output"]
            if loss_type == "rescaled_kl":
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms
        if loss_type not in ("mse", "rescaled_mse"):
            raise ValueError(f"loss_type {loss_type!r}")
        model_output = model_fn(xt, self._model_t(t))
        if model_var_type in ("learned", "learned_range"):
            eps, var_values = model_output.chunk(2, dim=1)
            frozen = torch.cat([eps.detach(), var_values], dim=1)  # the variance learns through vb
            terms["vb"] = self._vb_terms_bpd(lambda *_a: frozen, x0, xt, t, clip_denoised=False,
                                             model_var_type="learned_range")["output"]
            if loss_type == "rescaled_mse":
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)
            model_output = eps
        target = {"xprev": lambda: self.q_posterior_mean_variance(x0, xt, t)[0],
                  "xstart": lambda: x0, "epsilon": lambda: noise}[model_mean_type]()
        terms["mse"] = _mean_flat((target - model_output) ** 2)
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
        return terms

    def _prior_bpd(self, x0):
        """Prior KL against N(0, 1) in bits/dim (reference
        ``gaussian_diffusion.py:949-964``)."""
        t = self._full_t(x0.shape[0], self.num_timesteps - 1, x0.device)
        mean, _, logv = self.q_mean_variance(x0, t)
        return _mean_flat(normal_kl(mean, logv, 0.0, 0.0)) / math.log(2.0)

    def calc_bpd_loop(self, model_fn, x0, generator: Optional[torch.Generator] = None,
                      clip_denoised=True, model_var_type: str = "fixed_small",
                      draws: Optional[Iterable[torch.Tensor]] = None):
        """The whole variational bound, t = T-1 .. 0 (reference
        ``gaussian_diffusion.py:966-1021``): per-timestep terms [B, T] in
        timestep order.  ``draws``: one noise a step, in loop order."""
        it = None if draws is None else iter(draws)
        b = x0.shape[0]
        _, acp, _ = self.tables(x0.device)
        vb, xstart_mse, mse = [], [], []
        for t in range(self.num_timesteps - 1, -1, -1):
            tb = self._full_t(b, t, x0.device)
            noise = _draw(it, generator, x0.shape, device=x0.device, dtype=x0.dtype)
            xt = self.q_sample(x0, tb, noise)
            out = self._vb_terms_bpd(model_fn, x0, xt, tb, clip_denoised, model_var_type)
            xstart_mse.append(_mean_flat((out["pred_xstart"] - x0) ** 2))
            # the eps implied by the model's x0
            eps = ((self._extract((1.0 / acp).sqrt(), tb, x0.ndim) * xt - out["pred_xstart"])
                   / self._extract((1.0 / acp - 1).sqrt(), tb, x0.ndim))
            mse.append(_mean_flat((eps - noise) ** 2))
            vb.append(out["output"])
        vb, xstart_mse, mse = (torch.stack(a[::-1], dim=1) for a in (vb, xstart_mse, mse))
        prior_bpd = self._prior_bpd(x0)
        return {"total_bpd": vb.sum(dim=1) + prior_bpd, "prior_bpd": prior_bpd, "vb": vb,
                "xstart_mse": xstart_mse, "mse": mse}


def _mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.ndim)))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two diagonal gaussians (guided-diffusion ``losses.py``)."""
    ref = next(a for a in (mean1, logvar1, mean2, logvar2) if isinstance(a, torch.Tensor))
    logvar1, logvar2 = (torch.as_tensor(a, dtype=ref.dtype, device=ref.device) for a in (logvar1, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + (logvar1 - logvar2).exp()
                  + ((mean1 - mean2) ** 2) * (-logvar2).exp())


def approx_standard_normal_cdf(x):
    c = torch.tensor(2.0 / math.pi, dtype=torch.float32).sqrt().item()  # sqrt in fp32, as jnp
    return 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a gaussian discretized to 1/255 bins: the t = 0
    decoder NLL of images in [-1, 1] (guided-diffusion ``losses.py``)."""
    centered = x - means
    inv_stdv = (-log_scales).exp()
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = cdf_plus.clamp(min=1e-12).log()
    log_one_minus_cdf_min = (1.0 - cdf_min).clamp(min=1e-12).log()
    cdf_delta = cdf_plus - cdf_min
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, cdf_delta.clamp(min=1e-12).log()))


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Respacing spec -> set of original timesteps (reference
    ``respace.py:7-70``): 'ddimN' N steps at a fixed stride on the DDIM
    grid, 'ldm_ddimN' the LDM grid (offset +1), 'N' or 'n1,n2,...' or a list
    per-section even striding (Python's ``round``: ties to even)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ldm_ddim"):
            count = int(section_counts[len("ldm_ddim"):])
            stride = num_timesteps // count
            return set(np.arange(1, num_timesteps + 1, stride)[:count].tolist())
        if section_counts.startswith("ddim"):
            count = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == count:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot create exactly {count} ddim steps")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start = 0
    out = set()
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if count > size:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            out.add(start + round(cur))
            cur += stride
        start += size
    return out


# ---------------------------------------------------------------- samplers
class UniformSampler:
    """Uniform timestep sampler (reference ``resample.py:60-74``)."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, generator: Optional[torch.Generator], batch: int, device=None):
        t = torch.randint(0, self.num_timesteps, (batch,), generator=generator, device=device)
        return t, torch.ones((batch,), device=device)


class LossSecondMomentResampler:
    """Importance-sampled timesteps by per-t loss second moments (reference
    ``resample.py:101-149``).  ``update_with_all_losses`` takes the losses
    of the whole batch (every rank's): a host-side update."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._history = np.zeros((num_timesteps, history_per_term), np.float64)
        self._counts = np.zeros((num_timesteps,), np.int64)

    def _warmed_up(self) -> bool:
        return bool((self._counts == self.history_per_term).all())

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones((self.num_timesteps,), np.float64)
        w = np.sqrt(np.mean(self._history**2, axis=-1))
        w = w / w.sum()
        return w * (1 - self.uniform_prob) + self.uniform_prob / len(w)

    def sample(self, generator: Optional[torch.Generator], batch: int, device=None):
        """(t [batch] int64 drawn with probabilities p, weights 1 / (N p[t])
        fp32)."""
        p = self.weights()
        p = torch.as_tensor(p / p.sum(), dtype=torch.float32)
        t = torch.multinomial(p, batch, replacement=True, generator=generator)
        return t.to(device), (1.0 / (self.num_timesteps * p[t])).to(device)

    def update_with_all_losses(self, ts, losses) -> None:
        for t, loss in zip(np.asarray(ts), np.asarray(losses)):
            if self._counts[t] == self.history_per_term:
                self._history[t, :-1] = self._history[t, 1:]
                self._history[t, -1] = loss
            else:
                self._history[t, self._counts[t]] = loss
                self._counts[t] += 1
