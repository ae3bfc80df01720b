"""AdamW and Adafactor with MADM's parameter groups, the learning-rate
schedules and the global-norm clip (port of ``madm_tpu/train/optimizer.py``,
the reference's ``adamw``).

- No weight decay on biases and norm scales (flax ``bias``/``scale``: here
  ``bias`` and the ``weight`` of GroupNorm, LayerNorm and BatchNorm); conv
  and linear weights and the learned prompts decay.
- The warmup + multi-step schedule (or, with ``--warmup_lr``, the warmup +
  linear decay) evaluated at the update count; ``set_lr`` writes it into
  each group times the group's ``lr_scale``.
- ``unet_lr``: the UNet's and the adapters' groups take ``lr_scale = unet_lr
  / lr``, which multiplies their whole update, decay included, as optax's
  ``masked(scale(ratio))`` does.
- The clip is optax's ``clip_by_global_norm``: g * min(1, c / ||g||), with no
  epsilon (``torch.nn.utils.clip_grad_norm_`` divides by ||g|| + 1e-6).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.sd.layers import GroupNorm
from ..parallel import dist as dist_lib

_NORMS = (GroupNorm, nn.LayerNorm, nn.BatchNorm2d)


def lr_schedule(base_lr: float, max_iter: int, milestones=(0.88888, 0.96296),
                values=(1.0, 0.1, 0.01), warmup_factor: float = 0.067,
                warmup_length: float = 500 / 184375) -> Callable[[int], float]:
    """WarmupParamScheduler(MultiStepParamScheduler): steps at int(m * (2 *
    max_iter - 1)) updates rescaled to iterations, linear warmup from
    ``warmup_factor`` over ``warmup_length`` of training."""
    num_updates = 2 * max_iter - 1
    step_iters = [int(m * num_updates) / num_updates * max_iter for m in milestones]
    warmup_iters = warmup_length * max_iter

    def schedule(count: int) -> float:
        mult = values[0]
        for it, v in zip(step_iters, values[1:]):
            if count >= it:
                mult = v
        w = 1.0
        if count < warmup_iters:
            w = warmup_factor + (1 - warmup_factor) * (count / max(warmup_iters, 1e-8))
        return base_lr * mult * w

    return schedule


def linear_lr_schedule(base_lr: float, max_iter: int, warmup_length: float = 0.0375,
                       warmup_factor: float = 1e-6) -> Callable[[int], float]:
    """The ``--warmup_lr`` schedule: WarmupParamScheduler over
    LinearParamScheduler(start=1/(1-0.0375), end=0) (reference
    ``main.py:528-540``): s(f) = (1-f)/(1-w) reaches 1 where the warmup ends
    at f = w, then decays linearly to 0; f = count / max_iter in fp32, as the
    JAX schedule computes it."""
    def schedule(count: int) -> float:
        f = np.float32(count) / np.float32(max_iter)
        lin = max((np.float32(1.0) - f) / np.float32(1.0 - warmup_length), np.float32(0.0))
        w0 = np.float32(warmup_factor / (1.0 - warmup_length))
        warm = w0 + (np.float32(1.0) - w0) * (f / np.float32(warmup_length))
        return float(np.float32(base_lr) * (warm if f < warmup_length else lin))

    return schedule


def get_lr_schedule(base_lr: float, max_iter: int, schedule: str = "multistep") -> Callable[[int], float]:
    """'multistep' (the shipped configs) or 'linear' (``--warmup_lr``)."""
    if schedule == "linear":
        return linear_lr_schedule(base_lr, max_iter)
    if schedule != "multistep":
        raise ValueError(f"lr schedule {schedule!r} is not 'multistep' or 'linear'")
    return lr_schedule(base_lr, max_iter)


_DTYPES = {None: None, "bfloat16": torch.bfloat16, "float32": torch.float32}
CHUNK_NUMEL = 2 ** 26  # AdamW's elementwise ops run on lists of up to this many elements
# optax.adafactor's defaults, which the JAX package's call keeps
ADAFACTOR_DECAY_RATE, ADAFACTOR_EPS, MIN_DIM_SIZE_TO_FACTOR = 0.8, 1e-30, 128


def _mu_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    if name not in _DTYPES:
        raise ValueError(f"mu_dtype {name!r} is not None, 'bfloat16' or 'float32'")
    return _DTYPES[name]


def _chunks(items: List, numels: List[int]):
    """Consecutive runs of ``items`` of at most ``CHUNK_NUMEL`` elements (a
    longer item alone), so that the foreach temporaries stay bounded."""
    run, size = [], 0
    for item, n in zip(items, numels):
        if run and size + n > CHUNK_NUMEL:
            yield run
            run, size = [], 0
        run.append(item)
        size += n
    if run:
        yield run


def _grads(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each parameter's gradient; zeros where it has none (optax updates
    every leaf every step: its moments decay and its weight decays)."""
    return [torch.zeros_like(p) if p.grad is None else p.grad for p in params]


def _decayed_moment(m: torch.Tensor, b1: float) -> torch.Tensor:
    """b1 * m as optax forms it: on a bf16 moment JAX's weak-type promotion
    makes the product bf16 (b1 rounded to bf16 too) before the fp32 add."""
    if m.dtype == torch.bfloat16:
        return m.mul(float(torch.tensor(b1, dtype=torch.bfloat16))).float()
    return m.mul(b1)


class AdamW(torch.optim.Optimizer):
    """``optax.adamw`` (``scale_by_adam`` -> ``add_decayed_weights`` ->
    ``scale_by_learning_rate``), then ``lr_scale`` on the whole update:

        mu = (1 - b1) g + b1 mu        nu = (1 - b2) g^2 + b2 nu
        u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
        p += lr_scale * (-lr * (u + wd * p))

    With ``mu_dtype='bfloat16'`` the step uses the fp32 mu (``b1 * mu``
    formed in bf16) and stores it rounded to bf16; nu stays fp32.  State
    keys as torch's AdamW: ``step``, ``exp_avg`` (mu), ``exp_avg_sq`` (nu)."""

    def __init__(self, params, lr: float = 5e-6, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.05, mu_dtype: Optional[str] = None, lr_scale: float = 1.0):
        _mu_dtype(mu_dtype)
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                                      mu_dtype=mu_dtype, lr_scale=lr_scale))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            (b1, b2), eps, wd = group["betas"], group["eps"], group["weight_decay"]
            mu_dtype = _mu_dtype(group["mu_dtype"])
            for ps in _chunks(group["params"], [p.numel() for p in group["params"]]):
                sts = [self.state[p] for p in ps]
                for p, st in zip(ps, sts):
                    if not st:
                        st["step"] = 0
                        st["exp_avg"] = torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                        st["exp_avg_sq"] = torch.zeros_like(p)
                t = sts[0]["step"] + 1
                if any(st["step"] + 1 != t for st in sts):
                    raise RuntimeError("AdamW: parameters of one group at different steps")
                g = _grads(ps)
                mus = [st["exp_avg"] for st in sts]
                mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1), [_decayed_moment(m, b1) for m in mus])
                nus = [st["exp_avg_sq"] for st in sts]
                torch._foreach_mul_(nus, b2)
                g2 = torch._foreach_mul(g, g)
                torch._foreach_mul_(g2, 1 - b2)
                torch._foreach_add_(nus, g2)
                del g2
                # bias corrections in fp32, as optax forms 1 - decay**count
                bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
                bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
                torch._foreach_copy_(mus, mu)  # rounded to mu_dtype
                torch._foreach_div_(mu, bc1)
                den = torch._foreach_div(nus, bc2)
                torch._foreach_sqrt_(den)
                torch._foreach_add_(den, eps)
                torch._foreach_div_(mu, den)
                del den
                if wd:
                    torch._foreach_add_(mu, torch._foreach_mul(ps, wd))
                torch._foreach_mul_(mu, -group["lr"])
                if group["lr_scale"] != 1.0:
                    torch._foreach_mul_(mu, group["lr_scale"])
                torch._foreach_add_(ps, mu)
                for st in sts:
                    st["step"] = t
        return None

    def load_state_dict(self, state_dict) -> None:
        """torch's loader casts every state tensor to its parameter's dtype;
        the moments get their own dtype back."""
        super().load_state_dict(state_dict)
        _restore_moment_dtype(self)


def _restore_moment_dtype(opt: torch.optim.Optimizer) -> None:
    for group in opt.param_groups:
        dtype = _mu_dtype(group["mu_dtype"])
        for p in group["params"]:
            st = opt.state.get(p)
            if dtype is not None and st and "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(dtype)


def factored_dims(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """(second-largest axis, largest axis) by size, as optax's
    ``_factored_dims`` picks them (``np.argsort``), or None when the tensor
    is 1-D or its second-largest axis is under ``MIN_DIM_SIZE_TO_FACTOR``.
    By size, never by position: torch's [out, in, kh, kw] and flax's
    [kh, kw, in, out] pick the same two axes."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def adafactor_direction(grad: torch.Tensor, st: Dict[str, torch.Tensor],
                        dims: Optional[Tuple[int, int]]) -> torch.Tensor:
    """Adafactor's u from a gradient and the second-moment statistics it
    updated (``st``: ``v``, or ``v_row`` / ``v_col`` over ``dims`` =
    ``factored_dims``): g v^-1/2, or g (r / mean r)^-1/2 c^-1/2."""
    if dims is None:
        return grad * st["v"].pow(-0.5)
    d1, d0 = dims
    vr = st["v_row"]
    row = (vr / vr.mean(dim=d1 - 1 if d1 > d0 else d1, keepdim=True)).pow(-0.5)
    return grad * row.unsqueeze(d0) * st["v_col"].pow(-0.5).unsqueeze(d1)


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor`` as the JAX package calls it (``decay_rate=0.8``,
    ``multiply_by_parameter_scale=False``, ``clipping_threshold=None``,
    ``factored=True``, ``eps=1e-30``): ``scale_by_factored_rms`` ->
    ``scale_by_learning_rate`` -> ``ema(b1, debias=False)`` ->
    ``add_decayed_weights`` -> ``scale(-1)``, then ``lr_scale`` on the whole
    update:

        d = 1 - (t + 1)^-0.8  (0 at the first update; no bias correction)
        r = d r + (1 - d) mean_{d0}(g^2 + eps)   c = d c + (1 - d) mean_{d1}(g^2 + eps)
        u = g (r / mean(r))^-1/2 c^-1/2          (unfactored: v = d v + (1 - d)(g^2 + eps), u = g v^-1/2)
        m = (1 - b1) lr u + b1 m                 (b1 None: m = lr u, nothing stored)
        p += lr_scale * -(m + wd p)

    Weight decay comes after the learning rate (a decayed weight shrinks by
    wd a step whatever lr is), so ``lr_scale`` must scale the rule's output:
    raising the group's lr would leave the decay out.  The momentum ``m``
    is an EMA of the lr-scaled update, used in fp32 this step and stored
    rounded to ``mu_dtype`` (bf16 by default; ``b1 * m`` formed in bf16).
    State: ``step``; ``v_row`` / ``v_col`` for a factored tensor (its two
    largest axes, ``factored_dims``), ``v`` otherwise; ``exp_avg`` (m)."""

    def __init__(self, params, lr: float = 5e-6, b1: Optional[float] = 0.9,
                 weight_decay: float = 0.05, mu_dtype: Optional[str] = "bfloat16",
                 lr_scale: float = 1.0):
        _mu_dtype(mu_dtype)
        super().__init__(params, dict(lr=lr, b1=b1, weight_decay=weight_decay, mu_dtype=mu_dtype,
                                      lr_scale=lr_scale))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, wd = group["b1"], group["weight_decay"]
            mu_dtype = _mu_dtype(group["mu_dtype"]) or torch.float32
            for p in group["params"]:
                g = torch.zeros_like(p) if p.grad is None else p.grad
                st = self.state[p]
                dims = factored_dims(p.shape)
                if not st:
                    st["step"] = 0
                    if dims is None:
                        st["v"] = torch.zeros_like(p)
                    else:
                        shape = list(p.shape)
                        st["v_row"] = p.new_zeros(shape[:dims[1]] + shape[dims[1] + 1:])
                        st["v_col"] = p.new_zeros(shape[:dims[0]] + shape[dims[0] + 1:])
                    if b1 is not None:
                        st["exp_avg"] = torch.zeros_like(p, dtype=mu_dtype)
                d = np.float32(1) - np.float32(st["step"] + 1) ** np.float32(-ADAFACTOR_DECAY_RATE)
                keep, new = float(d), float(np.float32(1) - d)
                g2 = g * g + ADAFACTOR_EPS
                if dims is None:
                    st["v"].mul_(keep).add_(g2.mul_(new))
                else:
                    st["v_row"].mul_(keep).add_(g2.mean(dim=dims[1]).mul_(new))
                    st["v_col"].mul_(keep).add_(g2.mean(dim=dims[0]).mul_(new))
                del g2
                u = adafactor_direction(g, st, dims)
                u.mul_(group["lr"])
                if b1 is not None:
                    m = st["exp_avg"]
                    u = u.mul_(1 - b1).add_(_decayed_moment(m, b1))
                    m.copy_(u)
                if wd:
                    u.add_(p * wd)
                u.neg_()
                if group["lr_scale"] != 1.0:
                    u.mul_(group["lr_scale"])
                p.add_(u)
                st["step"] += 1
        return None

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        _restore_moment_dtype(self)


def make_optimizer(model: nn.Module, named_params: Sequence[Tuple[str, nn.Parameter]],
                   lr: float = 5e-6, weight_decay: float = 0.05, betas=(0.9, 0.999),
                   eps: float = 1e-8, unet_lr: Optional[float] = None, name: str = "adamw",
                   mu_dtype: Optional[str] = None) -> torch.optim.Optimizer:
    """The rule ``name`` ('adamw' or 'adafactor') over ``named_params`` (names
    as in ``model.named_parameters()``), split into decayed and undecayed
    groups, each also split into the UNet and adapters (``lr_scale = unet_lr
    / lr``) and the rest (``lr_scale`` 1) when ``unet_lr`` is set.
    ``betas[0]`` None (``optimizer.no_momentum``) keeps no first moment and
    is adafactor's only; adafactor reads no b2 or eps, and stores its
    momentum in ``mu_dtype`` or bf16.  Under a process group, the state is
    sharded over the ranks (ZeRO-1)."""
    if betas[0] is None and name != "adafactor":
        raise ValueError("optimizer.no_momentum (b1=None) only applies to name='adafactor'; "
                         f"adamw requires a first-moment beta (got name={name!r})")
    norm_weights = {id(m.weight) for m in model.modules() if isinstance(m, _NORMS)}
    groups: Dict[Tuple[bool, bool], List[nn.Parameter]] = {}
    for pname, p in named_params:
        decays = not (pname.endswith(".bias") or id(p) in norm_weights)
        unet = unet_lr is not None and pname.startswith(("unet.", "lora."))
        groups.setdefault((unet, decays), []).append(p)
    order = [(False, True), (False, False), (True, True), (True, False)]
    param_groups = [{"params": groups[key], "weight_decay": weight_decay if key[1] else 0.0,
                     "lr_scale": unet_lr / lr if key[0] else 1.0} for key in order if key in groups]
    if name == "adafactor":
        cls, kw = Adafactor, dict(lr=lr, b1=betas[0], mu_dtype=mu_dtype or "bfloat16")
    elif name == "adamw":
        cls, kw = AdamW, dict(lr=lr, betas=betas, eps=eps, mu_dtype=mu_dtype)
    else:
        raise ValueError(f"optimizer {name!r} is not 'adamw' or 'adafactor'")
    if dist_lib.initialized():
        return dist_lib.zero1(param_groups, cls, **kw)
    return cls(param_groups, **kw)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Each group's learning rate (its ``lr_scale`` multiplies the update)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


@torch.no_grad()
def clip_by_global_norm_(params: Sequence[nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale the gradients by min(1, max_norm / ||g||) in place; returns the
    fp32 global norm ||g|| before the clip, as a device scalar."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
    torch._foreach_mul_(grads, (max_norm / norm).clamp(max=1.0))
    return norm
