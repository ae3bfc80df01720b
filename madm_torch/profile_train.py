"""Where one UDA train step spends its time on the card.

    python -m madm_torch.profile_train [--batch 1] [--flash-pack] [--out profile_train.json]

Runs the flagship config (full SD-v1.4, 512x512, bf16 compute) with the
shipped TrainConfig on seeded random weights and synthetic batches
(``--flash-pack``: with ``MADMConfig.flash_pack``, the five S=4096 UNet
self-attentions of each pass on K4 and of each backward on K5) and
reports, for one step after two warm-up steps:
- the host-clock step time (ends when the step's metrics reach the host);
- device time per phase, from CUDA events recorded around the step's
  ``backbone_forward`` / ``head_forward`` calls and its optimizer step (the
  phases between them take the gaps: the EMA update and DACS mix, the
  pseudo-labels and palette encodes, each loss and its backward);
- device time per kernel and per kernel family from ``torch.profiler`` for
  one more step, and the device's idle share (1 - kernel time / step time).
Needs a GPU; prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import time

import torch

from .device import card_line
from .models.madm import MADMConfig
from .profile_eval import kernel_breakdown, write_json
from .train.loop import init_train_state, synthetic_batches, train
from .train.train_step import TrainConfig

# the step's marks in order, and the name of the phase that ends at each
PHASES = (
    ("backbone_forward start", "EMA update, DACS mix"),
    ("backbone_forward end", "teacher backbone (no grad)"),
    ("head_forward start", None),
    ("head_forward end", "teacher head (train-mode BN)"),
    ("backbone_forward start", "pseudo-labels, reg_uncertain, 2 palette encodes"),
    ("backbone_forward end", "source backbone forward"),
    ("head_forward start", None),
    ("head_forward end", "source head forward"),
    ("backbone_forward start", "source losses + backward"),
    ("backbone_forward end", "mixed backbone forward"),
    ("head_forward start", None),
    ("head_forward end", "mixed head forward"),
    ("optimizer start", "mixed losses + backward, clip"),
    ("optimizer end", "AdamW"),
    ("step end", "metrics to the host"),
)


def _marked_step(state, batches, gen):
    """One step with CUDA events at its calls; (device ms, {phase: ms})."""
    model, marks = state.model, []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    def wrap(name):
        fn = getattr(model, name)

        def wrapped(*args, **kwargs):
            mark(f"{name} start")
            out = fn(*args, **kwargs)
            mark(f"{name} end")
            return out

        setattr(model, name, wrapped)

    wrap("backbone_forward")
    wrap("head_forward")
    hooks = [state.optimizer.register_step_pre_hook(lambda *_: mark("optimizer start")),
             state.optimizer.register_step_post_hook(lambda *_: mark("optimizer end"))]
    try:
        mark("step start")
        train(state, batches, steps=1, generator=gen)
        mark("step end")
        torch.cuda.synchronize()
    finally:
        del model.backbone_forward, model.head_forward  # back to the class's methods
        for h in hooks:
            h.remove()
    labels = [label for label, _ in marks[1:]]
    if labels != [label for label, _ in PHASES]:
        raise RuntimeError(f"unexpected call sequence in the train step: {labels}")
    phases = {}
    for (_, prev), (_, ev), (_, phase) in zip(marks, marks[1:], PHASES):
        if phase is not None:
            phases[phase] = prev.elapsed_time(ev)
    return marks[0][1].elapsed_time(marks[-1][1]), phases


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flash-pack", action="store_true", help="MADMConfig.flash_pack: K4/K5 at S=4096")
    ap.add_argument("--out", default="profile_train.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a GPU")

    cfg = MADMConfig(flash_pack=args.flash_pack)
    state = init_train_state(cfg, TrainConfig(), device="cuda", seed=args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    batches = synthetic_batches(args.batch, cfg.crop_size, cfg.num_classes, gen)
    train(state, batches, steps=2, generator=gen)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    step_ms, phases = _marked_step(state, batches, gen)
    host_ms = (time.perf_counter() - t0) * 1e3
    kernel_ms, fam, top = kernel_breakdown(
        lambda: train(state, batches, steps=1, generator=gen))
    write_json({
        "card": card_line(),
        "batch": args.batch,
        "flash_pack": args.flash_pack,
        "step_ms_host": host_ms,
        "step_ms_device_events": step_ms,
        "phases_ms": phases,
        "profiled_kernel_ms": kernel_ms,
        "device_idle_share": (1.0 - kernel_ms / step_ms) if kernel_ms else None,
        "families_ms": fam,
        "top_kernels": top,
    }, args.out)


if __name__ == "__main__":
    main()
