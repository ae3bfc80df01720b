"""Metric/event plumbing (port of ``madm_tpu/utils/events.py``; reference:
``utils/events.py`` + d2 EventStorage).

``EventStorage`` accumulates smoothed scalars; writers flush them:
``JSONWriter`` (metrics.json lines), ``CommonMetricPrinter`` (log lines with
ETA and losses — ``utils/events.py:96-165``), and an optional wandb writer
gated on the package being importable.  Under a process group of more than
one, the writers write on rank 0 alone (every rank's metrics are the same
means over the ranks).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional

from ..parallel import dist as dist_lib

logger = logging.getLogger(__name__)


class EventStorage:
    def __init__(self, start_iter: int = 0, window_size: int = 20):
        self.iter = start_iter
        self._window = window_size
        self._history = defaultdict(lambda: deque(maxlen=window_size))
        self._latest: Dict[str, tuple] = {}

    def put_scalar(self, name: str, value: float) -> None:
        value = float(value)
        self._history[name].append(value)
        self._latest[name] = (value, self.iter)

    def put_scalars(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def median(self, name: str) -> float:
        h = sorted(self._history[name])
        return h[len(h) // 2] if h else float("nan")

    def avg(self, name: str) -> float:
        h = self._history[name]
        return sum(h) / len(h) if h else float("nan")

    def latest(self) -> Dict[str, tuple]:
        return dict(self._latest)

    def step(self) -> None:
        self.iter += 1


class JSONWriter:
    """metrics.json with one JSON line per flush (d2 format)."""

    def __init__(self, path: str):
        self._f = None
        if dist_lib.is_main():
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    def write(self, storage: EventStorage) -> None:
        if self._f is None:
            return
        row = {"iteration": storage.iter}
        row.update({k: v for k, (v, _) in storage.latest().items()})
        self._f.write(json.dumps(row, sort_keys=True) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


class CommonMetricPrinter:
    """Readable progress lines with smoothed losses, lr, ETA."""

    def __init__(self, max_iter: int):
        self.max_iter = max_iter
        self._last_time: Optional[tuple] = None

    def write(self, storage: EventStorage) -> None:
        it = storage.iter
        eta = ""
        data_time = storage.avg("data_time")
        iter_time = storage.avg("time")
        if iter_time == iter_time:  # not NaN
            eta_sec = iter_time * (self.max_iter - it)
            eta = f"eta: {datetime.timedelta(seconds=int(eta_sec))}  "
        losses = "  ".join(
            f"{k}: {storage.median(k):.4g}"
            for k, (v, i) in sorted(storage.latest().items())
            if "loss" in k and i == it
        )
        lr = storage._latest.get("lr", (None, None))[0]
        lr_str = f"lr: {lr:.3e}  " if lr is not None else ""
        time_str = f"time: {iter_time:.3f}s  data: {data_time:.3f}s  " if iter_time == iter_time else ""
        logger.info(f"{eta}iter: {it}/{self.max_iter}  {losses}  {lr_str}{time_str}")


class WandbWriter:
    """Optional wandb logging (reference ``utils/events.py:12-93``); no-op
    when wandb is not installed or disabled.

    Run resumption mirrors the reference's manually managed
    ``wandb-resume.json`` (``utils/events.py:56-66``): the run id is stored in
    ``output_dir`` and reused on ``resume=True``."""

    def __init__(self, project: str = "madm_torch", name: Optional[str] = None,
                 enabled: bool = True, resume: bool = False,
                 output_dir: Optional[str] = None, **kwargs):
        self._run = None
        if not (enabled and dist_lib.is_main()):
            return
        try:
            import wandb

            run_id = None
            resume_file = (
                os.path.join(output_dir, "wandb-resume.json") if output_dir else None
            )
            if resume and resume_file and os.path.exists(resume_file):
                with open(resume_file) as f:
                    run_id = json.load(f).get("run_id")
            self._run = wandb.init(
                project=project, name=name, id=run_id,
                resume="must" if run_id else None, **kwargs,
            )
            if resume_file:
                with open(resume_file, "w") as f:
                    json.dump({"run_id": self._run.id}, f)
        except Exception as e:  # pragma: no cover - wandb not in image
            logger.info(f"wandb disabled: {e}")

    def write(self, storage: EventStorage) -> None:
        if self._run is None:
            return
        self._run.log(
            {k: v for k, (v, i) in storage.latest().items() if i == storage.iter},
            step=storage.iter,
        )

    def close(self) -> None:
        if self._run is not None:
            self._run.finish()


class WriterStack:
    """Flush writers every period; close on error (``utils/events.py:168``)."""

    def __init__(self, writers, period: int = 50):
        self.writers = writers
        self.period = period

    def maybe_write(self, storage: EventStorage) -> None:
        if (storage.iter + 1) % self.period == 0:
            self.write(storage)

    def write(self, storage: EventStorage) -> None:
        """Unconditional flush — used after eval so its scalars always land
        in metrics.json/wandb (reference EvalHook flattens results into
        EventStorage at every eval iter, ``engine/hooks.py:16-52``)."""
        for w in self.writers:
            w.write(storage)

    def close(self) -> None:
        for w in self.writers:
            if hasattr(w, "close"):
                w.close()
