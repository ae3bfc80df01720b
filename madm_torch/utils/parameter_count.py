"""Parameter counting tables (port of ``madm_tpu/utils/parameter_count.py``;
reference ``utils/parameter_count.py:7-120``).

The reference logs a trainable-parameter table at trainer init
(``engine/train_loop.py:70-75``) so what-is-trainable is visible in every run
log.  Here the units are the module paths of ``named_parameters`` up to
``max_depth``; a row is trainable where any of its parameters needs a
gradient.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from torch import nn


def _fmt(n: int) -> str:
    if n >= 1e9:
        return f"{n / 1e9:.2f}G"
    if n >= 1e6:
        return f"{n / 1e6:.2f}M"
    if n >= 1e3:
        return f"{n / 1e3:.2f}K"
    return str(n)


def parameter_count_table(model: nn.Module, max_depth: int = 2) -> str:
    """Readable per-module parameter counts with a trainable marker."""
    rows: Dict[str, List[int]] = {}  # path -> [count, trainable count]
    for name, p in model.named_parameters():
        path = "/".join(name.split(".")[:max_depth])
        row = rows.setdefault(path, [0, 0])
        row[0] += p.numel()
        row[1] += p.numel() if p.requires_grad else 0
    total = sum(n for n, _ in rows.values())
    trainable = sum(t for _, t in rows.values())
    items: List[Tuple[str, List[int]]] = sorted(rows.items())
    lines = [f"{'module':<48} {'#params':>10}  trainable"]
    lines += [f"{p:<48} {_fmt(n):>10}  {'yes' if t else 'no'}" for p, (n, t) in items if n]
    lines.append(f"{'TOTAL':<48} {_fmt(total):>10}  ({_fmt(trainable)} trainable)")
    return "\n".join(lines)
