"""Environment report at startup (port of ``madm_tpu/utils/collect_env.py``;
reference ``utils/collect_env.py:63+``): torch, CUDA and the card in place
of jax, flax and optax, and this process's rank in its process group."""

from __future__ import annotations

import platform
import sys


def collect_env_info() -> str:
    import numpy
    import torch

    from ..device import card_line

    rows = []

    def add(k, v):
        rows.append(f"{k:<30} {v}")

    add("sys.platform", sys.platform)
    add("Python", sys.version.replace("\n", ""))
    add("numpy", numpy.__version__)
    add("torch", torch.__version__)
    add("torch CUDA", torch.version.cuda)
    add("CUDA available", torch.cuda.is_available())
    if torch.cuda.is_available():
        add("devices", ", ".join(torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())))
        add("card (name, power limit)", card_line())
    from ..parallel import dist as dist_lib

    add("rank / world size", f"{dist_lib.rank()} / {dist_lib.world()}")
    add("hostname", platform.node())
    return "\n".join(rows)
