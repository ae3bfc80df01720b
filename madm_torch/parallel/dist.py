"""Data parallelism over processes on ``torch.distributed`` (port of
``madm_tpu/parallel/mesh.py``; the reference's NCCL DDP over detectron2's
``launch``, SURVEY.md §2.3).

Under GSPMD the JAX package's sharded step is the single-device step on the
global batch.  Here each rank holds a full copy of the model and steps on
its rows of the global batch, and the step keeps that equality where it
would break:

- ``local_rows``: rank r's rows [r B/R, (r+1) B/R), where ``shard_batch``
  places them on the data axis;
- ``all_reduce_mean_``: the trained gradients averaged over the ranks in
  buckets, once a step after the step's last backward (the step calls
  ``.backward()`` once a student pass; DDP would all-reduce each time);
- ``all_reduce_sum``: an all-reduce with a gradient (its backward
  all-reduces the cotangent), for the head's train-mode BatchNorm
  statistics, which GSPMD takes over the global batch;
- ``all_reduce_mean``: a mean without a gradient, for batch means that
  weigh losses (the 'batch' pseudo-weight, ``pv``) and for the metrics;
- ``zero1``: the optimizer state sharded over the ranks (ZeRO-1, what
  ``place_state(zero1=True)`` does once there is more than one device);
  ``consolidated_state_dict`` gathers it on rank 0 for a checkpoint that
  loads at any world size.

NCCL on CUDA and gloo on the CPU by default; ``backend='gloo'`` also runs
CUDA tensors (several ranks on one card, which NCCL refuses).  A backend
that fails to initialise raises: nothing falls back to running alone.
Without a process group every function here is the identity of one
process, and the step runs as it does alone; a group of one (``torchrun``
with one process) takes the collective paths, each a no-op in value.
"""

from __future__ import annotations

import os
import socket
import tempfile
from typing import Any, Callable, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

BUCKET_BYTES = 256 * 2 ** 20  # gradients all-reduced in flat buckets of this size


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_main() -> bool:
    """True on rank 0, the one that writes metrics, visualisations and
    checkpoints."""
    return rank() == 0


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init(rank_: int, world_size: int, init_method: str, device: torch.device,
         backend: Optional[str] = None) -> None:
    """Join a process group of ``world_size`` (``init_method`` e.g.
    ``tcp://localhost:<port>``); on CUDA, ``device`` becomes the current
    device first (NCCL binds to it)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend or default_backend(device), init_method=init_method,
                            rank=rank_, world_size=world_size)


def init_from_env(device_type: str = "cuda") -> torch.device:
    """Join the process group a launcher describes in the environment
    (``torchrun`` or a cluster launcher: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), as
    ``jax.distributed.initialize()`` does; returns this rank's device
    (``cuda:<LOCAL_RANK>``, or the CPU)."""
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed needs the launcher's environment: {', '.join(missing)} "
                           "not set (run under torchrun, or use --num_chips on one host)")
    device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) if device_type == "cuda"
              else torch.device("cpu"))
    init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://", device)
    return device


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank_: int, fn: Callable, world_size: int, init_method: str, devices: Sequence[str],
               backend: Optional[str], args: tuple, out_dir: str) -> None:
    """One spawned rank: join the group, run ``fn(*args)``, save what it
    returns for the parent, leave the group."""
    init(rank_, world_size, init_method, torch.device(devices[rank_]), backend)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank_}.pt"))
    finally:
        destroy()


def run_ranks(fn: Callable, world_size: int, devices: Sequence[str], backend: Optional[str] = None,
              args: tuple = ()) -> List[Any]:
    """Run ``fn(*args)`` in ``world_size`` spawned processes, rank r on
    ``devices[r]``, joined in one process group on localhost (``backend``,
    or NCCL on CUDA and gloo on the CPU); returns each rank's result, in
    rank order.  ``fn`` must be importable by name (the children start from
    a fresh interpreter) and return what ``torch.save`` writes."""
    import torch.multiprocessing as mp

    if len(devices) != world_size:
        raise ValueError(f"{world_size} ranks need {world_size} devices, got {list(devices)}")
    with tempfile.TemporaryDirectory(prefix="madm_ranks_") as out_dir:
        mp.start_processes(_rank_main, nprocs=world_size, join=True, start_method="spawn",
                           args=(fn, world_size, f"tcp://localhost:{free_port()}", list(devices),
                                 backend, tuple(args), out_dir))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]


def destroy() -> None:
    if initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def local_rows(global_batch: int) -> slice:
    """This rank's rows of a global batch: the contiguous block
    ``shard_batch`` puts on its device of the data axis."""
    n = world()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide over {n} ranks")
    per = global_batch // n
    return slice(rank() * per, (rank() + 1) * per)


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average ``tensors`` over the ranks in place: flattened into buckets of
    about ``BUCKET_BYTES`` of one dtype, one all-reduce a bucket."""
    if not initialized():
        return
    n = world()
    buckets: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        if not buckets or size + t.numel() * t.element_size() > BUCKET_BYTES \
                or buckets[-1][0].dtype != t.dtype:
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += t.numel() * t.element_size()
    for bucket in buckets:
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        flat.div_(n)
        torch._foreach_copy_(bucket, [v.view_as(t) for v, t in
                                      zip(flat.split([t.numel() for t in bucket]), bucket)])


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, with a gradient: the backward
    all-reduces the cotangent, so that each rank's parameters get the
    global loss's gradient through the shared statistic."""
    if not initialized():
        return t
    import torch.distributed.nn.functional as dist_fn

    return dist_fn.all_reduce(t)


@torch.no_grad()
def any_over_ranks(mask: torch.Tensor) -> torch.Tensor:
    """A boolean tensor OR-ed over the ranks (what a reduction over the
    global batch gives where ``mask`` says "anywhere in this rank's rows")."""
    if not initialized():
        return mask
    out = mask.to(torch.int32)
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out.bool()


@torch.no_grad()
def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks (no gradient); each rank's ``t`` is
    a mean over equal local batches, so this is the global batch's mean."""
    if not initialized():
        return t
    out = t.clone()
    dist.all_reduce(out)
    return out.div_(world())


def zero1(param_groups: Iterable[dict], optimizer_class, **defaults):
    """``optimizer_class`` over ``param_groups`` with its state sharded over
    the ranks (``ZeroRedundancyOptimizer``: each rank steps the parameters
    it owns, then broadcasts them)."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(list(param_groups), optimizer_class=optimizer_class, **defaults)


def is_sharded(optimizer) -> bool:
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return isinstance(optimizer, ZeroRedundancyOptimizer)


def consolidated_state_dict(optimizer) -> Optional[dict]:
    """The optimizer's whole state in the layout of an unsharded optimizer
    over the same groups: gathered on rank 0 under ZeRO-1 (every rank must
    call this), None on the other ranks."""
    if not is_sharded(optimizer):
        return optimizer.state_dict()
    optimizer.consolidate_state_dict(to=0)
    if torch.cuda.is_available():
        torch.cuda.synchronize()  # its copies to the host are non-blocking
    return optimizer.state_dict() if is_main() else None
