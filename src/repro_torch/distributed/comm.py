"""The collectives of a process group: the port's named-axis functions.

Where the reference calls ``jax.lax.psum(x, "data")`` inside
``shard_map``, the port calls ``comm.psum(x, group)`` in each of the
group's processes, one process per rank.  Every other module of the
multi-device path goes through these functions and never through
``torch.distributed`` itself:

  * ``psum``       — ``all_reduce`` SUM, on integer tensors only.  A
                     float sum across ranks never goes through
                     ``all_reduce``, whose order is unspecified: float
                     payloads are gathered and folded in rank order by
                     the caller;
  * ``pmax``       — the max across ranks, NaN-propagating: the W values
                     are gathered and reduced with ``torch.amax`` in rank
                     order (``all_reduce`` MAX leaves NaN undefined);
  * ``all_gather`` — the ranks' tensors stacked on a new leading axis, in
                     rank order;
  * ``axis_index`` / ``axis_size`` — this rank and the group's size;
  * ``init_group`` — the default group from torchrun's environment, an
                     ``init_method`` (``file://`` or ``tcp://``), or one
                     rank alone when neither is given.

The caller names the group's backend: NCCL where each rank has a GPU of
its own, gloo otherwise (NCCL refuses two ranks on one GPU).  Gloo takes
CUDA tensors for some collectives only, and stages them through host
memory where it does; so on a gloo group every CUDA payload is copied to
the host and back here, explicitly, and the copies are counted in
``STATS["bytes_staged"]``.  The rule is the backend's and the tensor's
device, fixed before the call: no path is chosen by catching an error.
``STATS["bytes_across"]`` counts the payload bytes this rank hands to
collectives, ``STATS["calls"]`` the collectives and ``STATS["ms"]`` the
wall time spent in them, staging included.  A group of one rank runs no
collective at all: its sum and max are the tensor itself, its gather the
tensor on a new axis.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

#: this process's collective traffic since ``reset_stats``
STATS = {"calls": 0, "bytes_across": 0, "bytes_staged": 0, "ms": 0.0}

#: seconds a collective waits for the other ranks before it fails
TIMEOUT_S = 600


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def read_stats() -> dict:
    return dict(STATS)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _backend(group) -> str:
    return str(dist.get_backend(group)).lower()


def _staged(group, x: torch.Tensor) -> bool:
    """True where this payload crosses through host memory: a CUDA tensor
    on a gloo group."""
    return x.is_cuda and _backend(group) == "gloo"


def _send(group, x: torch.Tensor) -> torch.Tensor:
    """The tensor handed to the collective: a private contiguous copy
    (collectives write in place), on the host for a staged payload."""
    STATS["calls"] += 1
    STATS["bytes_across"] += _nbytes(x)
    if _staged(group, x):
        STATS["bytes_staged"] += _nbytes(x)
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().clone().contiguous()


def _receive(group, out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if _staged(group, like):
        STATS["bytes_staged"] += _nbytes(out)
        return out.to(like.device)
    return out


def axis_size(group) -> int:
    """The number of ranks in ``group`` (``jax.lax.psum(1, axis)``)."""
    return dist.get_world_size(group)


def axis_index(group) -> int:
    """This process's rank in ``group`` (``jax.lax.axis_index``)."""
    return dist.get_rank(group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise integer sum across the group's ranks (int32 wraps, as
    XLA's int32 psum does); any reduction order gives the same bits."""
    if x.is_floating_point() or x.is_complex() or x.dtype == torch.bool:
        raise TypeError(
            f"comm.psum sums integer tensors only, got {x.dtype}: a float "
            f"sum across ranks has no pinned order (gather and fold it in "
            f"rank order instead)")
    if axis_size(group) == 1:
        return x
    t0 = time.perf_counter()
    w = _send(group, x)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    out = _receive(group, w, x)
    STATS["ms"] += (time.perf_counter() - t0) * 1e3
    return out


def psum_int(n: int, group, device=None) -> int:
    """The sum of one Python int per rank (row counts, world sizes)."""
    dev = _scalar_device(group, device)
    return int(psum(torch.tensor(int(n), dtype=torch.int64, device=dev),
                    group))


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(W, *x.shape): every rank's ``x``, stacked in rank order.  Every
    rank passes the same shape and dtype."""
    world = axis_size(group)
    if world == 1:
        return x[None]
    t0 = time.perf_counter()
    w = _send(group, x)
    out = torch.empty((world,) + tuple(x.shape), dtype=x.dtype,
                      device=w.device)
    dist.all_gather(list(out.unbind(0)), w, group=group)
    out = _receive(group, out, x)
    STATS["ms"] += (time.perf_counter() - t0) * 1e3
    return out


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max across ranks; a NaN on any rank gives NaN."""
    return torch.amax(all_gather(x, group), dim=0)


def barrier(group) -> None:
    dist.barrier(group=group)


def _scalar_device(group, device=None) -> torch.device:
    """Where a small host-built payload lives: the rank's CUDA device on
    an NCCL group (NCCL takes no host tensor), else the CPU."""
    if _backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device()) \
            if device is None else torch.device(device)
    return torch.device("cpu")


def init_group(backend: str = "gloo", *, init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None):
    """The default process group, started once per process -> its
    ``ProcessGroup``.

    * torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
      ``MASTER_PORT``), as ``python -m torch.distributed.run`` sets it;
    * else ``init_method`` (``file:///path`` or ``tcp://host:port``) with
      ``rank`` and ``world_size``;
    * else one rank alone, on an in-memory store.

    ``backend`` is "gloo" or "nccl" (NCCL needs a GPU for each rank).
    This is the counterpart of the reference's ``launch/mesh.make_mesh``:
    one data-parallel axis whose size is the world size.  A second call
    returns the group already started, and raises if it differs in
    backend, rank or size."""
    env = os.environ
    if init_method is None and rank is None and "RANK" in env \
            and "WORLD_SIZE" in env:
        init_method = "env://"
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
    if dist.is_initialized():
        group = dist.group.WORLD
        if (_backend(group) != backend.lower()
                or (rank is not None and rank != dist.get_rank(group))
                or (world_size is not None
                    and world_size != dist.get_world_size(group))):
            raise RuntimeError(
                f"comm.init_group: a process group is already started "
                f"({_backend(group)}, rank {dist.get_rank(group)} of "
                f"{dist.get_world_size(group)}), unlike the one asked for "
                f"({backend}, rank {rank} of {world_size})")
        return group
    timeout = timedelta(seconds=TIMEOUT_S)
    if init_method is None:
        if rank not in (None, 0) or world_size not in (None, 1):
            raise ValueError("comm.init_group: a group of more than one "
                             "rank needs torchrun's environment or an "
                             "init_method")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    else:
        if rank is None or world_size is None:
            raise ValueError(f"comm.init_group(init_method="
                             f"{init_method!r}) needs rank and world_size")
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size,
                                timeout=timeout)
    return dist.group.WORLD


def destroy_group() -> None:
    """Stop the default group (a no-op when none was started)."""
    if dist.is_initialized():
        dist.destroy_process_group()


__all__ = ["STATS", "reset_stats", "read_stats", "axis_size", "axis_index",
           "psum", "psum_int", "all_gather", "pmax", "barrier",
           "init_group", "destroy_group"]
