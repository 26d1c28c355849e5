"""Multi-process orchestration over ``torch.distributed`` (port of
``sview_fmindex_tpu.parallel.distributed``).

The JAX package runs one program over a device mesh (``shard_map``); the
port runs one PROCESS per device (a rank), the same program on every rank,
and the collectives of ``torch.distributed`` take the place of the mesh's.

Entry points:
- :func:`initialize` joins this process to the group, from arguments or the
  ``SVIEW_COORD`` / ``SVIEW_NUM_PROCS`` / ``SVIEW_PROC_ID`` environment
  triplet, and settles this rank's device and the backend.
- :func:`global_mesh`: a 1-D mesh over every rank.
- :func:`shard_batch`: this rank's rows of the full batch that every rank
  passes.
- :func:`replicate`: the index whole on this rank's device (each rank
  uploads its own copy).
- :func:`allgather`: a sharded result, whole, as numpy on every rank.

The backend follows one rule, decided before any collective runs: NCCL
where every rank has a GPU of its own, gloo where ranks share a device (CPU
ranks; more ranks than GPUs on a host).  Under gloo every collective runs
on host tensors: a device tensor is staged through the host and back.
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class Runtime:
    """What :func:`initialize` settled for this process."""

    device: torch.device
    backend: str
    timeout: datetime.timedelta


_runtime: Runtime | None = None


def choose_backend(device_type: str, procs_per_host: int, n_gpus: int) -> str:
    """NCCL where every rank of a host has a GPU of its own, gloo where ranks
    share a device (the CPU, or fewer GPUs than ranks)."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if procs_per_host <= n_gpus else "gloo"


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device: str | None = None,
               procs_per_host: int | None = None,
               timeout: "datetime.timedelta | float | None" = None) -> Runtime:
    """Join this process to the group.

    ``coordinator`` is ``host:port`` of rank 0 (or any ``torch.distributed``
    init URL, e.g. ``file:///path``); it, ``num_processes`` and
    ``process_id`` default to SVIEW_COORD / SVIEW_NUM_PROCS / SVIEW_PROC_ID.
    ``device`` is ``"cuda"`` (the default; raises where there is none) or
    ``"cpu"``; with ``procs_per_host`` ranks on each host (default: all of
    them on this one), rank i takes GPU ``i % procs_per_host`` of its host
    when there are enough, else ranks share the GPUs round-robin.
    ``timeout`` (seconds or a timedelta) bounds every collective of every
    group made from this runtime, so a lost rank fails its peers instead of
    hanging them.
    """
    global _runtime
    coordinator = coordinator or os.environ.get("SVIEW_COORD")
    if num_processes is None and "SVIEW_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["SVIEW_NUM_PROCS"])
    if process_id is None and "SVIEW_PROC_ID" in os.environ:
        process_id = int(os.environ["SVIEW_PROC_ID"])
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize needs coordinator, num_processes and process_id (or "
            "SVIEW_COORD / SVIEW_NUM_PROCS / SVIEW_PROC_ID)")
    if timeout is None:
        timeout = DEFAULT_TIMEOUT
    elif not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=float(timeout))
    if device not in (None, "cuda", "cpu"):
        raise ValueError(f"device is 'cuda' or 'cpu' (the rank picks the index), got {device!r}")
    if device is None or device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: ranks run on GPUs by default; pass device='cpu' "
                "to run them on the CPU")
        device = "cuda"
    procs_per_host = procs_per_host or num_processes
    n_gpus = torch.cuda.device_count() if device == "cuda" else 0
    backend = choose_backend(device, procs_per_host, n_gpus)
    if device == "cuda":
        dev = torch.device("cuda", (process_id % procs_per_host) % n_gpus)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    _runtime = Runtime(device=dev, backend=backend, timeout=timeout)
    return _runtime


def runtime() -> Runtime:
    """This process's runtime; raises before :func:`initialize`."""
    if _runtime is None or not dist.is_initialized():
        raise RuntimeError("parallel.distributed.initialize() has not run in this process")
    return _runtime


def shutdown() -> None:
    """Leave the group (every rank calls it)."""
    global _runtime
    if dist.is_initialized():
        dist.destroy_process_group()
    _runtime = None


def global_mesh(axis: str = "dp"):
    """1-D mesh over every rank of the group."""
    from .mesh import make_mesh

    return make_mesh(axis=axis)


def shard_batch(mesh, arr, axis: str = "dp") -> torch.Tensor:
    """This rank's rows of the full batch, on its device.

    Every rank passes the SAME full array (cheap for pattern batches); rank
    coordinate c along ``axis`` keeps rows [c * per, (c + 1) * per).  The
    batch dim must divide the axis size (pad first: ShardedFmIndex._pad does).
    """
    n = mesh.size(axis)
    if arr.shape[0] % n:
        raise ValueError(f"batch of {arr.shape[0]} rows does not divide {n} shards")
    per = arr.shape[0] // n
    c = mesh.coord(axis)
    piece = arr[c * per:(c + 1) * per]
    if isinstance(piece, torch.Tensor):
        return piece.to(mesh.device)
    return torch.as_tensor(np.ascontiguousarray(piece), device=mesh.device)


def replicate(mesh, index, **upload):
    """The index whole on this rank's device: each rank uploads its own copy.
    ``index`` is a host ``FmIndex`` (``upload``: keywords of
    ``DeviceFmIndex.from_host``) or a ``DeviceFmIndex``, whose tensors move."""
    from ..models.device_index import DeviceFmIndex

    if not isinstance(index, DeviceFmIndex):
        return DeviceFmIndex.from_host(index, device=mesh.device, **upload)
    moved = {f.name: getattr(index, f.name).to(mesh.device)
             for f in dataclasses.fields(index)
             if isinstance(getattr(index, f.name), torch.Tensor)}
    return dataclasses.replace(index, **moved)


# ----------------------------------------------------------------------
# collectives: one place decides, from the group's backend, where they run

def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over the group, on ``t``'s device, on every rank."""
    if _host_staged(t, group):
        h = t.cpu()
        dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group)
        return h.to(t.device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order, on ``t``'s device, on every rank.  bool travels as uint8 (gloo
    takes no bool)."""
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    world = dist.get_world_size(group)
    if dist.get_backend(group) == "nccl":
        # one output tensor, no list and no cat; the call has two names
        # across the torch versions the port meets
        single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        out = torch.empty((world * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        single(out, src.contiguous(), group=group)
    else:
        src = (src.cpu() if t.is_cuda else src).contiguous()
        parts = [torch.empty_like(src) for _ in range(world)]
        dist.all_gather(parts, src, group=group)  # the list form: gloo has it in every torch
        out = torch.cat(parts).to(t.device)
    return out.bool() if t.dtype == torch.bool else out


def gather_many(tensors, group) -> list:
    """:func:`gather_rows` of several integer or bool results in ONE
    collective: they travel flattened in one int64 row per rank."""
    world = dist.get_world_size(group)
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors])
    rows = gather_rows(flat[None], group)  # [world, total]
    out, off = [], 0
    for t in tensors:
        piece = rows[:, off:off + t.numel()].reshape(world * t.shape[0], *t.shape[1:])
        out.append(piece.to(t.dtype))
        off += t.numel()
    return out


def allgather(x, group=None) -> np.ndarray:
    """A rank-sharded result, whole, as numpy on every rank."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return gather_rows(x, group if group is not None else dist.group.WORLD).cpu().numpy()
