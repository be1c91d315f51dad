"""Multi-process runtime on torch.distributed: process-group init, barriers
and gathers of host arrays.

The port runs one process per card, torch's idiom, where the JAX package
runs one process per host that holds all of its host's devices. A job is
`host_count()` hosts of `local_size()` consecutive ranks each: global rank
= host index x local size + local rank. What the JAX package calls a
process is therefore a host here (`host_index`, `shard_for_host`), and
`process_index` / `process_count` count the port's processes, the ranks.

The backend follows the caller's device: NCCL when each rank drives a card
of its own, gloo on the CPU. NCCL missing from the torch build raises; no
rank falls back to gloo or to the CPU.
"""
from __future__ import annotations

import datetime
from typing import Any, Sequence, TypeVar

import numpy as np
import torch
import torch.distributed as dist

T = TypeVar("T")

_LOCAL_SIZE = 1
_HOST_GROUP = None


def backend_for(device: torch.device | str) -> str:
    """NCCL for ranks on cards, gloo on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("ranks on cards need NCCL, which this torch build lacks")
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"unsupported device {dev}")


def initialize(
    init_method: str,
    world_size: int,
    rank: int,
    *,
    device: torch.device | str,
    local_size: int = 1,
    backend: str | None = None,
    init_timeout_s: int = 7200,
) -> None:
    """Join the process group: `world_size` ranks, hosts of `local_size`.

    `init_method` is "tcp://host:port" (rank 0's address) or a
    "file://" store. A rank on a card must have made it current
    (torch.cuda.set_device) first. The 7200 s timeout is the reference's
    raised NCCL timeout. `backend` defaults to `backend_for(device)`; a
    caller that puts several ranks on one card, which NCCL refuses, names
    gloo itself."""
    global _LOCAL_SIZE, _HOST_GROUP
    if world_size % local_size:
        raise ValueError(f"{world_size} ranks do not split into hosts of {local_size}")
    dev = torch.device(device)
    backend = backend or backend_for(dev)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=init_timeout_s), **kw,
    )
    _LOCAL_SIZE = local_size
    _HOST_GROUP = None
    if world_size > local_size:
        # every rank enters new_group for every host, in host order
        for h in range(world_size // local_size):
            g = dist.new_group(list(range(h * local_size, (h + 1) * local_size)))
            if h == rank // local_size:
                _HOST_GROUP = g


def shutdown() -> None:
    global _LOCAL_SIZE, _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL_SIZE, _HOST_GROUP = 1, None


def process_index() -> int:
    """This process's global rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_size() -> int:
    return _LOCAL_SIZE if dist.is_initialized() else 1


def local_rank() -> int:
    return process_index() % local_size()


def host_index() -> int:
    return process_index() // local_size()


def host_count() -> int:
    return process_count() // local_size()


def host_group():
    """The process group of this host's ranks (the world on one host)."""
    return _HOST_GROUP


def is_main_process() -> bool:
    return process_index() == 0


def _group_size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def barrier(name: str = "barrier", group=None) -> None:
    """Every rank of `group` (default: the world) waits for the others
    (the reference's wait_for_everyone). `name` documents the call site."""
    if _group_size(group) > 1:
        dist.barrier(group=group)


def _wire_device(group) -> torch.device:
    """Where a host array travels for a collective of `group`."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_host(x: np.ndarray, group=None) -> np.ndarray:
    """Gather an array of the same shape from every rank of `group`,
    concatenated on axis 0 in rank order (gather_for_metrics)."""
    x = np.asarray(x)
    n = _group_size(group)
    if n == 1:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x)).to(_wire_device(group))
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return np.concatenate([p.cpu().numpy().reshape((-1,) + x.shape[1:]) for p in parts])


def pad_across_processes(x: np.ndarray, axis: int = 1, pad_value: int = 0,
                         group=None) -> np.ndarray:
    """Pad a rank's array along `axis` to the largest extent over `group`
    (accelerate's pad_across_processes), so that ragged outputs can be
    concatenated by all_gather_host."""
    x = np.asarray(x)
    sizes = all_gather_host(np.asarray([x.shape[axis]], np.int64), group)
    m = int(sizes.max())
    if x.shape[axis] == m:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, m - x.shape[axis])
    return np.pad(x, pad, constant_values=pad_value)


def host_copy(tree: Any) -> Any:
    """Host numpy copy of a tree (dicts, lists, tuples) of tensors: this
    rank's values. A tensor-parallel model's shards are reassembled by
    parallel/sharded.gather_params."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


def shard_for_host(items: Sequence[T]) -> list[T]:
    """Round-robin split of a work list (tar shards) across hosts."""
    return list(items[host_index()::host_count()])
