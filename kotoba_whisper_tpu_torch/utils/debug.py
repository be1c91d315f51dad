"""Debug / sanity utilities (SURVEY §5.2).

The reference has no race detection or sanitizers; its correctness relies
on barriers. As in the JAX package, an opt-in debug mode and checksums:

  - `debug_mode()`: autograd anomaly detection with NaN checks, so the
    backward op that made a NaN raises with the forward op's stack trace;
  - `tree_checksum` / `assert_params_in_sync`: cross-rank checksum of a
    parameter tree — catches desynchronized replicated state in
    multi-process runs (e.g. rank-dependent data ordering bugs) before it
    corrupts a training run;
  - `find_nonfinite`: the key paths of NaN/Inf leaves, written as JAX's
    keystr writes them (['encoder']['layers'][0]).

Trees are nested dicts, lists, tuples and named tuples of tensors, numpy
arrays or numbers; dict keys are walked sorted, as JAX flattens dicts, and
OrderedDicts (a state dict) in their order.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Any, Iterator

import numpy as np
import torch


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False):
    """`nans`: torch.autograd.detect_anomaly(check_nan=True) for the block.
    `disable_jit` is accepted for the JAX package's signature and does
    nothing: the port runs eagerly, with nothing compiled to turn off."""
    with contextlib.ExitStack() as ctx:
        if nans:
            ctx.enter_context(torch.autograd.detect_anomaly(check_nan=True))
        yield


def _leaves(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    if tree is None:
        return
    if isinstance(tree, collections.OrderedDict):
        items = tree.items()
    elif isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{path}.{name}")
        return
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield path, tree
        return
    for key, sub in items:
        yield from _leaves(sub, f"{path}[{key!r}]")


def _as_f32(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float()
    return torch.from_numpy(np.asarray(leaf, np.float32))


def tree_checksum(tree: Any) -> float:
    """Order-stable scalar fingerprint of a tree (sum of per-leaf L1
    norms in fp32, summed in fp64 on the host). Cheap enough to run every
    few hundred steps."""
    total = 0.0
    for _, leaf in _leaves(tree):
        total += float(torch.sum(torch.abs(_as_f32(leaf))))
    return total


def assert_params_in_sync(params: Any, atol: float = 1e-3) -> float:
    """All ranks must hold the same replicated params: allgather the
    checksum and compare. Returns the checksum. No-op on one process."""
    from kotoba_whisper_tpu_torch.parallel import multihost

    checksum = tree_checksum(params)
    if multihost.process_count() == 1:
        return checksum
    gathered = multihost.all_gather_host(np.asarray([checksum], np.float64))
    if not np.allclose(gathered, gathered[0], atol=atol, rtol=1e-7):
        raise AssertionError(
            f"replicated params desynchronized across ranks: {gathered}"
        )
    return checksum


def find_nonfinite(tree: Any) -> list[str]:
    """Paths of leaves containing NaN/Inf (post-mortem helper)."""
    return [path for path, leaf in _leaves(tree)
            if not bool(torch.all(torch.isfinite(_as_f32(leaf))))]
