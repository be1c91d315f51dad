"""Placing a model and a batch on a mesh (core/mesh.py).

- `place_params(mesh, model, model_sharded=True)` turns a whole model into
  this rank's tensor-parallel shard, in place: every column-parallel
  projection keeps its rank's output block, every row-parallel one its
  input block and the model group to sum over (models/whisper.dense), and
  the model records its group (`tp_size`, `tp_group`), from which the
  layer functions take the rank's heads and cache width. Without
  `model_sharded` the model is replicated: every rank holds the same
  weights (the same seed or checkpoint), and `replicate` makes sure.
- `place_batch(mesh, batch)` gives this rank its rows of a host's batch:
  block `d` of `n` contiguous blocks, d the rank's data index on its host
  (the JAX package's device placement of a process-local batch). Ranks of
  one model group take the same rows.
- `gather_params` reassembles the whole model's state dict from the
  shards (the inverse of place_params).

A fused projection (qkv_proj (3d, d), kv_proj (2d, d)) gives a rank the
same heads of each of its parts: head block r of q, of k and of v, in
that order, so that the rank's output still chunks into q, k and v. (The
JAX package splits the fused kernel's columns contiguously and GSPMD
reshards the split.)
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from kotoba_whisper_tpu_torch.core.mesh import (
    COLUMN_PARALLEL,
    DATA_AXIS,
    MODEL_AXIS,
    ROW_PARALLEL,
    param_spec,
)

# the fused projections' parts, each split by heads on its own
_PARTS = {"qkv_proj": 3, "kv_proj": 2}


def model_coords(mesh) -> tuple[int, int]:
    """(rank in the model group, model group size)."""
    return mesh.get_local_rank(MODEL_AXIS), mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))


def data_coords(mesh, hosts: int = 1) -> tuple[int, int]:
    """(this rank's data index on its host, data ranks a host), for a mesh
    whose data dim spans `hosts` hosts of equal blocks."""
    n = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
    if n % hosts:
        raise ValueError(f"{n} data ranks do not split over {hosts} hosts")
    per_host = n // hosts
    return mesh.get_local_rank(DATA_AXIS) % per_host, per_host


def _split(t: torch.Tensor, dim: int, parts: int, r: int, m: int) -> torch.Tensor:
    """Block r of m along `dim` of each of `parts` equal parts."""
    shape = list(t.shape)
    v = t.reshape(shape[:dim] + [parts, shape[dim] // parts] + shape[dim + 1:])
    blk = shape[dim] // parts // m
    v = v.narrow(dim + 1, r * blk, blk)
    shape[dim] //= m
    return v.reshape(shape).contiguous()


def _shard_linear(lin: nn.Module, name: str, r: int, m: int, group) -> None:
    parts = _PARTS.get(name, 1)
    weight_names = ("weight_q", "weight_scale") if hasattr(lin, "weight_q") else ("weight",)
    if name in COLUMN_PARALLEL:
        for w in weight_names + ("bias",):
            t = getattr(lin, w)
            if t is not None:
                _assign(lin, w, _split(t.data, 0, parts, r, m))
    else:  # row-parallel: the input dim; per-output scale and bias stay whole
        w = weight_names[0]
        _assign(lin, w, _split(getattr(lin, w).data, 1, 1, r, m))
        lin.reduce_group = group
    if isinstance(lin, nn.Linear):
        lin.out_features, lin.in_features = lin.weight.shape


def _assign(mod: nn.Module, name: str, value: torch.Tensor) -> None:
    old = getattr(mod, name)
    if isinstance(old, nn.Parameter):
        setattr(mod, name, nn.Parameter(value, requires_grad=old.requires_grad))
    else:
        setattr(mod, name, value)


def check_divides(cfg, m: int) -> None:
    """Raise unless the model axis m divides the heads and ffn dims."""
    for what in ("encoder_attention_heads", "decoder_attention_heads",
                 "encoder_ffn_dim", "decoder_ffn_dim"):
        if getattr(cfg, what) % m:
            raise ValueError(f"the model axis {m} does not divide {what}={getattr(cfg, what)}")


@torch.no_grad()
def place_params(mesh, model, model_sharded: bool = False):
    """This rank's placement of a whole model, in place; returns the model.
    Replicated unless `model_sharded`."""
    if not model_sharded:
        return model
    r, m = model_coords(mesh)
    if m == 1:
        return model
    check_divides(model.cfg, m)
    group = mesh.get_group(MODEL_AXIS)
    for part in (model.model.encoder, model.model.decoder):
        for layer in part.layers:
            for mod in layer.modules():
                for name, child in list(mod.named_children()):
                    if name in COLUMN_PARALLEL + ROW_PARALLEL:
                        _shard_linear(child, name, r, m, group)
    model.tp_size, model.tp_group = m, group
    return model


def _gather(t: torch.Tensor, dim: int, parts: int, group, m: int) -> torch.Tensor:
    pieces = [torch.empty_like(t) for _ in range(m)]
    dist.all_gather(pieces, t.contiguous(), group=group)
    if parts == 1:
        return torch.cat(pieces, dim)
    split = [p.chunk(parts, dim) for p in pieces]
    return torch.cat([torch.cat([s[i] for s in split], dim) for i in range(parts)], dim)


@torch.no_grad()
def gather_params(mesh, model) -> dict[str, torch.Tensor]:
    """The whole model's state dict from a tensor-parallel model's shards
    (collective over the model group; a replicated model's own)."""
    sd = model.state_dict()
    m = getattr(model, "tp_size", 1)
    if m == 1:
        return sd
    group = mesh.get_group(MODEL_AXIS)
    out = {}
    for name, t in sd.items():
        parts = name.split(".")
        proj = parts[-2] if len(parts) >= 2 else ""
        spec = param_spec(name)
        if MODEL_AXIS in spec:
            t = _gather(t, spec.index(MODEL_AXIS), _PARTS.get(proj, 1), group, m)
        out[name] = t
    return out


def rank_rows(n: int, index: int, count: int, microbatches: int = 1) -> np.ndarray:
    """The row indices of data rank `index` of `count` in a batch of n
    rows split into `microbatches` equal microbatches: each microbatch's
    contiguous block `index`, as the JAX step's sharded reshape hands
    them to its devices. One microbatch: block `index` of the batch."""
    per = n // microbatches
    if n % microbatches or per % count:
        raise ValueError(f"a batch of {n} rows does not split into {microbatches} "
                         f"microbatches over {count} data ranks")
    blk = per // count
    return np.concatenate([np.arange(i * per + index * blk, i * per + (index + 1) * blk)
                           for i in range(microbatches)])


def place_batch(mesh, batch: Any, hosts: int = 1) -> Any:
    """This rank's rows (leading dim) of every leaf of a host's batch."""
    d, n = data_coords(mesh, hosts)

    def take(x):
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split over {n} data ranks")
        b = x.shape[0] // n
        return x[d * b:(d + 1) * b]

    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    return take(batch)


@torch.no_grad()
def replicate(tree: Any) -> Any:
    """Make every tensor of a tree (a module's parameters and buffers, a
    dict, a list) equal to the first rank's, in place; returns the tree."""
    if isinstance(tree, nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, dict):
        tensors = [v for v in tree.values() if isinstance(v, torch.Tensor)]
    else:
        tensors = [v for v in tree if isinstance(v, torch.Tensor)]
    if dist.is_initialized() and dist.get_world_size() > 1:
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return tree
