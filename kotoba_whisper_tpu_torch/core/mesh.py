"""Device mesh and the tensor-parallel sharding rules.

A `torch.distributed.device_mesh.DeviceMesh` over the ranks, with dims
("data", "model"): data parallelism splits the batch over "data", tensor
parallelism splits the teacher's attention heads and ffn dims over
"model". The ranks are laid out as the JAX package lays out devices:
`reshape(data, model)` of the rank order (host-major), so a model group
holds consecutive ranks of one host, or with `model_across_processes`
`reshape(model, data).T`, one rank of each host block per group.

The rules (megatron layout), by a parameter's state-dict name:
  - column-parallel, the output dim split: q_proj, k_proj, v_proj, the
    fused qkv_proj and kv_proj, fc1, and their w8a8 `weight_scale`;
  - row-parallel, the input dim split: out_proj, fc2 (their per-output
    `weight_scale` stays whole);
  - everything else replicated: LayerNorms, positions, the token
    embedding (so the logits stay whole on every rank) and the conv stem.

A port weight is (out, in), so the output dim is dim 0, where the JAX
package's (in, out) kernels split dim 1. A column-parallel bias is split
with its outputs (the JAX package keeps it whole and GSPMD slices the
add); the JAX package splits the conv stem's output channels, the port
keeps the stem whole, which computes the same function.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DATA_AXIS = "data"
MODEL_AXIS = "model"

COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "qkv_proj", "kv_proj", "fc1")
ROW_PARALLEL = ("out_proj", "fc2")


@dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: every rank left
    model: int = 1
    # lay each model group across hosts (one rank of each host block)
    # instead of within one host
    model_across_processes: bool = False

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = self.model
        data = self.data if self.data != -1 else n_devices // model
        if data * model != n_devices:
            raise ValueError(f"mesh {data}x{model} != {n_devices} devices")
        return data, model


def mesh_ranks(cfg: MeshConfig, n_ranks: int) -> np.ndarray:
    """(data, model) array of global ranks."""
    data, model = cfg.resolve(n_ranks)
    ranks = np.arange(n_ranks)
    if cfg.model_across_processes:
        return ranks.reshape(model, data).T
    return ranks.reshape(data, model)


def build_mesh(cfg: MeshConfig = MeshConfig(), device_type: str = "cpu"):
    """The DeviceMesh over every rank of the process group (every rank
    calls this, with the same cfg). `device_type` names where the ranks'
    tensors live ("cuda" or "cpu"); the groups use the process group's
    backend."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    layout = mesh_ranks(cfg, dist.get_world_size())
    return DeviceMesh(device_type, layout.tolist(), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def param_spec(name: str) -> tuple:
    """The partition spec of a parameter or buffer of the port's model, by
    its state-dict name: one entry per dim, MODEL_AXIS where the model
    axis splits that dim, None where it does not; () replicated."""
    parts = name.split(".")
    if "layers" not in parts or len(parts) < 2:
        return ()  # embeddings, positions, final LayerNorms, conv stem
    leaf, parent = parts[-1], parts[-2]
    if parent in COLUMN_PARALLEL:
        if leaf in ("weight", "weight_q"):
            return (MODEL_AXIS, None)
        if leaf in ("bias", "weight_scale"):
            return (MODEL_AXIS,)
    if parent in ROW_PARALLEL and leaf in ("weight", "weight_q"):
        return (None, MODEL_AXIS)
    return ()
