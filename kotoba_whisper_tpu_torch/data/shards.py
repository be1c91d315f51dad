"""Sharded, memory-mapped feature store for training (the JAX package's
layout, so either package reads the other's splits).

- Features are raw `.npy` shards (`features_00000.npy`, ..., fp16,
  shape (n, n_mels, n_frames)) next to `filtered.jsonl` and a
  `shard_index.json`. `.npy` memory-maps, so shuffled training touches
  only the pages a batch needs and the OS page cache manages residency.
- `FeatureStore.gather(indices)` reads any rows of a split; global
  indices map to (shard, local) pairs fetched shard by shard.
- Legacy single-`features.npz` dirs load through the same interface.
"""
from __future__ import annotations

import json
import os
from typing import Iterable

import numpy as np

from kotoba_whisper_tpu_torch.cli.common import read_jsonl, write_jsonl

INDEX_NAME = "shard_index.json"
ROWS_NAME = "filtered.jsonl"
LEGACY_NPZ = "features.npz"


def shard_path(dir_: str, k: int) -> str:
    return os.path.join(dir_, f"features_{k:05d}.npy")


class ShardWriter:
    """Stream (row, feature) pairs into the sharded layout, holding at most
    `shard_size` utterances of features in RAM; rows (small label records)
    are kept until close()."""

    def __init__(self, out_dir: str, shard_size: int = 2048):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.shard_size = shard_size
        self.rows: list[dict] = []
        self._buf: list[np.ndarray] = []
        self._shard_sizes: list[int] = []
        self._feat_shape: tuple[int, ...] | None = None

    def add(self, row: dict, feature: np.ndarray | None) -> None:
        self.rows.append(row)
        if feature is not None:
            if self._feat_shape is None:
                self._feat_shape = tuple(feature.shape)
            self._buf.append(np.asarray(feature, np.float16))
            if len(self._buf) >= self.shard_size:
                self._flush()

    def add_batch(self, rows: Iterable[dict], features: np.ndarray | None) -> None:
        rows = list(rows)
        if features is None:
            self.rows.extend(rows)
            return
        if len(rows) != features.shape[0]:
            raise ValueError(f"{len(rows)} rows for {features.shape[0]} features")
        for r, f in zip(rows, features):
            self.add(r, f)

    def _flush(self) -> None:
        if not self._buf:
            return
        arr = np.stack(self._buf).astype(np.float16)
        np.save(shard_path(self.out_dir, len(self._shard_sizes)), arr)
        self._shard_sizes.append(arr.shape[0])
        self._buf = []

    def close(self) -> dict:
        self._flush()
        write_jsonl(os.path.join(self.out_dir, ROWS_NAME), iter(self.rows))
        index = {
            "shard_sizes": self._shard_sizes,
            "n_rows": len(self.rows),
            "feature_shape": list(self._feat_shape) if self._feat_shape else None,
            "dtype": "float16",
        }
        if self._shard_sizes:
            with open(os.path.join(self.out_dir, INDEX_NAME), "w") as f:
                json.dump(index, f)
        return index


class FeatureStore:
    """Random-access view over one split dir (sharded or legacy layout)."""

    def __init__(self, dir_: str):
        self.dir = dir_
        self.rows = read_jsonl(os.path.join(dir_, ROWS_NAME))
        index_path = os.path.join(dir_, INDEX_NAME)
        npz_path = os.path.join(dir_, LEGACY_NPZ)
        self._mmaps: dict[int, np.ndarray] = {}
        self._legacy = None
        self._offsets = None  # labels-only dir when neither file exists
        if os.path.exists(index_path):
            with open(index_path) as f:
                self.index = json.load(f)
            sizes = np.asarray(self.index["shard_sizes"], np.int64)
            self._offsets = np.concatenate([[0], np.cumsum(sizes)])
            if self._offsets[-1] != len(self.rows):
                raise ValueError(f"{dir_}: {self._offsets[-1]} features != {len(self.rows)} rows")
        elif os.path.exists(npz_path):
            self._legacy = np.load(npz_path)["input_features"]
            if self._legacy.shape[0] != len(self.rows):
                raise ValueError(f"{dir_}: {self._legacy.shape[0]} features != {len(self.rows)} rows")

    def __len__(self) -> int:
        return len(self.rows)

    @property
    def has_features(self) -> bool:
        return self._legacy is not None or self._offsets is not None

    def _shard(self, k: int) -> np.ndarray:
        m = self._mmaps.get(k)
        if m is None:
            m = np.load(shard_path(self.dir, k), mmap_mode="r")
            self._mmaps[k] = m
        return m

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """Features for global indices (any order), fp16 (n, ...)."""
        indices = np.asarray(indices, np.int64)
        if self._legacy is not None:
            return self._legacy[indices]
        if self._offsets is None:
            raise ValueError(f"{self.dir} has no features")
        shard_ids = np.searchsorted(self._offsets, indices, side="right") - 1
        out = None
        for k in np.unique(shard_ids):
            sel = shard_ids == k
            vals = self._shard(int(k))[indices[sel] - self._offsets[k]]
            if out is None:
                out = np.empty((len(indices),) + vals.shape[1:], vals.dtype)
            out[sel] = vals
        return out

    def warm(self) -> None:
        """Touch every shard so the OS page cache holds it (next-split
        prefetch while the current split trains)."""
        if self._offsets is None:
            return
        for k in range(len(self.index["shard_sizes"])):
            arr = self._shard(k)
            np.asarray(arr[:: max(1, len(arr) // 64)]).sum()


def convert_npz_dir(src_dir: str, writer: ShardWriter) -> int:
    """Stream one chunk dir of the filter stage (filtered.jsonl and, unless
    it ran with --skip_logmel, features.npz) into a ShardWriter, one
    chunk's features in memory at a time. -> rows written."""
    rows = read_jsonl(os.path.join(src_dir, ROWS_NAME))
    npz_path = os.path.join(src_dir, LEGACY_NPZ)
    feats = None
    if os.path.exists(npz_path):
        feats = np.load(npz_path)["input_features"]
        if feats.shape[0] != len(rows):
            raise ValueError(f"{src_dir}: {feats.shape[0]} features != {len(rows)} rows")
    writer.add_batch(rows, feats)
    return len(rows)


def resolve_split_dirs(spec: str) -> list[str]:
    """A --train_splits argument: a comma list of dirs, a root dir holding
    split_* subdirs, or one dir."""
    if "," in spec:
        return [s for s in (p.strip() for p in spec.split(",")) if s]
    if os.path.isdir(spec):
        subs = sorted(
            (d for d in os.listdir(spec) if d.startswith("split_")),
            key=lambda d: int(d.split("_")[1]),
        )
        if subs:
            return [os.path.join(spec, d) for d in subs]
    return [spec]
