"""Per-chunk dataset merger.

Counterpart of misc/merge_reazon_all_dataset.py: concatenates the per-chunk
stage outputs into `split_N` groups of `chunks_per_split` chunks each
(:11-79 — the reference groups 82 chunks into splits of 10 and pushes each
as a Hub config). Local-file equivalent of the Hub-config merge, writing
the **sharded mmap layout** (data/shards.py) so the distillation driver can
stream a 1,253-hour split with bounded RSS — the reference gets the same
property from `datasets`' arrow memory-mapping.

Chunks are converted one at a time (each chunk's features.npz is loaded,
re-sharded, and dropped before the next), so merge memory is bounded by
one chunk regardless of split size.
"""
from __future__ import annotations

import os

from kotoba_whisper_tpu_torch.data.shards import ShardWriter, convert_npz_dir


def merge_chunks(
    chunk_dirs: list[str],
    output_dir: str,
    chunks_per_split: int = 10,
    shard_size: int = 2048,
) -> list[str]:
    """Each chunk dir holds filtered.jsonl (+ features.npz). Returns the
    split dirs written (each: filtered.jsonl + features_*.npy + index)."""
    splits = []
    for s, lo in enumerate(range(0, len(chunk_dirs), chunks_per_split)):
        group = chunk_dirs[lo : lo + chunks_per_split]
        split_dir = os.path.join(output_dir, f"split_{s}")
        writer = ShardWriter(split_dir, shard_size=shard_size)
        for d in group:
            convert_npz_dir(d, writer)
        writer.close()
        splits.append(split_dir)
    return splits


def chunk_status(work_dir: str, n_chunks: int) -> dict[str, list[int]]:
    """Chunk-completion audit (misc/preprocess_status_log.py equivalent):
    which chunk indices have finished the filter stage."""
    done, missing = [], []
    for i in range(n_chunks):
        path = os.path.join(work_dir, f"chunk_{i}", "filtered", "filtered.jsonl")
        (done if os.path.exists(path) else missing).append(i)
    return {"done": done, "missing": missing}
