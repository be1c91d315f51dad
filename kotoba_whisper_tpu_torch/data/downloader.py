"""ReazonSpeech shard downloader with integrity-checked retry.

Counterpart of reazonspeech_manual_downloader.py: multiprocess HTTP download
of tar shards + TSV (:63-121), tar integrity check (:42-60), and a
retry-until-clean loop with a `--health_check` mode (:72-80,96-121). The
dataset size table (:21-28) is config, not code: pass `base_url` and shard
count. Zero-egress test environments exercise the retry/health-check logic
via file:// URLs.

A copy of the JAX package's data/downloader.py, which imports no JAX,
over the port's data/reazon.check_tar_integrity.
"""
from __future__ import annotations

import concurrent.futures as futures
import os
import time
import urllib.request
from dataclasses import dataclass

from kotoba_whisper_tpu_torch.data.reazon import check_tar_integrity

# ReazonSpeech v2 scale presets (shard counts; the reference's DATASET
# table at reazonspeech_manual_downloader.py:21-28)
SIZE_PRESETS = {
    "tiny": 1,
    "small": 12,
    "medium": 105,
    "large": 419,
    "all": 4096,
}


@dataclass
class DownloadConfig:
    base_url: str
    out_dir: str
    n_shards: int
    tsv_name: str = "transcript.tsv"
    n_workers: int = 8
    max_retries: int = 10
    retry_sleep_s: float = 5.0
    shard_name: str = "{idx:03x}.tar"  # v2 uses hex-named shards


def _fetch(url: str, dest: str) -> None:
    tmp = dest + ".part"
    with urllib.request.urlopen(url) as r, open(tmp, "wb") as f:
        while True:
            buf = r.read(1 << 20)
            if not buf:
                break
            f.write(buf)
    os.replace(tmp, dest)


def download_shard(cfg: DownloadConfig, idx: int) -> str:
    name = cfg.shard_name.format(idx=idx)
    dest = os.path.join(cfg.out_dir, name)
    _fetch(f"{cfg.base_url}/{name}", dest)
    return dest


def broken_shards(cfg: DownloadConfig, indices: list[int]) -> list[int]:
    """Indices whose local tar is missing or fails integrity check."""
    bad = []
    for i in indices:
        path = os.path.join(cfg.out_dir, cfg.shard_name.format(idx=i))
        if not os.path.exists(path) or not check_tar_integrity(path):
            bad.append(i)
    return bad


def download_dataset(
    cfg: DownloadConfig, indices: list[int] | None = None
) -> list[int]:
    """Download shards (+TSV), re-downloading broken ones until clean or
    max_retries; returns indices still broken (empty on success)."""
    os.makedirs(cfg.out_dir, exist_ok=True)
    indices = indices if indices is not None else list(range(cfg.n_shards))

    tsv_dest = os.path.join(cfg.out_dir, cfg.tsv_name)
    if not os.path.exists(tsv_dest):
        _fetch(f"{cfg.base_url}/{cfg.tsv_name}", tsv_dest)

    pending = broken_shards(cfg, indices)
    for attempt in range(cfg.max_retries):
        if not pending:
            break
        with futures.ThreadPoolExecutor(cfg.n_workers) as pool:
            list(
                pool.map(
                    lambda i: _try_download(cfg, i), pending
                )
            )
        pending = broken_shards(cfg, pending)
        if pending:
            time.sleep(cfg.retry_sleep_s)
    return pending


def _try_download(cfg: DownloadConfig, idx: int) -> None:
    try:
        download_shard(cfg, idx)
    except Exception:
        pass  # caught by the next broken_shards() pass


def health_check(cfg: DownloadConfig) -> list[int]:
    """--health_check mode: report broken shard indices without fetching."""
    return broken_shards(cfg, list(range(cfg.n_shards)))
