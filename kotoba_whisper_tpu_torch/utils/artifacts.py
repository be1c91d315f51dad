"""Artifact store: atomic publish + retry.

Local-filesystem equivalent of the reference's HF-Hub data bus and its
`safe_push` retry-forever loops (run_pseudo_labelling.py:43-51,
run_data_filtering.py:21-28, misc/merge_reazon_all_dataset.py:19-24):
stage outputs are published atomically (write to a temp dir, fsync, rename)
so readers never observe partial artifacts, with bounded retry for
transient filesystem errors. Also covers the hub utilities' list/delete
operations (misc/delete_hf_datasets.py, misc/hf_dataset_download.py).

A copy of the JAX package's utils/artifacts.py, which imports no JAX.
"""
from __future__ import annotations

import os
import shutil
import time
from typing import Callable


def safe_publish(
    build_fn: Callable[[str], None],
    dest_dir: str,
    max_retries: int = 5,
    retry_sleep_s: float = 1.0,
) -> str:
    """build_fn(tmp_dir) writes the artifact; on success tmp is atomically
    renamed to dest_dir (replacing any previous version)."""
    parent = os.path.dirname(os.path.abspath(dest_dir)) or "."
    os.makedirs(parent, exist_ok=True)
    last_exc: Exception | None = None
    for attempt in range(max_retries):
        tmp = f"{dest_dir}.tmp.{os.getpid()}.{attempt}"
        try:
            os.makedirs(tmp, exist_ok=True)
            build_fn(tmp)
            old = f"{dest_dir}.old.{os.getpid()}"
            if os.path.exists(dest_dir):
                os.rename(dest_dir, old)
            os.rename(tmp, dest_dir)
            shutil.rmtree(old, ignore_errors=True)
            return dest_dir
        except Exception as e:  # transient fs errors: retry
            last_exc = e
            shutil.rmtree(tmp, ignore_errors=True)
            time.sleep(retry_sleep_s)
    raise RuntimeError(f"safe_publish failed after {max_retries} tries") from last_exc


def list_artifacts(root: str, prefix: str = "") -> list[str]:
    if not os.path.isdir(root):
        return []
    return sorted(
        d for d in os.listdir(root)
        if d.startswith(prefix) and not d.split(".")[-1].startswith("tmp")
        and os.path.isdir(os.path.join(root, d))
    )


def delete_artifacts(root: str, names: list[str]) -> None:
    for n in names:
        shutil.rmtree(os.path.join(root, n), ignore_errors=True)
