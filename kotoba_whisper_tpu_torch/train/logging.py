"""Metric logging (a JSONL sink of record) and the throughput gauge,
audio-seconds per second per card. Metric names carry a `train/` prefix,
as the JAX package's logger writes them."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping


class MetricLogger:
    """Appends one JSON record per `log` call to
    <output_dir>/metrics.<run_name>.jsonl. wandb is not ported."""

    def __init__(self, output_dir: str | None, run_name: str = "run",
                 wandb_project: str | None = None):
        if wandb_project:
            raise NotImplementedError("MetricLogger: wandb is not ported yet")
        self.path = None
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            self.path = os.path.join(output_dir, f"metrics.{run_name}.jsonl")

    def log(self, metrics: Mapping[str, Any], step: int, prefix: str = "train") -> None:
        if self.path is None:
            return
        record = {f"{prefix}/{k}": _to_py(v) for k, v in metrics.items()}
        record["step"] = step
        record["time"] = time.time()
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


def _to_py(v: Any):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def append_jsonl(path: str, record: Mapping[str, Any]) -> None:
    """Append one record to a JSONL file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record, ensure_ascii=False) + "\n")


class Throughput:
    """audio-seconds/s/card. `n_cards` counts the cards THIS process
    drives (the local card), never a global device count."""

    def __init__(self, n_cards: int = 1):
        self.n_cards = n_cards
        self._t0: float | None = None
        self._audio_s = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._audio_s = 0.0

    def add(self, audio_seconds: float) -> None:
        self._audio_s += audio_seconds

    def rate(self) -> float:
        if self._t0 is None:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._audio_s / dt / self.n_cards if dt > 0 else 0.0
