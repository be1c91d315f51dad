"""Metric logging (a JSONL sink of record, mirrored to wandb when a
project is given) and the throughput gauge, audio-seconds per second per
card. Metric names carry a `train/` prefix, as the JAX package's logger
writes them."""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Mapping


class MetricLogger:
    """Appends one JSON record per `log` call to
    <output_dir>/metrics.<run_name>.jsonl (output_dir None: a no-op sink,
    for the ranks that do not log).

    With `wandb_project`, and WANDB_DISABLED not "1" or "true", wandb is
    imported here and `wandb.init(project=, name=run_name)` started; every
    record then goes to its `log(record, step=step)` too, and `close()`
    finishes the run. If the import or the init fails, the JSONL file stays
    the only sink and one line on stderr says so (the JAX package's logger
    falls back silently)."""

    def __init__(self, output_dir: str | None, run_name: str = "run",
                 wandb_project: str | None = None):
        self.path = None
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            self.path = os.path.join(output_dir, f"metrics.{run_name}.jsonl")
        self._wandb = None
        if wandb_project and os.environ.get("WANDB_DISABLED", "").lower() not in ("1", "true"):
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project, name=run_name)
            except Exception as e:  # noqa: BLE001 - any tracker failure leaves the JSONL sink
                print(f"MetricLogger: the wandb tracker did not start ({type(e).__name__}: "
                      f"{e}); metrics go to the JSONL file only", file=sys.stderr)

    def log(self, metrics: Mapping[str, Any], step: int, prefix: str = "train") -> None:
        if self.path is None:
            return
        record = {f"{prefix}/{k}": _to_py(v) for k, v in metrics.items()}
        record["step"] = step
        record["time"] = time.time()
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(record, step=step)

    def close(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


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
