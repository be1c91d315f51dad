"""Latency benchmark harness.

Counterpart of run_speed_eval.py: deterministic dummy audio
(`generate_dummy_audio` :14-17 — uniform noise at fixed seed) for durations
{10, 30, 60, 300} s, n-trial mean/std with warmup discard (:73-79), records
appended to `eval_pipeline/runtime_pipeline.jsonl` (:82-88).

Each record names what ran: `attention` is "cuda" where the kernels ran
(a card) and "plain" where their plain twins did (the CPU), and `device`
the card as torch reports it ("cuda:0 NVIDIA H100 80GB HBM3") or "cpu".
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from kotoba_whisper_tpu_torch.train.logging import append_jsonl

DEFAULT_DURATIONS = (10, 30, 60, 300)


def generate_dummy_audio(duration_s: float, sampling_rate: int = 16000, seed: int = 42):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, int(duration_s * sampling_rate))).astype(np.float32)


def evaluate_speed(
    transcribe_fn: Callable[[np.ndarray], str],
    *,
    model_name: str,
    durations: Sequence[float] = DEFAULT_DURATIONS,
    n_trials: int = 5,
    n_warmup: int = 2,
    output_path: str = "eval_pipeline/runtime_pipeline.jsonl",
    device: str | torch.device = "cuda",
    extra: dict | None = None,
) -> list[dict]:
    """Rows carry BOTH this framework's short keys (mean/std/trials) and
    the reference's exact field names ("time (mean)"/"time (std)"/
    "time (all)" + device, run_speed_eval.py:80) so the JSONL diffs
    structurally against the reference's runtime_pipeline.jsonl.
    `transcribe_fn` returns host text, so each trial ends once the device
    has finished its work."""
    dev = torch.device(device)
    records = []
    for duration in durations:
        audio = generate_dummy_audio(duration)
        for _ in range(n_warmup):
            transcribe_fn(audio)
        times = []
        for _ in range(n_trials):
            t0 = time.perf_counter()
            transcribe_fn(audio)
            times.append(time.perf_counter() - t0)
        rec = {
            "model": model_name,
            "attention": "cuda" if dev.type == "cuda" else "plain",
            "device": _device_name(dev),
            "duration": duration,
            "mean": float(np.mean(times)),
            "std": float(np.std(times)),
            "trials": n_trials,
            "time (mean)": float(np.mean(times)),
            "time (std)": float(np.std(times)),
            "time (all)": [float(t) for t in times],
            **(extra or {}),
        }
        append_jsonl(output_path, rec)
        records.append(rec)
    return records


def _device_name(dev: torch.device) -> str:
    if dev.type != "cuda":
        return dev.type
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return f"cuda:{index} {torch.cuda.get_device_name(index)}"
