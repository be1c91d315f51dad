"""Scaling-efficiency report: throughput at 1 card vs N-rank data parallelism.

The BASELINE.json north star requires pseudo-labelling audio-s/s/chip
reported at 1 chip / 1 host / N hosts with >=0.9 scaling efficiency. This
harness runs the same pipeline over growing data-parallel counts and
reports efficiency = (rate_N / N) / rate_1, with the JAX package's
arithmetic: the best of `n_trials` fenced runs a count, efficiency
against the first count's rate per card.

The port runs one process a card: count n runs as n ranks through
cli/common.launch (one rank in this process without a process group,
more spawned, NCCL on cards with rank r on cuda:r, gloo on the CPU), so
`make_pipeline` and `make_batch` must pickle: module-level functions or
bound methods of a module-level class. Each rank takes its rows of the
global batch, the trials start together (parallel/multihost.barrier) and
a trial's time is the slowest rank's.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass
class ScalingPoint:
    n_devices: int
    audio_s_per_s: float
    per_chip: float
    efficiency: float


def _fence(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _trials(make_pipeline, make_batch, n_trials: int, out_path: str, arg,
            dev: torch.device) -> None:
    """One rank's body: its rows, a warm-up, the trials; rank 0 writes
    (global rows, best trial seconds) to out_path."""
    from kotoba_whisper_tpu_torch.parallel import multihost

    n, rank = multihost.process_count(), multihost.process_index()
    fn = make_pipeline(dev)
    batch = make_batch(n)
    per = len(next(iter(batch.values()))) // n
    mine = {k: torch.as_tensor(np.asarray(v)[rank * per:(rank + 1) * per]).to(dev)
            for k, v in batch.items()}
    fn(mine)  # warm-up (kernel builds, allocator)
    _fence(dev)
    times = []
    for _ in range(n_trials):
        multihost.barrier("scaling trial")
        t0 = time.perf_counter()
        fn(mine)
        _fence(dev)
        dt = np.asarray([time.perf_counter() - t0], np.float64)
        times.append(float(multihost.all_gather_host(dt).max()))
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({"rows": per * n, "seconds": min(times)}, f)


def scaling_report(
    make_pipeline: Callable[[torch.device], Callable[[dict], object]],
    make_batch: Callable[[int], dict],
    audio_seconds_per_item: float,
    device_counts: list[int] | None = None,
    n_trials: int = 3,
    *,
    device: str = "cuda",
) -> list[ScalingPoint]:
    """make_pipeline(device) -> fn(batch) (the rank's rows, tensors on its
    device); make_batch(n_ranks) -> the global batch, a dict of host
    arrays whose rows split evenly over the ranks. `device_counts`
    defaults to those of (1, 2, 4, 8) that this host's cards (on the CPU
    its cores) can hold."""
    from kotoba_whisper_tpu_torch.cli.common import launch
    from kotoba_whisper_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    have = torch.cuda.device_count() if dev.type == "cuda" else (os.cpu_count() or 1)
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8) if n <= have]
    arg = argparse.Namespace(device=dev.type, num_processes=None, coordinator_address=None,
                             process_id=None)

    points: list[ScalingPoint] = []
    base_rate = None
    with tempfile.TemporaryDirectory() as tmp:
        for n in device_counts:
            out_path = os.path.join(tmp, f"count{n}.json")
            launch(functools.partial(_trials, make_pipeline, make_batch, n_trials, out_path),
                   arg, local=n)
            with open(out_path) as f:
                got = json.load(f)
            rate = got["rows"] * audio_seconds_per_item / got["seconds"]
            per_chip = rate / n
            if base_rate is None:
                base_rate = per_chip
            points.append(ScalingPoint(n, rate, per_chip, per_chip / base_rate))
    return points
