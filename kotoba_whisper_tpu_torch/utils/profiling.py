"""Profiling / tracing helpers.

The reference has wall-clock timing only (SURVEY.md §5.1); the JAX package
exposes jax.profiler traces and dispatch-aware step timing, and this is
the port's counterpart over torch.profiler: a Chrome trace of the host and
(where a card is present) the device, fenced step timing, and named spans.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block (CPU, and CUDA where a
    card is present) into log_dir/trace.<pid>.json, a Chrome trace
    (chrome://tracing, Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace.{os.getpid()}.json"))


def _devices(outputs) -> set[torch.device]:
    if isinstance(outputs, torch.Tensor):
        return {outputs.device}
    if isinstance(outputs, dict):
        outputs = list(outputs.values())
    if isinstance(outputs, (list, tuple)):
        return set().union(*(_devices(o) for o in outputs)) if outputs else set()
    return set()


class StepTimer:
    """Async-launch-aware step timing: synchronises the cards that hold
    the step's outputs before reading the clock, so times measure device
    work, not launch."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def done(self, outputs) -> float:
        for dev in _devices(outputs):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def __exit__(self, *exc):
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


def annotate(name: str):
    """Named trace span (shows up in the profiler's timeline)."""
    return torch.profiler.record_function(name)
