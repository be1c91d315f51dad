"""Throughput gauge: audio-seconds per second per card."""
from __future__ import annotations

import time


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
