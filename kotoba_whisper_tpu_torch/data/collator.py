"""Audio batch collation with static shapes (host-side numpy)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class CollatorConfig:
    n_samples: int = 480000  # 30 s @ 16 kHz


def collate_audio(
    audios: Sequence[np.ndarray], cfg: CollatorConfig
) -> np.ndarray:
    """Raw fp32 audio -> (B, n_samples), zero-padded/trimmed to 30 s."""
    out = np.zeros((len(audios), cfg.n_samples), np.float32)
    for i, a in enumerate(audios):
        n = min(len(a), cfg.n_samples)
        out[i, :n] = a[:n]
    return out
