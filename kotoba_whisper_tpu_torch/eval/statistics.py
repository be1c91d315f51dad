"""Dataset / model statistics tools.

Counterparts of misc/get_data_statistics.py (:15-97 — per-dataset utterance
count, duration sum/mean, amplitude stats, token-length stats) and
misc/get_model_statistics.py (parameter counts; the table at
misc/model_statistics.csv — e.g. large-v3 = 1,543,490,560 params, which
models/whisper.py reproduces exactly).

`data_statistics` is a copy of the JAX package's. `model_statistics` takes
an nn.Module or a state dict and returns the JAX package's keys; its
`n_tensors` counts the port's per-layer tensors, where the JAX package
counts its layer-stacked leaves.
"""
from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch


def data_statistics(
    utterances: Iterable[tuple[np.ndarray, list[int] | None]],
    sampling_rate: int = 16000,
) -> dict[str, Any]:
    """(audio, label_ids) pairs -> the reference's statistics schema."""
    durations = []
    amplitudes = []
    token_lens = []
    for audio, labels in utterances:
        durations.append(len(audio) / sampling_rate)
        if len(audio):
            amplitudes.append(float(np.abs(audio).max()))
        if labels is not None:
            token_lens.append(len(labels))
    out: dict[str, Any] = {
        "num_utterances": len(durations),
        "duration_s_total": float(np.sum(durations)),
        "duration_s_mean": float(np.mean(durations)) if durations else 0.0,
        "duration_s_std": float(np.std(durations)) if durations else 0.0,
        "amplitude_max_mean": float(np.mean(amplitudes)) if amplitudes else 0.0,
    }
    if token_lens:
        out.update(
            token_length_mean=float(np.mean(token_lens)),
            token_length_max=int(np.max(token_lens)),
        )
    return out


def model_statistics(
    model: torch.nn.Module | Mapping[str, Any], name: str = "model"
) -> dict[str, Any]:
    """Parameter counts of a module (its parameters; a meta-device module
    counts without memory) or of a state dict (every entry)."""
    if isinstance(model, torch.nn.Module):
        shapes = [tuple(p.shape) for p in model.parameters()]
    else:
        shapes = [tuple(np.shape(t)) for t in model.values()]
    n = sum(int(np.prod(s)) for s in shapes)
    return {
        "model": name,
        "n_parameters": n,
        "n_tensors": len(shapes),
        "bytes_fp32": 4 * n,
    }
