"""NeMo ReazonSpeech baseline adapter (optional import).

Counterpart of the reference's model-zoo branch for
`reazon-research/reazonspeech-nemo-v2` (run_short_form_eval.py:171-182):
the short-form evaluator's baseline table includes the ReazonSpeech NeMo
Conformer model, driven through a 10-line adapter — import
`reazonspeech.nemo.asr`, `load_model()`, and call
`transcribe(model, AudioData(waveform, samplerate))` per utterance.

The package (and its NeMo/torch-GPU stack) is an optional dependency that
is not on any training or serving path, exactly like the reference's
optional-import; the adapter is stub-tested (tests/test_report_addons.py)
so the call shape is pinned without the dependency installed.

A copy of the JAX package's eval/nemo_baseline.py, which imports no JAX;
both packages' eval drivers route the same names here.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

# model names that route to this adapter (run_short_form_eval.py:171)
NEMO_MODELS = ("reazon-research/reazonspeech-nemo-v2", "nemo-v2")


def is_nemo_model(name: str) -> bool:
    return name in NEMO_MODELS


def make_nemo_transcribe_fn(
    *, language: str = "ja", task: str = "transcribe",
    sampling_rate: int = 16000,
) -> Callable[[np.ndarray], str]:
    """Build the per-utterance transcribe callable.

    Reproduces the reference's guards exactly (run_short_form_eval.py:172:
    `assert task == "transcribe" and language == "ja"`) — the NeMo
    baseline is ja-transcribe only.
    """
    if task != "transcribe" or language != "ja":
        raise ValueError(
            "the reazonspeech-nemo-v2 baseline supports only "
            f"task=transcribe language=ja (got task={task!r}, "
            f"language={language!r})"
        )
    try:
        from reazonspeech.nemo.asr import interface, load_model, transcribe
    except ImportError as e:
        raise ImportError(
            "the NeMo baseline needs the optional `reazonspeech` package "
            "(pip install reazonspeech[nemo]); it is a baseline model for "
            "the eval table, not part of this framework's pipelines"
        ) from e

    model = load_model()

    def fn(audio: np.ndarray) -> str:
        # run_short_form_eval.py:176-180 call shape
        out = transcribe(
            model,
            interface.AudioData(waveform=audio, samplerate=sampling_rate),
        )
        return out.text

    return fn
