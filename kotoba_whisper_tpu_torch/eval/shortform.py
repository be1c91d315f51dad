"""Short-form CER/WER evaluation harness.

Counterpart of run_short_form_eval.py (call stack SURVEY.md §3.4): runs the
chunked ASR pipeline (decode/longform.py, chunk_length_s=15) over an eval
set, normalizes per language (eval/normalizers.py), computes cer/wer ×
raw/norm, appends to `eval_pipeline/metric.{lang}.{task}.jsonl` and caches
per-utterance predictions to a CSV keyed by (model, dataset) for resumable
evaluation (:131-149, 227-242).
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from kotoba_whisper_tpu_torch.eval import metrics
from kotoba_whisper_tpu_torch.eval.normalizers import make_normalizer
from kotoba_whisper_tpu_torch.train.logging import append_jsonl


@dataclass
class EvalExample:
    audio: np.ndarray  # fp32 16 kHz
    text: str
    audio_id: str


def _safe_name(s: str) -> str:
    return s.replace("/", "_").replace(" ", "_")


def evaluate_short_form(
    examples: Sequence[EvalExample],
    transcribe_fn: Callable[[np.ndarray], str],
    *,
    model_name: str,
    dataset_name: str,
    language: str = "ja",
    task: str = "transcribe",
    output_dir: str = "eval_pipeline",
    punctuator: bool = False,
    stable_ts: bool = False,
    dataset_config: str | None = None,
    dataset_split: str = "test",
    chunk_length_s: float = 15,
) -> dict:
    os.makedirs(output_dir, exist_ok=True)
    cache_path = os.path.join(
        output_dir,
        f"prediction.{_safe_name(model_name)}.{_safe_name(dataset_name)}."
        f"{language}.{task}.csv",
    )

    # resumable prediction cache
    cached: dict[str, str] = {}
    if os.path.exists(cache_path):
        with open(cache_path, newline="", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                cached[row["audio_id"]] = row["prediction"]

    predictions = []
    new_rows = []
    for ex in examples:
        if ex.audio_id in cached:
            predictions.append(cached[ex.audio_id])
        else:
            pred = transcribe_fn(ex.audio)
            predictions.append(pred)
            new_rows.append((ex.audio_id, pred))

    if new_rows:
        exists = os.path.exists(cache_path)
        with open(cache_path, "a", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            if not exists:
                w.writerow(["audio_id", "prediction"])
            w.writerows(new_rows)

    norm = make_normalizer(language)
    refs_raw = [ex.text for ex in examples]
    refs_norm = [norm(r) for r in refs_raw]
    preds_norm = [norm(p) for p in predictions]

    # drop rows whose normalized reference is empty (:210-215)
    keep = [i for i, r in enumerate(refs_norm) if len(r) != 0]
    refs_raw = [refs_raw[i] for i in keep]
    refs_norm = [refs_norm[i] for i in keep]
    preds_raw = [predictions[i] for i in keep]
    preds_norm = [preds_norm[i] for i in keep]

    record = {
        "model": model_name,
        "dataset": dataset_name,
        "dataset_config": dataset_config,
        "dataset_split": dataset_split,
        "chunk_length_s": chunk_length_s,
        "language": language,
        "task": task,
        "punctuator": punctuator,
        "stable_ts": stable_ts,
        "cer_raw": 100 * metrics.cer(preds_raw, refs_raw),
        "wer_raw": 100 * metrics.wer(preds_raw, refs_raw),
        "cer_norm": 100 * metrics.cer(preds_norm, refs_norm),
        "wer_norm": 100 * metrics.wer(preds_norm, refs_norm),
    }
    append_jsonl(
        os.path.join(output_dir, f"metric.{language}.{task}.jsonl"), record
    )

    # reference-schema per-utterance CSV (run_short_form_eval.py:120-128):
    # the artifact cli/eval_diff.py diffs against a reference run's
    # eval_pipeline directory and against the committed tiny-model goldens
    from kotoba_whisper_tpu_torch.eval import parity_kit

    ids = [examples[i].audio_id for i in keep]
    parity_kit.write_reference_csv(
        os.path.join(
            output_dir,
            parity_kit.reference_csv_name(
                model_name, dataset_name, dataset_config=dataset_config,
                dataset_split=dataset_split, language=language, task=task,
                stable_ts=stable_ts or None, punctuator=punctuator or None,
                chunk_length_s=chunk_length_s,
            ),
        ),
        zip(ids, refs_norm, preds_norm, refs_raw, preds_raw),
    )
    return record
