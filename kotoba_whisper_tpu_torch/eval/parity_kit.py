"""Real-weights parity kit: reference-schema eval artifacts + diffing.

The reference ships its eval results as committed artifacts (its
eval_pipeline directory: 144 prediction CSVs with columns
`id,reference_norm,prediction_norm,reference_raw,prediction_raw`, named
`model-{m}.dataset-{d}.dataset_config-{c}.dataset_split-{s}.language-{l}
.task-{t}.stable-ts-{st}.punctuator-{p}.chunk_length-{cl}.csv`, plus
`metric.{lang}.{task}.jsonl` records — run_short_form_eval.py:120-149,
227-242). This module makes our eval runs diffable against those
artifacts and against committed tiny-model goldens:

  - `reference_csv_name` / `write_reference_csv`: emit the reference's
    exact per-utterance CSV schema from an eval run;
  - `load_metric_records` / `diff_metrics`: match metric JSONL records by
    (model-basename, dataset-basename, language, task) and report per-
    metric deltas;
  - `diff_predictions`: row-level prediction diff between two CSVs keyed
    on `id`.

The port's copy of the JAX package's module, driven by the port's
cli/eval_diff.py; the two packages' eval output directories diff against
each other and against the repo's committed tiny-model goldens.
"""
from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass

_METRICS = ("cer_raw", "wer_raw", "cer_norm", "wer_norm")


def _base(name: str) -> str:
    """'japanese-asr/distil-whisper-bilingual-v1.0' -> its basename; local
    checkpoint paths reduce the same way, so records from either stack
    match on the model's short name."""
    return str(name).rstrip("/").split("/")[-1]


def reference_csv_name(
    model: str,
    dataset: str,
    *,
    dataset_config: str | None = None,
    dataset_split: str = "test",
    language: str = "ja",
    task: str = "transcribe",
    stable_ts: bool | None = None,
    punctuator: bool | None = None,
    chunk_length_s: float = 15,
) -> str:
    """The reference's prediction-cache filename scheme
    (run_short_form_eval.py:120-128)."""
    parts = [f"model-{_base(model)}", f"dataset-{_base(dataset)}"]
    if dataset_config:
        parts.append(f"dataset_config-{dataset_config}")
    parts += [
        f"dataset_split-{dataset_split}",
        f"language-{language}",
        f"task-{task}",
        f"stable-ts-{stable_ts}",
        f"punctuator-{punctuator}",
        f"chunk_length-{chunk_length_s:g}",
    ]
    return ".".join(parts) + ".csv"


def write_reference_csv(path: str, rows) -> None:
    """rows: iterable of (id, ref_norm, pred_norm, ref_raw, pred_raw)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(
            ["id", "reference_norm", "prediction_norm",
             "reference_raw", "prediction_raw"]
        )
        w.writerows(rows)


def read_prediction_csv(path: str) -> dict[str, dict]:
    out: dict[str, dict] = {}
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            out[row["id"]] = row
    return out


@dataclass
class MetricDiff:
    key: tuple
    ours: dict
    theirs: dict

    @property
    def deltas(self) -> dict[str, float]:
        return {
            m: float(self.ours[m]) - float(self.theirs[m])
            for m in _METRICS
            if m in self.ours and m in self.theirs
            and self.theirs[m] is not None and self.ours[m] is not None
        }


def load_metric_records(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _record_key(r: dict) -> tuple:
    return (
        _base(r.get("model", "")),
        _base(r.get("dataset", "")),
        str(r.get("dataset_config") or ""),
        str(r.get("language", "")),
        str(r.get("task", "")),
    )


def diff_metrics(
    ours: list[dict], theirs: list[dict]
) -> tuple[list[MetricDiff], list[tuple]]:
    """Match records by (model, dataset, config, language, task) basenames;
    last record wins per key (the JSONLs are append-only). Returns
    (matched diffs, our keys with no reference counterpart)."""
    ref = {_record_key(r): r for r in theirs}
    mine = {_record_key(r): r for r in ours}
    matched = [
        MetricDiff(k, mine[k], ref[k]) for k in mine if k in ref
    ]
    unmatched = [k for k in mine if k not in ref]
    return matched, unmatched


def diff_predictions(
    our_csv: str, ref_csv: str, column: str = "prediction_norm"
) -> dict:
    """Row-level diff keyed on id: {missing, extra, changed: [(id, ours,
    theirs)]}."""
    ours = read_prediction_csv(our_csv)
    theirs = read_prediction_csv(ref_csv)
    changed = [
        (i, ours[i].get(column, ""), theirs[i].get(column, ""))
        for i in ours
        if i in theirs and ours[i].get(column, "") != theirs[i].get(column, "")
    ]
    return {
        "missing": sorted(set(theirs) - set(ours)),
        "extra": sorted(set(ours) - set(theirs)),
        "changed": changed,
        "n_compared": len(set(ours) & set(theirs)),
    }
