"""Metric reporting: markdown pivot tables over the metric JSONL records.

Counterpart of run_short_form_eval.py's `--pretty-table` mode (:56-103):
pivot model x dataset for a chosen metric, rendered as GitHub markdown.
`--runtime` pivots model x duration over runtime_pipeline.jsonl rows
(run_speed_eval.py:34-50's pretty-table).
"""
from __future__ import annotations

import json
import os
from collections import defaultdict


def load_metrics(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def pivot_table(
    records: list[dict], metric: str = "cer_norm", digits: int = 1
) -> str:
    """model x dataset markdown pivot; last record wins per cell."""
    cells: dict[str, dict[str, float]] = defaultdict(dict)
    datasets: list[str] = []
    for r in records:
        if metric not in r:
            continue
        ds = str(r.get("dataset", "?"))
        cells[str(r.get("model", "?"))][ds] = r[metric]
        if ds not in datasets:
            datasets.append(ds)
    if not cells:
        return "(no records)"

    header = "| model | " + " | ".join(datasets) + " |"
    sep = "|" + "---|" * (len(datasets) + 1)
    lines = [header, sep]
    for model in sorted(cells):
        row = [model]
        for ds in datasets:
            v = cells[model].get(ds)
            row.append(f"{v:.{digits}f}" if v is not None else "-")
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


def _runtime_row_key(r: dict) -> str:
    """Row label for the runtime pivot: model plus any non-default
    config axes. Runtime tables hold bf16 and int8-serving rows under
    identical model names — keying by model alone silently overwrites
    the bf16 cells with serving latencies (the reference filters its
    pretty-table by attention impl instead, run_speed_eval.py:34-50).
    The wire is an axis too: an int16-wire row is tagged `wire=int16`,
    where the JAX package's key leaves it out and lets it collide with
    the fp32-wire row of the same model and dtypes."""
    tags = [
        f"{short}={r[k]}"
        for k, short in (("gemm_dtype", "gemm"), ("kv_dtype", "kv"), ("wire_dtype", "wire"))
        if r.get(k) not in (None, "", "compute", "float32")
    ]
    model = str(r.get("model", "?"))
    return f"{model} [{', '.join(tags)}]" if tags else model


def runtime_pivot_table(records: list[dict], digits: int = 3) -> str:
    """model+config x duration pivot over runtime rows ("time (mean)"
    seconds), the reference's speed pretty-table
    (run_speed_eval.py:34-50)."""
    import sys

    cells: dict[str, dict[float, float]] = defaultdict(dict)
    durations: list[float] = []
    for r in records:
        v = r.get("time (mean)", r.get("mean"))
        if v is None or "duration" not in r:
            continue
        d = float(r["duration"])
        key = _runtime_row_key(r)
        if d in cells[key]:
            print(
                f"runtime_pivot_table: duplicate cell ({key!r}, {d:g}s); "
                "last record wins", file=sys.stderr,
            )
        cells[key][d] = v
        if d not in durations:
            durations.append(d)
    if not cells:
        return "(no records)"
    durations.sort()
    header = "| model | " + " | ".join(f"{d:g} s" for d in durations) + " |"
    sep = "|" + "---|" * (len(durations) + 1)
    lines = [header, sep]
    for model in sorted(cells):
        row = [model] + [
            f"{cells[model][d]:.{digits}f}" if d in cells[model] else "-"
            for d in durations
        ]
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--metric_jsonl", required=True)
    ap.add_argument("--metric", default="cer_norm")
    ap.add_argument("--runtime", action="store_true",
                    help="pivot runtime_pipeline.jsonl rows instead "
                    "(model x duration, mean seconds)")
    arg = ap.parse_args(argv)
    records = load_metrics(arg.metric_jsonl)
    if arg.runtime:
        print(runtime_pivot_table(records))
    else:
        print(pivot_table(records, arg.metric))


if __name__ == "__main__":
    main()
