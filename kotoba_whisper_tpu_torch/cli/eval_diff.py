"""Diff eval artifacts against a reference eval_pipeline directory.

The regression leg of the parity kit: compares our
`metric.{lang}.{task}.jsonl` records and reference-schema prediction CSVs
against another run's output directory: the reference stack's committed
artifacts (run_short_form_eval.py:131-149,227-242), the JAX package's
eval run on the same checkpoint, or the repo's tiny-model goldens
(tests/goldens/eval_pipeline).

Usage:
  python -m kotoba_whisper_tpu_torch.cli.eval_diff \
      --ours eval_pipeline --reference <reference eval_pipeline dir> \
      [--language ja --task transcribe] [--tolerance 0.5] [--strict]

Exit status 1 when any matched metric deviates beyond --tolerance or any
compared prediction row differs (with --strict).
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ours", required=True)
    ap.add_argument("--reference", required=True)
    ap.add_argument("--language", default=None)
    ap.add_argument("--task", default=None)
    ap.add_argument("--tolerance", type=float, default=0.5,
                    help="max |delta| in CER/WER percentage points")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on any per-utterance prediction diff")
    arg = ap.parse_args(argv)

    from kotoba_whisper_tpu_torch.eval import parity_kit

    failures = 0
    compared = 0

    # ---- metric records ----
    langs_tasks = []
    for f in os.listdir(arg.ours):
        if f.startswith("metric.") and f.endswith(".jsonl"):
            _, lang, task, _ = f.split(".", 3)
            if arg.language and lang != arg.language:
                continue
            if arg.task and task != arg.task:
                continue
            langs_tasks.append((lang, task))
    for lang, task in sorted(set(langs_tasks)):
        name = f"metric.{lang}.{task}.jsonl"
        ours = parity_kit.load_metric_records(os.path.join(arg.ours, name))
        theirs = parity_kit.load_metric_records(
            os.path.join(arg.reference, name)
        )
        matched, unmatched = parity_kit.diff_metrics(ours, theirs)
        for d in matched:
            compared += 1
            bad = {
                m: v for m, v in d.deltas.items() if abs(v) > arg.tolerance
            }
            status = "FAIL" if bad else "ok"
            failures += bool(bad)
            print(json.dumps({
                "kind": "metric", "key": list(d.key), "status": status,
                "deltas": {m: round(v, 3) for m, v in d.deltas.items()},
            }))
        for k in unmatched:
            print(json.dumps({
                "kind": "metric", "key": list(k), "status": "no-reference",
            }))

    # ---- prediction CSVs (matched by identical filename) ----
    ref_csvs = {
        f for f in os.listdir(arg.reference) if f.endswith(".csv")
    } if os.path.isdir(arg.reference) else set()
    for f in sorted(os.listdir(arg.ours)):
        if not f.endswith(".csv") or not f.startswith("model-"):
            continue
        if f not in ref_csvs:
            continue
        d = parity_kit.diff_predictions(
            os.path.join(arg.ours, f), os.path.join(arg.reference, f)
        )
        compared += 1
        n_diff = len(d["changed"]) + len(d["missing"]) + len(d["extra"])
        status = "FAIL" if (arg.strict and n_diff) else (
            "ok" if n_diff == 0 else "drift"
        )
        failures += status == "FAIL"
        print(json.dumps({
            "kind": "predictions", "file": f, "status": status,
            "n_compared": d["n_compared"], "n_changed": len(d["changed"]),
            "missing": len(d["missing"]), "extra": len(d["extra"]),
            "sample_changed": d["changed"][:3],
        }))

    print(json.dumps({
        "kind": "summary", "compared": compared, "failures": failures,
    }))
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
