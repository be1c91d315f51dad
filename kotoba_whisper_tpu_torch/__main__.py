"""Unified CLI: `python -m kotoba_whisper_tpu_torch <stage> [args...]`.

The stages, each one driver module's main(): pseudo-label (stage 2) ->
filter (stage 3) -> merge -> create-student (stage 4) -> distill or
distill-bilingual (stage 5), then stage 6: prepare-eval-set, eval, speed
and report; and parity-check against the HF stack (CPU oracle, needs
`transformers`). The same stages as the JAX package's CLI.
"""
from __future__ import annotations

import importlib
import sys

STAGES = {
    "pseudo-label": ("kotoba_whisper_tpu_torch.cli.pseudo_label", "teacher pseudo-labelling"),
    "filter": ("kotoba_whisper_tpu_torch.cli.data_filter", "WER filtering + vectorize"),
    "merge": ("kotoba_whisper_tpu_torch.cli.merge_splits",
              "merge chunk outputs into split_N training groups"),
    "create-student": ("kotoba_whisper_tpu_torch.cli.create_student", "student init"),
    "distill": ("kotoba_whisper_tpu_torch.cli.distill", "distillation training"),
    "distill-bilingual": ("kotoba_whisper_tpu_torch.cli.distill_bilingual",
                          "v3 bilingual multi-task distillation"),
    "eval": ("kotoba_whisper_tpu_torch.cli.eval_short_form", "short-form CER/WER eval"),
    "speed": ("kotoba_whisper_tpu_torch.cli.eval_speed", "latency benchmark"),
    "report": ("kotoba_whisper_tpu_torch.eval.report", "markdown metric pivot"),
    "prepare-eval-set": (
        "kotoba_whisper_tpu_torch.cli.prepare_eval_set",
        "materialize an eval dataset into the tar+tsv layout",
    ),
    "parity-check": (
        "kotoba_whisper_tpu_torch.cli.parity_check",
        "token/logit parity vs the reference stack on real weights",
    ),
}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m kotoba_whisper_tpu_torch <stage> [args...]\n\nstages:")
        for name, (_, desc) in STAGES.items():
            print(f"  {name:18s} {desc}")
        raise SystemExit(0 if argv else 2)
    stage = argv[0]
    if stage not in STAGES:
        raise SystemExit(f"unknown stage {stage!r}; try --help")
    importlib.import_module(STAGES[stage][0]).main(argv[1:])


if __name__ == "__main__":
    main()
