"""Corpus-level WER / CER on the native edit-distance core.

Drop-in behavioral equivalents of `evaluate.load("wer"/"cer")` as invoked at
run_data_filtering.py:137,171 and run_short_form_eval.py:219-224:
corpus metric = sum(edit distances) / sum(reference lengths), words split on
whitespace for WER, unicode codepoints for CER.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from kotoba_whisper_tpu_torch.utils import native


def _word_ids(texts: Sequence[str]) -> list[np.ndarray]:
    """Map words to stable uint32 ids across the corpus (hash-free)."""
    table: dict[str, int] = {}
    out = []
    for t in texts:
        ids = []
        for w in t.split():
            if w not in table:
                table[w] = len(table)
            ids.append(table[w])
        out.append(np.asarray(ids, np.uint32))
    return out


def _char_ids(texts: Sequence[str]) -> list[np.ndarray]:
    return [
        np.asarray([ord(c) for c in t], np.uint32) for t in texts
    ]


def _corpus_metric(hyp_ids, ref_ids) -> float:
    dist, ref_len = native.levenshtein_batch(hyp_ids, ref_ids)
    total_ref = int(ref_len.sum())
    if total_ref == 0:
        return 0.0
    return float(dist.sum()) / total_ref


def wer(predictions: Sequence[str], references: Sequence[str]) -> float:
    assert len(predictions) == len(references)
    joint = _word_ids(list(predictions) + list(references))
    n = len(predictions)
    return _corpus_metric(joint[:n], joint[n:])


def cer(predictions: Sequence[str], references: Sequence[str]) -> float:
    assert len(predictions) == len(references)
    return _corpus_metric(_char_ids(predictions), _char_ids(references))
