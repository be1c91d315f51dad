"""Stage-3 dataset hygiene: WER-threshold filtering and label preparation.

Reproduces run_data_filtering.py semantics with native components:

  - per-utterance WER between normalized ground truth and decoded
    pseudo-label; drop when >= threshold or unscorable
    (`is_wer_in_range` :157-177) — edit distance via native/editdist.cpp,
  - timestamp keep-probability sampling: with prob (1-p) strip timestamp
    tokens and insert <|notimestamps|> at the prefix position
    (:244-251; the reference's `timestamp_begin = all_special_ids[-1]` IS
    the <|notimestamps|> id, so "< timestamp_begin" drops both timestamps
    and a stray notimestamps),
  - previous-context prompting with probability p: prepend
    <|startofprev|> + penultimate utterance's stripped tokens when the
    total stays under max_label_length (:271-281),
  - audio-length filter min < samples < max and label-length filter
    0 < len <= max_label_length (:302-324).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from kotoba_whisper_tpu_torch.eval.metrics import wer as compute_wer
from kotoba_whisper_tpu_torch.tokenizer.whisper_tokenizer import WhisperTokenizer


@dataclass
class FilterConfig:
    wer_threshold: float = 10.0
    timestamp_probability: float = 0.2
    condition_on_prev_probability: float = 0.2
    max_label_length: int = 128
    min_duration_s: float = 0.0
    max_duration_s: float = 30.0
    sampling_rate: int = 16000
    timestamp_position: int = 3  # 1 for non-multilingual checkpoints
    seed: int = 0


def is_wer_in_range(
    ground_truth: str,
    whisper_transcript: Sequence[int] | str | None,
    tokenizer: WhisperTokenizer,
    normalizer: Callable[[str], str],
    threshold: float,
) -> bool:
    """Keep when WER(norm_gt, norm_pred)*100 < threshold; drop when the
    ground truth normalizes to empty or the transcript is missing."""
    try:
        norm_gt = normalizer(ground_truth)
        if whisper_transcript is None or len(norm_gt) == 0:
            return False
        if not isinstance(whisper_transcript, str):
            whisper_transcript = tokenizer.decode(
                whisper_transcript, skip_special_tokens=True
            )
        norm_pred = normalizer(whisper_transcript)
        return 100.0 * compute_wer([norm_pred], [norm_gt]) < threshold
    except Exception:
        return False


class LabelPreparer:
    """Sequential label preparation with prompt conditioning state.

    Call prepare(token_ids) per utterance in dataset order; it keeps the
    previous utterance's unprompted ids for <|startofprev|> conditioning,
    mirroring the reference's batch-local penultimate lookup."""

    def __init__(self, tokenizer: WhisperTokenizer, cfg: FilterConfig):
        self.tok = tokenizer
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self._prev_unprompted: list[int] | None = None

    def prepare(self, token_ids: Sequence[int]) -> list[int]:
        st = self.tok.special
        cfg = self.cfg
        ids = [int(t) for t in token_ids if int(t) != st.eot]
        ids.append(st.eot)

        has_ts = any(i >= st.timestamp_begin for i in ids)
        if has_ts:
            keep_ts = bool(self.rng.binomial(1, cfg.timestamp_probability))
            if not keep_ts:
                ids = [i for i in ids if i < st.no_timestamps]
                ids.insert(cfg.timestamp_position, st.no_timestamps)

        unprompted = ids
        out = ids
        if (
            bool(self.rng.binomial(1, cfg.condition_on_prev_probability))
            and self._prev_unprompted is not None
        ):
            prompt = [i for i in self._prev_unprompted if i < st.no_timestamps]
            if prompt:
                prompt = [st.startofprev] + prompt[cfg.timestamp_position : -1]
            if len(prompt) + len(ids) < cfg.max_label_length:
                out = prompt + ids
        self._prev_unprompted = unprompted
        return out

    def audio_in_range(self, n_samples: int) -> bool:
        cfg = self.cfg
        return (
            cfg.min_duration_s * cfg.sampling_rate
            < n_samples
            < cfg.max_duration_s * cfg.sampling_rate
        )

    def labels_in_range(self, labels: Sequence[int]) -> bool:
        return 0 < len(labels) <= self.cfg.max_label_length
