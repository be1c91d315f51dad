"""Long-form transcription: time-domain chunking with overlap merge.

Reproduces the HF ASR pipeline behavior the reference evaluates through
(`pipeline(..., chunk_length_s=15)`, run_short_form_eval.py:110-117,184;
SURVEY.md §5.7): 15 s windows with stride 1/6 (2.5 s) on each side (0 at
the boundaries), batched chunk decode, then either

  - timestamp merge (return_timestamps=True): per-chunk segments are
    clipped to the chunk's non-stride core, offset by the chunk start
    time, and concatenated — matching WhisperTokenizer._decode_asr's
    stride handling; or
  - longest-common-sequence token merge: greedy overlap matching scored
    by matches/overlap + epsilon·length (the pipeline's
    `_find_longest_common_sequence` scoring, reproduced exactly).

Output schema mirrors the pipeline: {"text", "chunks": [{"timestamp":
(start, end), "text"}]}.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from kotoba_whisper_tpu_torch.tokenizer.whisper_tokenizer import (
    WhisperTokenizer,
    segments_from_tokens,
)


@dataclass(frozen=True)
class ChunkingConfig:
    chunk_length_s: float = 15.0
    stride_ratio: float = 1.0 / 6.0
    sampling_rate: int = 16000

    @property
    def chunk_len(self) -> int:
        return int(round(self.chunk_length_s * self.sampling_rate))

    @property
    def stride(self) -> int:
        return int(round(self.chunk_length_s * self.stride_ratio * self.sampling_rate))


@dataclass
class Chunk:
    audio: np.ndarray
    start_sample: int
    stride_left: int
    stride_right: int
    is_last: bool


def chunk_audio(audio: np.ndarray, cfg: ChunkingConfig) -> list[Chunk]:
    """chunk_iter semantics: step = chunk - left - right; first chunk has no
    left stride, last none right; drop a trailing chunk not longer than its
    left stride."""
    n = len(audio)
    chunk_len = cfg.chunk_len
    stride = cfg.stride
    step = chunk_len - 2 * stride
    chunks: list[Chunk] = []
    for start in range(0, n, step):
        end = min(start + chunk_len, n)
        piece = audio[start:end]
        left = 0 if start == 0 else stride
        is_last = start + chunk_len >= n
        right = 0 if is_last else stride
        if len(piece) > left:
            chunks.append(Chunk(piece, start, left, right, is_last))
        if is_last:
            break
    return chunks


def find_longest_common_sequence(
    sequences: Sequence[Sequence[int]],
) -> list[int]:
    """Greedy overlap merge with matches/overlap + len/10000 scoring and the
    `matches > 1` acceptance bar (pipeline `_find_longest_common_sequence`).
    Inputs must already be stripped of special tokens."""
    sequence = list(sequences[0])
    for new_seq in sequences[1:]:
        new_sequence = list(new_seq)
        index = 0
        max_score = 0.0
        for i in range(1, len(new_sequence) + 1):
            eps = i / 10000.0
            matches = int(
                np.sum(
                    np.asarray(sequence[-i:]) == np.asarray(new_sequence[:i])
                )
            )
            score = matches / i + eps
            if matches > 1 and score > max_score:
                index = i
                max_score = score
        sequence.extend(new_sequence[index:])
    return sequence


def merge_chunk_segments(
    tok: WhisperTokenizer,
    chunk_tokens: Sequence[Sequence[int]],
    chunks: Sequence[Chunk],
    cfg: ChunkingConfig,
) -> list[dict]:
    """Timestamp-aware merge: keep segments whose midpoint lies in the
    chunk's non-stride core, shifted to absolute time."""
    sr = cfg.sampling_rate
    out: list[dict] = []
    for toks, ch in zip(chunk_tokens, chunks):
        offset = ch.start_sample / sr
        lo = ch.stride_left / sr
        hi = len(ch.audio) / sr - ch.stride_right / sr
        for seg in segments_from_tokens(tok, toks):
            start = seg["start"]
            end = seg["end"] if seg["end"] is not None else len(ch.audio) / sr
            mid = (start + end) / 2
            if lo <= mid < hi or (ch.is_last and mid >= lo):
                out.append(
                    {
                        "timestamp": (round(offset + start, 2), round(offset + end, 2)),
                        "text": seg["text"],
                    }
                )
    return out


def transcribe_long_form(
    audio: np.ndarray,
    tok: WhisperTokenizer,
    generate_fn: Callable[[np.ndarray], np.ndarray],
    cfg: ChunkingConfig = ChunkingConfig(),
    return_timestamps: bool = True,
) -> dict:
    """audio (T,) fp32 16 kHz -> {"text", "chunks"}.

    generate_fn: batched decode taking (N, chunk_samples) padded audio and
    returning (N, L) token ids (prompt + generated + eot + pads).
    """
    chunks = chunk_audio(np.asarray(audio, np.float32), cfg)
    if not chunks:
        return {"text": "", "chunks": []}
    batch = np.zeros((len(chunks), cfg.chunk_len), np.float32)
    for i, ch in enumerate(chunks):
        batch[i, : len(ch.audio)] = ch.audio
    tokens = np.asarray(generate_fn(batch))

    if return_timestamps:
        segs = merge_chunk_segments(tok, tokens, chunks, cfg)
        return {"text": "".join(s["text"] for s in segs), "chunks": segs}

    stripped = [
        [t for t in row.tolist() if t < tok.special.eot]
        for row in tokens
    ]
    merged = find_longest_common_sequence(stripped)
    return {"text": tok.decode(merged), "chunks": []}
