"""Timestamp repair post-processing (stable-ts add-on equivalent).

Counterpart of misc/whisper_add_on/stable_timestamp.py:
- `repair_timestamps`: fill missing chunk start/end times from neighbors
  and the median chunk duration (:12-53) and monotonicize.
- `adjust_by_silence`: the waveform-based adjustment the reference gets
  from stable-ts `WhisperResult.adjust_by_silence(q_levels=20, k_size=5,
  nonspeech_error=0.1)` (:60-75): detect non-speech sections from frame
  energy (max-normalized, quantized to q_levels, median-filtered with
  k_size; level-0 runs = silence) and snap chunk boundaries that fall
  inside silence to the nearest speech edge — starts forward to speech
  onset, ends backward to speech offset.

Chunks follow the pipeline schema: {"timestamp": (start, end), "text"}.
"""
from __future__ import annotations

import numpy as np


def repair_timestamps(chunks: list[dict], audio_duration_s: float | None = None) -> list[dict]:
    if not chunks:
        return chunks
    starts = [c["timestamp"][0] for c in chunks]
    ends = [c["timestamp"][1] for c in chunks]

    durations = [
        e - s for s, e in zip(starts, ends) if s is not None and e is not None
    ]
    median_dur = float(np.median(durations)) if durations else 2.0

    # forward fill starts from previous end
    for i in range(len(chunks)):
        if starts[i] is None:
            starts[i] = ends[i - 1] if i > 0 and ends[i - 1] is not None else 0.0
        if ends[i] is None:
            nxt = starts[i + 1] if i + 1 < len(chunks) else None
            if nxt is not None:
                ends[i] = nxt
            elif audio_duration_s is not None:
                ends[i] = min(starts[i] + median_dur, audio_duration_s)
            else:
                ends[i] = starts[i] + median_dur

    # monotonic, non-negative, start <= end
    prev_end = 0.0
    out = []
    for c, s, e in zip(chunks, starts, ends):
        s = max(float(s), prev_end)
        e = max(float(e), s)
        if audio_duration_s is not None:
            s, e = min(s, audio_duration_s), min(e, audio_duration_s)
        prev_end = e
        out.append({**c, "timestamp": (round(s, 2), round(e, 2))})
    return out


# ---------------------------------------------------------------------------
# Silence-based adjustment (stable_timestamp.py:60-75 semantics)
# ---------------------------------------------------------------------------

def nonspeech_sections(
    audio: np.ndarray,
    sample_rate: int = 16000,
    *,
    q_levels: int = 20,
    k_size: int = 5,
    hop: int = 160,
    min_section_s: float = 0.05,
) -> list[tuple[float, float]]:
    """Detect non-speech (silence) sections from frame energy.

    The stable-ts silence model the reference configures (q_levels=20,
    k_size=5, stable_timestamp.py:62-64): per-frame loudness is
    max-normalized, quantized into q_levels, median-filtered with kernel
    k_size; frames at quantization level 0 are silence. Returns
    [(start_s, end_s), ...] for runs longer than min_section_s.
    """
    audio = np.asarray(audio, np.float32).reshape(-1)
    if audio.size == 0:
        return []
    n_frames = max(1, audio.size // hop)
    frames = audio[: n_frames * hop].reshape(n_frames, hop)
    loudness = np.sqrt((frames.astype(np.float64) ** 2).mean(axis=1))
    peak = loudness.max()
    if peak <= 0:
        return [(0.0, audio.size / sample_rate)]
    q = np.round(loudness / peak * q_levels)
    if k_size > 1 and n_frames > k_size:
        pad = k_size // 2
        padded = np.pad(q, (pad, pad), mode="edge")
        windows = np.lib.stride_tricks.sliding_window_view(padded, k_size)
        q = np.median(windows, axis=1)
    silent = q == 0

    sections = []
    start = None
    for i, s in enumerate(silent):
        if s and start is None:
            start = i
        elif not s and start is not None:
            sections.append((start, i))
            start = None
    if start is not None:
        sections.append((start, n_frames))
    spf = hop / sample_rate
    return [
        (a * spf, b * spf)
        for a, b in sections
        if (b - a) * spf >= min_section_s
    ]


def adjust_by_silence(
    chunks: list[dict],
    audio: np.ndarray,
    sample_rate: int = 16000,
    *,
    q_levels: int = 20,
    k_size: int = 5,
    min_chunk_dur: float = 0.1,
    nonspeech_error: float = 0.1,
) -> list[dict]:
    """Snap chunk boundaries that fall inside detected silence to the
    nearest speech edge (stable_timestamp.py:60-75 behavior): a start
    inside a non-speech section moves forward to the section's end (speech
    onset); an end inside one moves backward to its start (speech offset).
    A boundary is left alone when the snap would shrink the chunk below
    min_chunk_dur, or when the silence overlap is within nonspeech_error
    of the chunk duration (too small to be a real boundary error).
    Monotonicity is restored afterwards.
    """
    if not chunks:
        return chunks
    sections = nonspeech_sections(
        audio, sample_rate, q_levels=q_levels, k_size=k_size
    )
    out = []
    for c in chunks:
        s, e = c["timestamp"]
        if s is None or e is None:
            out.append(c)
            continue
        dur = max(e - s, 1e-6)
        for a, b in sections:
            if a <= s < b:
                overlap = min(b, e) - s
                if overlap > nonspeech_error * dur:
                    s = min(b, e - min_chunk_dur)
                break
        for a, b in sections:
            if a < e <= b:
                overlap = e - max(a, s)
                if overlap > nonspeech_error * dur:
                    e = max(a, s + min_chunk_dur)
                break
        out.append({**c, "timestamp": (round(float(s), 3), round(float(e), 3))})

    # restore ordering invariants
    prev_end = 0.0
    fixed = []
    for c in out:
        s, e = c["timestamp"]
        if s is None or e is None:
            fixed.append(c)
            continue
        s = max(s, prev_end)
        e = max(e, s)
        prev_end = e
        fixed.append({**c, "timestamp": (round(s, 3), round(e, 3))})
    return fixed


_SENTENCE_END = ("。", "?", "？", "!", "！", ".")


def regroup(
    chunks: list[dict],
    *,
    gap_split: float = 0.5,
    gap_merge: float = 0.3,
    max_merge_words: int = 3,
) -> list[dict]:
    """Gap/punctuation-driven segment merge/split — the counterpart of
    stable-ts `WhisperResult.regroup(True)` (stable_timestamp.py:74),
    whose default chain is split_by_punctuation → split_by_gap(.5) →
    merge_by_gap(.3, max_words=3) → split_by_punctuation. The reference
    feeds each pipeline chunk in as one word-unit (stable_timestamp.py:55
    builds WhisperResult from per-chunk words), so units here are chunks:

    - a unit ending in sentence-final punctuation (。？！?!.) ends its
      segment;
    - a gap ≥ gap_split seconds between units starts a new segment;
    - adjacent segments with gap ≤ gap_merge merge back when the result
      stays within max_merge_words units and the left segment does not
      end a sentence (the trailing split_by_punctuation would re-split
      it).

    Output segments carry the concatenated text and the covering
    timestamp span, in the pipeline's chunk schema."""
    units = [
        c for c in chunks
        if c["timestamp"][0] is not None and c["timestamp"][1] is not None
    ]
    if not units:
        return chunks

    def sentence_end(text: str) -> bool:
        t = text.rstrip()
        return bool(t) and t.endswith(_SENTENCE_END)

    segments: list[list[dict]] = [[units[0]]]
    for prev, cur in zip(units, units[1:]):
        gap = cur["timestamp"][0] - prev["timestamp"][1]
        if sentence_end(prev["text"]) or gap >= gap_split:
            segments.append([cur])
        else:
            segments[-1].append(cur)

    merged: list[list[dict]] = [segments[0]]
    for seg in segments[1:]:
        last = merged[-1]
        gap = seg[0]["timestamp"][0] - last[-1]["timestamp"][1]
        if (
            gap <= gap_merge
            and len(last) + len(seg) <= max_merge_words
            and not sentence_end(last[-1]["text"])
        ):
            last.extend(seg)
        else:
            merged.append(seg)

    return [
        {
            "text": "".join(u["text"] for u in seg),
            "timestamp": (seg[0]["timestamp"][0], seg[-1]["timestamp"][1]),
        }
        for seg in merged
    ]


def fix_timestamps(
    chunks: list[dict],
    audio: np.ndarray | None = None,
    sample_rate: int = 16000,
    audio_duration_s: float | None = None,
    do_regroup: bool = True,
) -> list[dict]:
    """Full stable-ts add-on pipeline (stable_timestamp.py fix_timestamp):
    None-fill + monotonicity repair, then (when the waveform is available)
    the silence-based boundary adjustment, then the regroup pass
    (stable_timestamp.py:73-74 runs regroup(True) after
    adjust_by_silence)."""
    if audio is not None and audio_duration_s is None:
        audio_duration_s = len(np.asarray(audio).reshape(-1)) / sample_rate
    chunks = repair_timestamps(chunks, audio_duration_s)
    if audio is not None:
        chunks = adjust_by_silence(chunks, audio, sample_rate)
    if do_regroup:
        chunks = regroup(chunks)
    return chunks
