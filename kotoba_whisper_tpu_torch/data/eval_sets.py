"""Eval-set loaders.

Counterpart of the reference's eval-data plumbing: the ja_asr test suites
loaded by name at run_short_form_eval.py and the 8-corpus ESB builder
(misc/esb_test.py:270-1068). Without hub access, eval sets are local
directories in one of these layouts (auto-detected):

  1. tar shards + transcript.tsv  (ReazonSpeech-style; data/reazon.py)
  2. a jsonl manifest: rows {"audio": path, "text": str} with audio files
     (FLAC/WAV/MP3) relative to the manifest — the layout ESB corpora reduce
     to after their per-corpus split generators
  3. an HF `datasets` saved-to-disk dir with (audio, text)-like columns
     (column names resolved per the ESB builder's conventions)
"""
from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

from kotoba_whisper_tpu_torch.data import reazon
from kotoba_whisper_tpu_torch.eval.shortform import EvalExample
from kotoba_whisper_tpu_torch.utils import native

# per-corpus text column conventions (esb_test.py split generators)
TEXT_COLUMNS = ("text", "transcription", "sentence", "normalized_text")
AUDIO_COLUMNS = ("audio", "audio_filepath", "path")


def iter_eval_set(path: str, limit: int | None = None) -> Iterator[EvalExample]:
    manifest = os.path.join(path, "manifest.jsonl")
    if os.path.isfile(manifest):
        yield from _iter_manifest(manifest, limit)
        return
    if any(f.endswith(".tar") for f in os.listdir(path)):
        yield from _iter_tar_tsv(path, limit)
        return
    if os.path.isfile(os.path.join(path, "dataset_info.json")) or os.path.isfile(
        os.path.join(path, "state.json")
    ):
        yield from _iter_hf_disk(path, limit)
        return
    raise ValueError(f"unrecognized eval-set layout at {path}")


def _iter_tar_tsv(path, limit):
    n = 0
    for u in reazon.iter_dataset_dir(path):
        if u.transcription is None:
            continue
        audio, _ = native.decode_audio(u.audio_bytes, 16000)
        yield EvalExample(audio, u.transcription, u.name)
        n += 1
        if limit is not None and n >= limit:
            return


def _iter_manifest(manifest, limit):
    base = os.path.dirname(os.path.abspath(manifest))
    n = 0
    with open(manifest) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            audio_path = row["audio"]
            if not os.path.isabs(audio_path):
                audio_path = os.path.join(base, audio_path)
            with open(audio_path, "rb") as af:
                audio, _ = native.decode_audio(af.read(), 16000)
            yield EvalExample(audio, row["text"], row.get("id", row["audio"]))
            n += 1
            if limit is not None and n >= limit:
                return


def _iter_hf_disk(path, limit):
    import datasets

    ds = datasets.load_from_disk(path)
    if hasattr(ds, "values"):  # DatasetDict: prefer a test split
        ds = ds.get("test") or next(iter(ds.values()))
    text_col = next((c for c in TEXT_COLUMNS if c in ds.column_names), None)
    audio_col = next((c for c in AUDIO_COLUMNS if c in ds.column_names), None)
    if text_col is None or audio_col is None:
        raise ValueError(f"no (audio, text) columns in {ds.column_names}")
    n = 0
    for row in ds:
        audio = row[audio_col]
        if isinstance(audio, dict) and "array" in audio:
            arr = np.asarray(audio["array"], np.float32)
            sr = audio.get("sampling_rate", 16000)
            if sr != 16000:
                arr = native.resample(arr, sr, 16000)
        else:
            with open(audio if isinstance(audio, str) else audio["path"], "rb") as f:
                arr, _ = native.decode_audio(f.read(), 16000)
        yield EvalExample(arr, row[text_col], str(row.get("id", n)))
        n += 1
        if limit is not None and n >= limit:
            return
