"""ReazonSpeech shard reader: local tar archives + TSV transcript join.

Native-pipeline replacement for reazonspeech_manual_dataloader.py:42-97 (an
HF GeneratorBasedBuilder): iterates FLAC/WAV/MP3 members out of tar shards,
joins transcriptions from the TSV, and yields
{"name", "audio_bytes", "transcription"} — audio stays as raw bytes so
decode (native/audio.cpp) can run in pipeline workers, not at read time.
"""
from __future__ import annotations

import csv
import io
import os
import struct
import tarfile
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class Utterance:
    name: str
    audio_bytes: bytes
    transcription: str | None


def read_tsv_transcripts(tsv_path: str) -> dict[str, str]:
    """TSV rows of (member_name, transcription)."""
    table: dict[str, str] = {}
    with open(tsv_path, encoding="utf-8", newline="") as f:
        for row in csv.reader(f, delimiter="\t"):
            if len(row) >= 2:
                table[row[0]] = row[1]
    return table


def iter_tar_utterances(
    tar_path: str, transcripts: dict[str, str] | None = None
) -> Iterator[Utterance]:
    with tarfile.open(tar_path, "r") as tf:
        for member in tf:
            if not member.isfile():
                continue
            ext = os.path.splitext(member.name)[1].lower()
            if ext not in (".flac", ".wav"):
                continue
            payload = tf.extractfile(member)
            if payload is None:
                continue
            text = None
            if transcripts is not None:
                text = transcripts.get(member.name) or transcripts.get(
                    os.path.basename(member.name)
                )
            yield Utterance(member.name, payload.read(), text)


def check_tar_integrity(tar_path: str) -> bool:
    """True when every member extracts cleanly (downloader health check)."""
    try:
        with tarfile.open(tar_path, "r") as tf:
            for member in tf:
                if member.isfile():
                    f = tf.extractfile(member)
                    if f is None:
                        return False
                    f.read()
        return True
    except (tarfile.TarError, OSError, EOFError):
        return False


def iter_dataset_dir(
    dataset_dir: str,
    tsv_name: str = "transcript.tsv",
    chunk_range: tuple[int, int] | None = None,
    shard_slice: tuple[int, int] | None = None,
) -> Iterator[Utterance]:
    """Stream utterances from a directory of numbered tar shards; the TSV is
    shared (ReazonSpeech v2 layout). chunk_range selects [lo, hi) shard
    indices (the idempotent-chunk recipe). shard_slice=(index, count)
    keeps tars[index::count] of those: a host's slice in a multi-host
    run, each host reading only its own files."""
    tsv_path = os.path.join(dataset_dir, tsv_name)
    transcripts = read_tsv_transcripts(tsv_path) if os.path.exists(tsv_path) else None
    tars = sorted(
        f for f in os.listdir(dataset_dir) if f.endswith(".tar")
    )
    if chunk_range is not None:
        tars = tars[chunk_range[0] : chunk_range[1]]
    if shard_slice is not None:
        tars = tars[shard_slice[0] :: shard_slice[1]]
    for t in tars:
        yield from iter_tar_utterances(os.path.join(dataset_dir, t), transcripts)


def write_tar_shard(
    out_path: str, utterances: list[tuple[str, bytes]]
) -> None:
    """Helper for tests/tools: pack (name, audio_bytes) into a tar shard."""
    with tarfile.open(out_path, "w") as tf:
        for name, payload in utterances:
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))


def wav_bytes(audio: np.ndarray, sr: int = 16000) -> bytes:
    """A 16-bit mono PCM WAV of `audio` (floats in [-1, 1]), as a tar member."""
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    return struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm), b"WAVE", b"fmt ", 16, 1, 1,
        sr, sr * 2, 2, 16, b"data", len(pcm),
    ) + pcm
