"""ESB English eval-corpus preparers (8 corpora -> manifest.jsonl).

Counterpart of the reference's `misc/esb_test.py` GeneratorBasedBuilder
(:331-1068): for each of the eight ESB corpora — ami, spgispeech,
voxpopuli, tedlium, gigaspeech, librispeech, common_voice, earnings22 —
convert the corpus's RAW distribution layout (the same files the
reference's `dl_manager` downloads, extracted locally) into the
framework's manifest layout (`manifest.jsonl` rows {"id","audio","text"}
that data/eval_sets.py consumes), applying the reference's per-corpus
transcript cleanup EXACTLY (:1069-1105 helpers + the per-corpus "Error
correction" blocks and the cleanup constant tables at :1407-1420).

One deliberate deviation: the reference blanks the `text` column on test
splits (ESB hides test labels behind a leaderboard); a local eval harness
needs references, so text is kept for every split.

TEDLIUM is the only corpus whose raw audio is not directly playable
per-utterance: talks are NIST SPHERE files segmented by .stm rows, so the
preparer parses SPHERE headers (pure-Python; 16 kHz 16-bit PCM) and writes
one WAV per kept segment (the reference slices in-memory via soundfile,
esb_test.py:1081-1088).

A copy of the JAX package's data/esb.py, which imports no JAX; its
manifests, WAVs and tars are byte-identical to the JAX package's
(tests/test_torch_esb.py).
"""
from __future__ import annotations

import csv
import io
import json
import os
import re
import struct
from typing import Callable, Iterator

# --- the reference's cleanup constant tables (esb_test.py:1407-1420).
# Behavioral constants required for transcript parity, mirrored verbatim.
TEDLIUM_CONTRACTIONS = [
    " 's", " 't", " 're", " 've", " 'm", " 'll", " 'd", " 'clock", " 'all"
]
GIGASPEECH_PUNCTUATION = {
    " <comma>": ",", " <period>": ".",
    " <questionmark>": "?", " <exclamationpoint>": "!",
}
GIGASPEECH_JUNK_TOKENS = ["<other>", "<sil>"]
SWB_JUNK_TOKENS = [
    "[noise]", "[laughter]", "[silence]", "[vocalized-noise]", "<a_aside>",
    "<b_aside>", "<e_aside>", "[laughter-", "_1", "[laugh]", "[sigh]",
    "[cough]", "[mn]", "[breath]", "[lipsmack]", "[sneeze]", "[skip]",
    "[pause]", "(%hesitation)", "(%HESITATION)",
]
EARNINGS_JUNK_TOKENS = [
    "<noise>", "<crosstalk>", "<affirmative>", "<inaudible>", "inaudible",
    "<laugh>", "<silence>",
]
IGNORE_SEGMENTS = (
    ["ignore_time_segment_in_scoring", "<noise>", "<music>", "[noise]",
     "[laughter]", "[silence]", "[vocalized-noise]", "<crosstalk>",
     "<affirmative>", "<inaudible>", "<laugh>", ""]
    + GIGASPEECH_JUNK_TOKENS + SWB_JUNK_TOKENS + EARNINGS_JUNK_TOKENS
)


def _squash_spaces(text: str) -> str:
    return re.sub(r"\s\s+", " ", text).strip()


def maybe_trim_suffix(transcript: str) -> str:
    """Drop a trailing parenthesized stm key (esb_test.py:1069-1078)."""
    splits = transcript.rsplit(" ", 1)
    transcript = splits[0]
    if len(splits) > 1:
        suffix = splits[-1]
        if not suffix.startswith("("):
            transcript += " " + suffix
    return transcript


def clean_tedlium(transcript: str) -> str | None:
    """esb_test.py:778-794: trim stm suffix, lower, drop ignore segments,
    strip <unk>, un-space contractions, JIWER whitespace compliance."""
    transcript = maybe_trim_suffix(transcript).lower()
    if transcript in IGNORE_SEGMENTS:
        return None
    transcript = transcript.replace("<unk>", "")
    for contraction in TEDLIUM_CONTRACTIONS:
        transcript = transcript.replace(contraction, contraction[1:])
    transcript = _squash_spaces(transcript)
    return transcript or None


def clean_gigaspeech(text: str) -> str | None:
    """esb_test.py:960-972: lower, drop ignore segments, strip junk tags,
    symbolize spelled-out punctuation, JIWER whitespace compliance."""
    text = text.lower()
    if text in IGNORE_SEGMENTS:
        return None
    for junk in GIGASPEECH_JUNK_TOKENS:
        text = text.replace(junk, "")
    for spoken, symbol in GIGASPEECH_PUNCTUATION.items():
        text = text.replace(spoken, symbol)
    text = _squash_spaces(text)
    return text or None


def clean_earnings(text: str) -> str | None:
    """esb_test.py:1046-1056 (case-preserving, unlike gigaspeech)."""
    if text.lower() in IGNORE_SEGMENTS:
        return None
    for junk in EARNINGS_JUNK_TOKENS:
        text = text.replace(junk, "")
    text = _squash_spaces(text)
    return text or None


def clean_common_voice(text: str) -> str | None:
    """esb_test.py:729-737: strip wrapping quotes, normalize doubled
    quotes, drop empties."""
    if text.startswith('"') and text.endswith('"'):
        text = text[1:-1]
    if len(text) == 0:
        return None
    return text.replace('""', '"')


# ---------------------------------------------------------------------------
# SPHERE (.sph) reader for TEDLIUM segment extraction
# ---------------------------------------------------------------------------

def read_sphere(path: str) -> tuple[bytes, int, int]:
    """NIST SPHERE -> (pcm bytes, sample_rate, sample_n_bytes).

    Minimal parser for TEDLIUM's 16 kHz 16-bit little-endian mono PCM."""
    with open(path, "rb") as f:
        head = f.read(1024)
        lines = head.decode("ascii", "ignore").splitlines()
        assert lines and lines[0].strip() == "NIST_1A", f"not SPHERE: {path}"
        header_size = int(lines[1].strip())
        fields: dict[str, str] = {}
        for line in lines[2:]:
            parts = line.strip().split(" ", 2)
            if parts[0] == "end_head":
                break
            if len(parts) == 3:
                fields[parts[0]] = parts[2]
        f.seek(header_size)
        pcm = f.read()
    rate = int(fields.get("sample_rate", "16000"))
    nbytes = int(fields.get("sample_n_bytes", "2"))
    coding = fields.get("sample_coding", "pcm")
    assert coding.startswith("pcm"), f"unsupported sph coding {coding}"
    if fields.get("sample_byte_format") == "10" and nbytes == 2:  # big-endian
        import numpy as np

        pcm = np.frombuffer(pcm, ">i2").astype("<i2").tobytes()
    return pcm, rate, nbytes


def _wav_bytes(pcm: bytes, sr: int) -> bytes:
    return (
        struct.pack(
            "<4sI4s4sIHHIIHH4sI",
            b"RIFF", 36 + len(pcm), b"WAVE", b"fmt ", 16, 1, 1,
            sr, sr * 2, 2, 16, b"data", len(pcm),
        )
        + pcm
    )


# ---------------------------------------------------------------------------
# Per-corpus preparers: raw layout -> manifest rows
# ---------------------------------------------------------------------------

def _find_files(root: str, suffix: str) -> list[str]:
    out = []
    for dirpath, _, names in os.walk(root):
        out.extend(
            os.path.join(dirpath, n) for n in names if n.endswith(suffix)
        )
    return sorted(out)


def prepare_ami(raw_dir: str, out_dir: str, split: str = "eval") -> Iterator[dict]:
    """raw_dir: extracted per-meeting wav dirs + the split's annotation
    text file (lines '<ID> <text...>', esb_test.py:368-383); audio files
    are named '{split}_{id.lower()}.wav'."""
    ann = _find_files(raw_dir, ".txt")
    assert ann, f"no annotation .txt under {raw_dir}"
    transcriptions = {}
    for ann_path in ann:
        with open(ann_path, encoding="utf-8") as f:
            for line in f:
                items = line.strip().split()
                if not items:
                    continue
                _id = items[0]
                text = " ".join(items[1:])
                audio_filename = "_".join([split, _id.lower()]) + ".wav"
                transcriptions[audio_filename] = {"id": _id, "text": text}
    for wav in _find_files(raw_dir, ".wav"):
        meta = transcriptions.get(os.path.basename(wav))
        if meta is None:
            continue
        yield {"id": meta["id"], "audio": wav, "text": meta["text"]}


def prepare_spgispeech(raw_dir: str, out_dir: str, split: str = "test") -> Iterator[dict]:
    """raw_dir: extracted wav dirs + a '|'-delimited metadata csv with
    wav_filename/transcript columns (esb_test.py:452-480)."""
    metas = _find_files(raw_dir, ".csv")
    assert metas, f"no metadata csv under {raw_dir}"
    metadata = {}
    for meta in metas:
        with open(meta, encoding="utf-8") as f:
            for row in csv.DictReader(f, delimiter="|"):
                metadata[row["wav_filename"]] = row["transcript"]
    for wav in _find_files(raw_dir, ".wav"):
        key = "/".join(wav.split(os.sep)[-2:])
        if key in metadata:
            yield {"id": key, "audio": wav, "text": metadata[key]}


def prepare_voxpopuli(raw_dir: str, out_dir: str, split: str = "test") -> Iterator[dict]:
    """raw_dir: extracted wavs named <id>.wav + tab-delimited metadata with
    id/normalized_text columns; text lowered (esb_test.py:527-545)."""
    metas = _find_files(raw_dir, ".tsv")
    assert metas, f"no metadata tsv under {raw_dir}"
    metadata = {}
    for meta in metas:
        with open(meta, encoding="utf-8") as f:
            for row in csv.DictReader(f, delimiter="\t"):
                metadata[row["id"]] = row
    for wav in _find_files(raw_dir, ".wav"):
        audio_id = os.path.basename(wav)[: -len(".wav")]
        if audio_id in metadata:
            yield {
                "id": audio_id,
                "audio": wav,
                "text": metadata[audio_id]["normalized_text"].lower(),
            }


def prepare_librispeech(raw_dir: str, out_dir: str, split: str = "test.clean") -> Iterator[dict]:
    """raw_dir: the extracted LibriSpeech tree (chapter dirs with .flac +
    .trans.txt 'ID TRANSCRIPT' rows); transcript lowered
    (esb_test.py:590-629)."""
    for trans in _find_files(raw_dir, ".trans.txt"):
        base = os.path.dirname(trans)
        with open(trans, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                id_, transcript = line.split(" ", 1)
                flac = os.path.join(base, f"{id_}.flac")
                if os.path.exists(flac):
                    yield {"id": id_, "audio": flac,
                           "text": transcript.lower()}


def prepare_common_voice(raw_dir: str, out_dir: str, split: str = "test") -> Iterator[dict]:
    """raw_dir: a Common Voice bundle dir ({split}.tsv + clips/*.mp3);
    quote cleanup per esb_test.py:729-737."""
    tsv = os.path.join(raw_dir, f"{split}.tsv")
    if not os.path.exists(tsv):
        cands = _find_files(raw_dir, f"{split}.tsv")
        assert cands, f"no {split}.tsv under {raw_dir}"
        tsv = cands[0]
    base = os.path.dirname(tsv)
    with open(tsv, encoding="utf-8") as f:
        for row in csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE):
            path = row["path"]
            if not path.endswith(".mp3"):
                path += ".mp3"
            audio = os.path.join(base, "clips", path)
            text = clean_common_voice(row["sentence"])
            if text is None or not os.path.exists(audio):
                continue
            yield {"id": row.get("client_id", path), "audio": audio,
                   "text": text}


def prepare_tedlium(raw_dir: str, out_dir: str, split: str = "test") -> Iterator[dict]:
    """raw_dir: the split dir (or release root) holding .stm + .sph talk
    files; segments cut to [start, end) and written as WAVs under
    out_dir/audio (esb_test.py:761-810 + :1081-1088)."""
    audio_out = os.path.join(out_dir, "audio")
    os.makedirs(audio_out, exist_ok=True)
    for stm in _find_files(raw_dir, ".stm"):
        sph = stm[: -len(".stm")] + ".sph"
        pcm = rate = nbytes = None
        with open(stm, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                fn, channel, speaker, start, end, label, transcript = (
                    line.split(" ", 6)
                )
                text = clean_tedlium(transcript)
                if text is None:
                    continue
                if pcm is None:
                    src = sph
                    if not os.path.exists(src):
                        src = os.path.join(
                            os.path.dirname(stm), fn + ".sph"
                        )
                    pcm, rate, nbytes = read_sphere(src)
                lo = int(float(start) * rate) * nbytes
                hi = min(int(float(end) * rate) * nbytes, len(pcm))
                key = "-".join([speaker, start, end, label])
                seg_name = re.sub(r"[^A-Za-z0-9._-]", "_", key) + ".wav"
                seg_path = os.path.join(audio_out, seg_name)
                with open(seg_path, "wb") as wf:
                    wf.write(_wav_bytes(pcm[lo:hi], rate))
                yield {"id": key, "audio": seg_path, "text": text}


def prepare_gigaspeech(raw_dir: str, out_dir: str, split: str = "test") -> Iterator[dict]:
    """raw_dir: extracted chunk dirs of <sid>.wav + metadata csv(s) with
    sid/text_tn columns; cleanup per esb_test.py:940-987."""
    metas = _find_files(raw_dir, ".csv")
    assert metas, f"no metadata csv under {raw_dir}"
    meta_dict = {}
    for meta in metas:
        with open(meta, encoding="utf-8") as f:
            for row in csv.DictReader(f):
                meta_dict[row["sid"]] = row
    for wav in _find_files(raw_dir, ".wav"):
        sid = os.path.basename(wav)[: -len(".wav")]
        row = meta_dict.get(sid)
        if row is None:
            continue
        text = clean_gigaspeech(row["text_tn"])
        if text is None:
            continue
        yield {"id": sid, "audio": wav, "text": text}


def prepare_earnings22(raw_dir: str, out_dir: str, split: str = "test") -> Iterator[dict]:
    """raw_dir: extracted chunked wav files + metadata.csv with
    file/sentence columns; cleanup per esb_test.py:1033-1068."""
    meta = os.path.join(raw_dir, "metadata.csv")
    if not os.path.exists(meta):
        cands = _find_files(raw_dir, "metadata.csv")
        assert cands, f"no metadata.csv under {raw_dir}"
        meta = cands[0]
    metadata = {}
    with open(meta, encoding="utf-8") as f:
        for row in csv.DictReader(f, delimiter=","):
            metadata[row["file"]] = row["sentence"]
    for wav in _find_files(raw_dir, ".wav"):
        name = os.path.basename(wav)
        if name not in metadata:
            continue
        text = clean_earnings(metadata[name])
        if text is None:
            continue
        yield {"id": name, "audio": wav, "text": text}


PREPARERS: dict[str, Callable[..., Iterator[dict]]] = {
    "ami": prepare_ami,
    "spgispeech": prepare_spgispeech,
    "voxpopuli": prepare_voxpopuli,
    "tedlium": prepare_tedlium,
    "gigaspeech": prepare_gigaspeech,
    "librispeech": prepare_librispeech,
    "common_voice": prepare_common_voice,
    "earnings22": prepare_earnings22,
}


def prepare_corpus(
    corpus: str, raw_dir: str, out_dir: str, split: str | None = None
) -> int:
    """Run one corpus preparer, writing out_dir/manifest.jsonl. Audio is
    referenced in place (absolute paths) except TEDLIUM segment WAVs,
    which are written under out_dir/audio. Returns the row count."""
    if corpus not in PREPARERS:
        raise ValueError(
            f"unknown ESB corpus {corpus!r}; have {sorted(PREPARERS)}"
        )
    os.makedirs(out_dir, exist_ok=True)
    fn = PREPARERS[corpus]
    kwargs = {} if split is None else {"split": split}
    n = 0
    with open(os.path.join(out_dir, "manifest.jsonl"), "w",
              encoding="utf-8") as f:
        for row in fn(os.path.abspath(raw_dir), os.path.abspath(out_dir),
                      **kwargs):
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
            n += 1
    return n
