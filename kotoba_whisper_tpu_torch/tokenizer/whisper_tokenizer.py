"""Whisper tokenizer: byte-level BPE (C++ core) + special-token machinery.

The port's copy of what the pseudo-labelling driver needs: HF-format
vocab.json/merges.txt loading, a bytes-only vocab with the exact whisper
id layout (`byte_vocab`), the multilingual special tokens including the
1501 timestamps, `sot_sequence` (<|sot|><|lang|><|task|>[<|notimestamps|>]),
`decode` with or without specials and timestamps, and for long-form merge
`segments_from_tokens`. Decoding runs in native/bpe.cpp through
utils/native.py.
"""
from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Iterable, Sequence

import numpy as np

from kotoba_whisper_tpu_torch.core.config import LANG_TO_INDEX, SpecialTokens
from kotoba_whisper_tpu_torch.utils import native


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


def _token_str_to_bytes(tok: str) -> bytes:
    u2b = unicode_to_bytes()
    return bytes(u2b[ch] for ch in tok)


class _BpeCore:
    """ctypes handle wrapper for the C++ BPE engine."""

    def __init__(self, id_to_bytes: list[bytes], merges: list[tuple[int, int, int]]):
        self._lib = native.load()
        blob = b"".join(id_to_bytes)
        offsets = np.zeros(len(id_to_bytes) + 1, np.int64)
        np.cumsum([len(t) for t in id_to_bytes], out=offsets[1:])
        blob_arr = np.frombuffer(blob, np.uint8) if blob else np.zeros(1, np.uint8)
        merge_arr = (
            np.asarray(merges, np.int32).reshape(-1)
            if merges
            else np.zeros(3, np.int32)
        )
        import ctypes

        self._h = self._lib.kwt_bpe_new(
            blob_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(id_to_bytes),
            merge_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(merges),
        )
        self._keepalive = (blob_arr, offsets, merge_arr)

    def decode(self, ids: Sequence[int]) -> bytes:
        import ctypes

        arr = np.asarray(ids, np.int32)
        max_out = max(16, len(arr) * 64)
        out = np.zeros(max_out, np.uint8)
        n = self._lib.kwt_bpe_decode(
            self._h,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(arr),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            max_out,
        )
        if n < 0:
            raise ValueError("BPE decode overflow")
        return out[:n].tobytes()


class WhisperTokenizer:
    def __init__(
        self,
        id_to_bytes: list[bytes],
        merges: list[tuple[int, int, int]],
        vocab_size: int | None = None,
        n_langs: int = 99,
    ):
        """id_to_bytes covers text tokens [0, n_text); specials follow the
        whisper layout directly above the text vocab."""
        self.n_text = len(id_to_bytes)
        if vocab_size is not None and self.n_text == 50257:
            self.special = SpecialTokens.for_vocab(vocab_size)
        else:
            self.special = SpecialTokens.layout(self.n_text, n_langs)
        self.vocab_size = self.special.vocab_size
        self._core = _BpeCore(id_to_bytes, merges)
        self._special_str_to_id = self._build_special_map()
        self._special_id_to_str = {v: k for k, v in self._special_str_to_id.items()}

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_files(
        cls, vocab_json: str, merges_txt: str, n_langs: int = 99
    ) -> "WhisperTokenizer":
        """HF-format vocab.json + merges.txt (openai/whisper-* assets).
        n_langs: 99 for v1/v2 vocabs (51865), 100 for large-v3 (51866)."""
        with open(vocab_json, encoding="utf-8") as f:
            vocab: dict[str, int] = json.load(f)
        # text tokens only (specials live outside vocab.json in whisper)
        n_text = max(vocab.values()) + 1
        id_to_bytes = [b""] * n_text
        str_to_id = {}
        for tok, idx in vocab.items():
            if idx < n_text:
                id_to_bytes[idx] = _token_str_to_bytes(tok)
                str_to_id[tok] = idx
        merges: list[tuple[int, int, int]] = []
        with open(merges_txt, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merged = a + b
                if a in str_to_id and b in str_to_id and merged in str_to_id:
                    merges.append((str_to_id[a], str_to_id[b], str_to_id[merged]))
        return cls(id_to_bytes, merges, n_langs=n_langs)

    @classmethod
    def from_pretrained_dir(cls, path: str, n_langs: int = 99) -> "WhisperTokenizer":
        return cls.from_files(
            os.path.join(path, "vocab.json"),
            os.path.join(path, "merges.txt"),
            n_langs=n_langs,
        )

    @classmethod
    def byte_vocab(cls, vocab_size: int = 51865) -> "WhisperTokenizer":
        """Bytes-only text vocab with the standard whisper id layout —
        for tests and vocab-free pipelines. ids 0..255 = raw bytes."""
        id_to_bytes = [bytes([i]) for i in range(256)]
        return cls(id_to_bytes, [], vocab_size)

    # ------------------------------------------------------------------
    # specials
    # ------------------------------------------------------------------
    def _build_special_map(self) -> dict[str, int]:
        st = self.special
        m = {
            "<|endoftext|>": st.eot,
            "<|startoftranscript|>": st.sot,
            "<|translate|>": st.translate,
            "<|transcribe|>": st.transcribe,
            "<|startoflm|>": st.startoflm,
            "<|startofprev|>": st.startofprev,
            "<|nospeech|>": st.nospeech,
            "<|notimestamps|>": st.no_timestamps,
        }
        for code, idx in LANG_TO_INDEX.items():
            if idx < st.n_langs:
                m[f"<|{code}|>"] = st.lang_begin + idx
        for i in range(st.n_timestamps):
            m[f"<|{i * 0.02:.2f}|>"] = st.timestamp_begin + i
        return m

    def lang_id(self, lang: str) -> int:
        return self.special.lang_begin + LANG_TO_INDEX[lang]

    def sot_sequence(
        self, lang: str | None = None, task: str | None = None,
        timestamps: bool = True,
    ) -> list[int]:
        """set_prefix_tokens semantics (run_pseudo_labelling.py:234-237)."""
        st = self.special
        seq = [st.sot]
        if lang is not None:
            seq.append(self.lang_id(lang))
        if task is not None:
            seq.append(st.transcribe if task == "transcribe" else st.translate)
        if not timestamps:
            seq.append(st.no_timestamps)
        return seq

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def decode(
        self,
        ids: Iterable[int],
        skip_special_tokens: bool = True,
        decode_with_timestamps: bool = False,
    ) -> str:
        out: list[str] = []
        run: list[int] = []  # pending text-token run for the C++ core

        def flush():
            if run:
                out.append(self._core.decode(run).decode("utf-8", errors="replace"))
                run.clear()

        st = self.special
        for i in ids:
            i = int(i)
            if i < 0:
                continue
            if i < self.n_text:
                run.append(i)
                continue
            if i >= st.timestamp_begin and decode_with_timestamps:
                flush()
                out.append(f"<|{(i - st.timestamp_begin) * 0.02:.2f}|>")
            elif not skip_special_tokens:
                flush()
                s = self._special_id_to_str.get(i)
                if s is not None:
                    out.append(s)
            # else: skip the special
        flush()
        return "".join(out)


def segments_from_tokens(
    tok: WhisperTokenizer, ids: Sequence[int]
) -> list[dict]:
    """Split a timestamped token stream into [{'start','end','text'}] chunks
    (the ASR pipeline's chunk output schema, run_short_form_eval.py:184-191)."""
    st = tok.special
    segs: list[dict] = []
    cur_start = None
    cur_tokens: list[int] = []
    for i in ids:
        i = int(i)
        if i >= st.timestamp_begin:
            t = (i - st.timestamp_begin) * 0.02
            if cur_start is None:
                cur_start = t
            else:
                segs.append(
                    {
                        "start": cur_start,
                        "end": t,
                        "text": tok.decode(cur_tokens),
                    }
                )
                cur_start = None
                cur_tokens = []
        elif i == st.eot:
            break
        elif cur_start is not None:
            cur_tokens.append(i)
    if cur_tokens and cur_start is not None:
        segs.append({"start": cur_start, "end": None, "text": tok.decode(cur_tokens)})
    return segs
