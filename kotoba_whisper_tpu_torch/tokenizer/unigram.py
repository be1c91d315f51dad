"""SentencePiece-Unigram tokenizer (NLLB/M2M100 family), from tokenizer.json.

The reference's cascaded S2T translation tokenizes through NLLB's
sentencepiece model via HF
(misc/cascaded_s2t_translation/ja_cascaded_s2t_translation.py:45-48).
This module implements the Unigram inference algorithm natively so an NLLB
checkpoint dir (config.json + model.safetensors + tokenizer.json) is fully
loadable without the HF stack:

  - loads the HF `tokenizer.json` serialization (model.type == "Unigram":
    [piece, logprob] vocab + unk_id; added_tokens carry the language codes
    and specials);
  - normalization: the tokenizer.json `normalizer` block is interpreted
    natively — Precompiled charsmaps (NLLB's NMT-NFKC, decoded by
    tokenizer/charsmap.py with HF-crate-exact semantics), Replace,
    Prepend, Strip, Lowercase, NFKC/NFC/NFD/NFKD, and Sequence thereof;
    files without a normalizer fall back to NFKC;
  - pre-tokenization: Metaspace (split on spaces, each word prefixed with
    the ▁ marker);
  - segmentation: Viterbi maximum-likelihood over the piece vocabulary
    with unk fallback (single chars at min_score - 10, consecutive unks
    fused) — the sentencepiece inference algorithm;
  - NLLB framing: encode(text, src_lang) = [lang_code] + pieces + [eos],
    decode strips specials and the ▁ markers.

Golden-tested against the `tokenizers` library's Unigram model on synthetic
vocabularies (tests/test_unigram.py) — the same offline-oracle strategy as
the BPE engine's GPT-2 goldens.

A copy of the JAX package's tokenizer/unigram.py, which imports no JAX;
the port's ids equal the JAX package's (tests/test_torch_unigram.py).
"""
from __future__ import annotations

import json
import re
import unicodedata
from dataclasses import dataclass, field
from typing import Callable

_MARKER = "▁"  # ▁
_UNK_PENALTY = 10.0


def _build_normalizer(spec: dict | None) -> Callable[[str], str]:
    """Interpret a tokenizer.json `normalizer` block (the subset the
    NLLB/M2M100 family uses). None -> NFKC (historical default)."""
    if spec is None:
        return lambda t: unicodedata.normalize("NFKC", t)
    kind = spec.get("type")
    if kind == "Sequence":
        fns = [_build_normalizer(s) for s in spec.get("normalizers", [])]

        def seq(t: str) -> str:
            for f in fns:
                t = f(t)
            return t

        return seq
    if kind == "Precompiled":
        from kotoba_whisper_tpu_torch.tokenizer.charsmap import PrecompiledCharsmap

        cm = PrecompiledCharsmap.from_base64(spec["precompiled_charsmap"])
        return cm.normalize
    if kind == "Replace":
        pat = spec.get("pattern", {})
        repl = spec.get("content", "")
        if "String" in pat:
            return lambda t: t.replace(pat["String"], repl)
        rx = re.compile(pat.get("Regex", ""))
        return lambda t: rx.sub(repl, t)
    if kind == "Prepend":
        pre = spec.get("prepend", "")
        return lambda t: (pre + t) if t and not t.startswith(pre) else t
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)

        def strip(t: str) -> str:
            if left:
                t = t.lstrip()
            if right:
                t = t.rstrip()
            return t

        return strip
    if kind == "Lowercase":
        return str.lower
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda t: unicodedata.normalize(kind, t)
    raise ValueError(f"unsupported normalizer type: {kind!r}")


@dataclass
class UnigramTokenizer:
    pieces: dict[str, tuple[int, float]]       # piece -> (id, logprob)
    id_to_piece: dict[int, str]
    unk_id: int
    added_tokens: dict[str, int] = field(default_factory=dict)
    max_piece_len: int = 1
    # cached at load: an O(V) scan per pre-token would dominate encode
    # time on NLLB's ~256k vocab
    min_score: float = 0.0
    normalizer: Callable[[str], str] | None = None

    @classmethod
    def from_tokenizer_json(cls, path: str) -> "UnigramTokenizer":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        model = data["model"]
        if model.get("type") != "Unigram":
            raise ValueError(f"not a Unigram tokenizer: {model.get('type')}")
        pieces = {}
        id_to_piece = {}
        for i, (piece, score) in enumerate(model["vocab"]):
            pieces[piece] = (i, float(score))
            id_to_piece[i] = piece
        added = {
            t["content"]: t["id"] for t in data.get("added_tokens", [])
        }
        for content, tid in added.items():
            id_to_piece[tid] = content
        return cls(
            pieces=pieces,
            id_to_piece=id_to_piece,
            unk_id=model.get("unk_id", 0),
            added_tokens=added,
            max_piece_len=max((len(p) for p in pieces), default=1),
            min_score=min(
                (s for _, s in pieces.values()), default=0.0
            ),
            normalizer=_build_normalizer(data.get("normalizer")),
        )

    # -- core unigram inference ------------------------------------------------

    def _viterbi(self, word: str) -> list[int]:
        """Maximum-logprob segmentation of one pre-token (sentencepiece
        Viterbi). Unknown characters score min_score - 10; consecutive
        unks fuse into one unk token (tokenizers fuse_unk semantics)."""
        n = len(word)
        unk_score = self.min_score - _UNK_PENALTY
        # best[i] = (score, start_of_last_piece, piece_id or None=unk)
        NEG = float("-inf")
        best = [(NEG, -1, -1)] * (n + 1)
        best[0] = (0.0, 0, -1)
        for i in range(n):
            sc_i = best[i][0]
            if sc_i == NEG:
                continue
            lim = min(n, i + self.max_piece_len)
            for j in range(i + 1, lim + 1):
                hit = self.pieces.get(word[i:j])
                if hit is not None and sc_i + hit[1] > best[j][0]:
                    best[j] = (sc_i + hit[1], i, hit[0])
            # unk fallback: one char
            if sc_i + unk_score > best[i + 1][0]:
                best[i + 1] = (sc_i + unk_score, i, -1)
        # backtrack
        out: list[int] = []
        j = n
        while j > 0:
            _, i, pid = best[j]
            out.append(pid if pid >= 0 else self.unk_id)
            j = i
        out.reverse()
        # fuse consecutive unks
        fused: list[int] = []
        for t in out:
            if t == self.unk_id and fused and fused[-1] == self.unk_id:
                continue
            fused.append(t)
        return fused

    def encode_text(self, text: str) -> list[int]:
        """Normalize + Metaspace + Viterbi (no specials added).

        Metaspace (prepend_scheme="always") semantics pinned against the
        tokenizers oracle: every space becomes ▁, a leading ▁ is added
        unless one is already there, and the model runs per ▁-prefixed
        segment (pieces never cross segment boundaries)."""
        if self.normalizer is not None:
            text = self.normalizer(text)
        else:
            text = unicodedata.normalize("NFKC", text)
        if not text:
            return []
        s = text.replace(" ", _MARKER)
        if not s.startswith(_MARKER):
            s = _MARKER + s
        ids: list[int] = []
        start = 0
        for i in range(1, len(s) + 1):
            if i == len(s) or s[i] == _MARKER:
                ids.extend(self._viterbi(s[start:i]))
                start = i
        return ids

    _SPECIALS = frozenset({"<unk>", "<s>", "</s>", "<pad>", "<mask>"})

    def decode_ids(self, ids) -> str:
        parts = []
        for i in ids:
            piece = self.id_to_piece.get(int(i), "")
            if piece in self.added_tokens or piece in self._SPECIALS:
                continue
            parts.append(piece)
        return "".join(parts).replace(_MARKER, " ").strip()


@dataclass
class NllbTokenizer:
    """NLLB framing around the unigram engine: source sequences are
    [src_lang_code] + pieces + [eos] (the post-processor the HF fast
    tokenizer applies), targets begin with the forced target lang code."""

    uni: UnigramTokenizer
    eos_token: str = "</s>"

    @classmethod
    def from_pretrained_dir(cls, path: str) -> "NllbTokenizer":
        import os

        return cls(
            UnigramTokenizer.from_tokenizer_json(
                os.path.join(path, "tokenizer.json")
            )
        )

    def lang_id(self, lang_code: str) -> int:
        if lang_code in self.uni.added_tokens:
            return self.uni.added_tokens[lang_code]
        hit = self.uni.pieces.get(lang_code)
        if hit is None:
            raise KeyError(f"unknown language code {lang_code!r}")
        return hit[0]

    @property
    def eos_id(self) -> int:
        return self.lang_id(self.eos_token)

    def encode(self, text: str, src_lang: str) -> list[int]:
        return [self.lang_id(src_lang)] + self.uni.encode_text(text) + [
            self.eos_id
        ]

    def decode(self, ids) -> str:
        return self.uni.decode_ids(ids)
