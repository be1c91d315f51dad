"""The port's unigram tokenizer and charsmap normalizer against the JAX package's.

The vocabularies and charsmap blobs are those of tests/test_unigram.py and
tests/test_charsmap.py; the tokenizer.json files are written here by hand
(the HF serialization: a Unigram model, added_tokens, a normalizer block),
so only the cases that also hold the port to the `tokenizers` oracle need
that library.

- `PrecompiledCharsmap.normalize` equals the JAX package's on every case
  and a fuzz of 300 strings; the blobs `build_charsmap` writes are equal.
- `UnigramTokenizer.encode_text` gives the JAX package's ids (Viterbi with
  unknown characters fused, NFKC, a Sequence[Precompiled, Replace]
  normalizer), `decode_ids` its strings.
- `NllbTokenizer`: `lang_id` through added_tokens and pieces, the
  [src_lang] + pieces + [eos] framing, decode without specials.
"""
from __future__ import annotations

import base64
import json
import random

import pytest

from kotoba_whisper_tpu.tokenizer import charsmap as jcm
from kotoba_whisper_tpu.tokenizer import unigram as ju
from kotoba_whisper_tpu_torch.tokenizer import charsmap as cm
from kotoba_whisper_tpu_torch.tokenizer import unigram as u

VOCAB = [
    ("<unk>", 0.0), ("</s>", 0.0),
    ("▁", -6.0), ("▁the", -3.0), ("▁quick", -5.0), ("▁q", -4.5),
    ("uick", -4.8), ("▁brown", -5.1), ("▁fox", -4.9), ("▁jumps", -5.3),
    ("s", -3.9), ("▁jump", -4.7), ("th", -4.0), ("e", -3.5), ("▁th", -3.8),
    ("▁over", -4.4), ("▁lazy", -5.2), ("▁dog", -4.6), ("o", -3.7),
    ("ver", -4.2), ("▁o", -4.1), ("g", -4.0), ("▁do", -4.3), ("qu", -4.4),
    ("ick", -4.2), ("▁bro", -4.9), ("wn", -4.1), ("fox", -5.5), ("▁f", -4.2),
    ("ox", -4.3), ("jump", -5.0), ("▁j", -4.4), ("umps", -4.6), ("la", -4.3),
    ("zy", -4.4), ("▁l", -4.2), ("azy", -4.5), ("d", -4.1), ("▁d", -4.2),
    ("og", -4.3),
]

SENTENCES = [
    "the quick brown fox jumps over the lazy dog",
    "the the the",
    "fox",
    "quick jumps  dog",
    "ｔｈｅ fox",
    " fox",
    "fox ",
    "  fox",
    "fox #@ dog",                # unknown characters fuse into one unk
    "#@!",
    "",
]

# test_charsmap.py's mapping and cases, and test_unigram.py's normalizer blob
MAPPING = {
    "Ａ": "A", "Ｂ": "B", "１": "1", "ｶ": "カ", "が": "が", "ﬁ": "fi",
    "​": "", "…": "...", " ": " ",
}
NORM_MAPPING = {"Ｔ": "t", "Ｑ": "q", "１": "1", "…": "...", "​": ""}
CHARSMAP_CASES = [
    "Ａ", "ＡＢ plain ＡＢ", "１２", "ｶﾞ is not mapped whole", "がき", "ﬁnancial ﬁle",
    "a​b", "ellipsis… here", "nb sp", "mixed Ａが１…​ end", "", "plain ascii only",
]
NORM_CASES = [
    "Ｔhe Ｑuick fox", "the​quick", "jumps  over   dog", "…the dog１", "plain the quick",
]


def _write_tokenizer_json(path, vocab, added=(), normalizer=None, unk_id=0):
    """The tokenizers library's serialization of a Unigram model."""
    data = {
        "version": "1.0",
        "added_tokens": [
            {"id": len(vocab) + i, "content": a, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for i, a in enumerate(added)],
        "normalizer": normalizer,
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                          "prepend_scheme": "always", "split": True},
        "model": {"type": "Unigram", "unk_id": unk_id, "vocab": [list(v) for v in vocab],
                  "byte_fallback": False},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False)
    return str(path)


def _precompiled(mapping):
    return {"type": "Sequence", "normalizers": [
        {"type": "Precompiled",
         "precompiled_charsmap": base64.b64encode(cm.build_charsmap(mapping)).decode()},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]}


def test_build_charsmap_blob_equals_jax():
    for mapping in (MAPPING, NORM_MAPPING, {}):
        assert cm.build_charsmap(mapping) == jcm.build_charsmap(mapping)


def test_charsmap_normalize_matches_jax():
    blob = jcm.build_charsmap(MAPPING)
    ours, ref = cm.PrecompiledCharsmap(blob), jcm.PrecompiledCharsmap(blob)
    for text in CHARSMAP_CASES:
        assert ours.normalize(text) == ref.normalize(text), repr(text)
    rng = random.Random(0)
    alphabet = list("abcＡＢ１ｶﬁ…  か") + ["゙", "​", "キ"]
    for _ in range(300):
        s = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 12)))
        assert ours.normalize(s) == ref.normalize(s), repr(s)


@pytest.mark.parametrize("normalizer", ["nfkc", "none", "precompiled"])
def test_unigram_ids_and_decode_match_jax(tmp_path, normalizer):
    spec = {"nfkc": {"type": "NFKC"}, "none": None,
            "precompiled": _precompiled(NORM_MAPPING)}[normalizer]
    path = _write_tokenizer_json(tmp_path / "tokenizer.json", VOCAB, normalizer=spec)
    ours, ref = u.UnigramTokenizer.from_tokenizer_json(path), \
        ju.UnigramTokenizer.from_tokenizer_json(path)
    assert (ours.pieces, ours.unk_id, ours.max_piece_len, ours.min_score) == \
        (ref.pieces, ref.unk_id, ref.max_piece_len, ref.min_score)
    texts = SENTENCES + (NORM_CASES if normalizer == "precompiled" else [])
    for text in texts:
        ids = ours.encode_text(text)
        assert ids == ref.encode_text(text), repr(text)
        assert ours.decode_ids(ids) == ref.decode_ids(ids)
    assert ours.encode_text("fox #@ dog").count(ours.unk_id) == 1  # fused


def test_nllb_framing_matches_jax(tmp_path):
    # a language code as an added token and one as a plain piece
    vocab = VOCAB + [("eng_Latn", 0.0)]
    _write_tokenizer_json(tmp_path / "tokenizer.json", vocab, added=["jpn_Jpan", "<pad>"],
                          normalizer={"type": "NFKC"})
    ours = u.NllbTokenizer.from_pretrained_dir(str(tmp_path))
    ref = ju.NllbTokenizer.from_pretrained_dir(str(tmp_path))
    for code in ("jpn_Jpan", "eng_Latn", "</s>", "<pad>"):
        assert ours.lang_id(code) == ref.lang_id(code)
    assert ours.lang_id("jpn_Jpan") == len(vocab)
    assert ours.eos_id == ref.eos_id == 1
    with pytest.raises(KeyError, match="unknown language code"):
        ours.lang_id("xxx_Xxxx")
    for text in ("the quick fox", "fox #@ dog", ""):
        for lang in ("jpn_Jpan", "eng_Latn"):
            ids = ours.encode(text, lang)
            assert ids == ref.encode(text, lang)
            assert ids[0] == ours.lang_id(lang) and ids[-1] == ours.eos_id
            assert ours.decode(ids) == ref.decode(ids)
    assert ours.decode(ours.encode("the quick fox", "jpn_Jpan")) == "the quick fox"


def test_unigram_matches_tokenizers_oracle(tmp_path):
    """The port against the library the JAX tests use as their oracle, on
    the hand-written tokenizer.json with the precompiled normalizer."""
    tokenizers = pytest.importorskip("tokenizers")
    path = _write_tokenizer_json(tmp_path / "tokenizer.json", VOCAB,
                                 normalizer=_precompiled(NORM_MAPPING))
    oracle = tokenizers.Tokenizer.from_file(path)
    ours = u.UnigramTokenizer.from_tokenizer_json(path)
    for text in SENTENCES + NORM_CASES:
        assert ours.encode_text(text) == oracle.encode(text).ids, repr(text)
