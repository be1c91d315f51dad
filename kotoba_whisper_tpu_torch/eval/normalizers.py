"""Text normalizers for CER/WER evaluation and WER filtering.

Behavioral equivalents of the Whisper normalizers the reference imports from
transformers (run_data_filtering.py:12,143-146; run_short_form_eval.py:
196-206): BasicTextNormalizer (exact) and an EnglishTextNormalizer covering
the rule pipeline (contractions, abbreviation expansion, symbol handling;
the optional checkpoint-supplied spelling dictionary is accepted as a
parameter). The ja eval post-rule (strip spaces, `。.` -> `。`) is
`ja_post_normalize`.
"""
from __future__ import annotations

import re
import unicodedata
from typing import Mapping


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    return "".join(
        c
        if c in keep
        else (
            ""
            if unicodedata.category(c) == "Mn"
            else (" " if unicodedata.category(c)[0] in "MSP" else c)
        )
        for c in unicodedata.normalize("NFKD", s)
    )


def remove_symbols(s: str) -> str:
    return "".join(
        " " if unicodedata.category(c)[0] in "MSP" else c
        for c in unicodedata.normalize("NFKC", s)
    )


class BasicTextNormalizer:
    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self.clean = (
            remove_symbols_and_diacritics if remove_diacritics else remove_symbols
        )
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # bracketed annotations
        s = re.sub(r"\(([^)]+?)\)", "", s)  # parenthesized annotations
        s = self.clean(s).lower()
        if self.split_letters:
            import regex  # only here: the ja and en paths need no third-party module

            s = " ".join(regex.findall(r"\X", s, regex.U))
        s = re.sub(r"\s+", " ", s)
        return s  # NB: no strip() — matches the HF normalizer exactly
        # (trailing space survives; the ja eval rule strips spaces anyway)


class EnglishTextNormalizer:
    """Rule pipeline of Whisper's English normalizer. A spelling-correction
    mapping (from a checkpoint's normalizer.json) may be supplied; number
    verbalization is intentionally conservative (digit strings are kept
    as-is, matching the metric-relevant common cases)."""

    def __init__(self, english_spelling_mapping: Mapping[str, str] | None = None):
        from kotoba_whisper_tpu_torch.eval.number_normalizer import (
            EnglishNumberNormalizer,
        )

        self.spelling = dict(english_spelling_mapping or {})
        self.number_normalizer = EnglishNumberNormalizer()
        self.ignore_patterns = (
            r"\b(hmm|mm|mhm|mmm|uh|um)\b"
        )
        self.replacers = {
            # contractions
            r"\bwon't\b": "will not",
            r"\bcan't\b": "can not",
            r"\blet's\b": "let us",
            r"\bain't\b": "aint",
            r"\by'all\b": "you all",
            r"\bwanna\b": "want to",
            r"\bgotta\b": "got to",
            r"\bgonna\b": "going to",
            r"\bi'ma\b": "i am going to",
            r"\bimma\b": "i am going to",
            r"\bwoulda\b": "would have",
            r"\bcoulda\b": "could have",
            r"\bshoulda\b": "should have",
            r"\bma'am\b": "madam",
            # contractions in titles/prefixes
            r"\bmr\b": "mister ",
            r"\bmrs\b": "missus ",
            r"\bst\b": "saint ",
            r"\bdr\b": "doctor ",
            r"\bprof\b": "professor ",
            r"\bcapt\b": "captain ",
            r"\bgov\b": "governor ",
            r"\bald\b": "alderman ",
            r"\bgen\b": "general ",
            r"\bsen\b": "senator ",
            r"\brep\b": "representative ",
            r"\bpres\b": "president ",
            r"\brev\b": "reverend ",
            r"\bhon\b": "honorable ",
            r"\basst\b": "assistant ",
            r"\bassoc\b": "associate ",
            r"\blt\b": "lieutenant ",
            r"\bcol\b": "colonel ",
            r"\bjr\b": "junior ",
            r"\bsr\b": "senior ",
            r"\besq\b": "esquire ",
            # general suffixes
            r"'d been\b": " had been",
            r"'s been\b": " has been",
            r"'d gone\b": " had gone",
            r"'s gone\b": " has gone",
            r"'d done\b": " had done",
            r"'s got\b": " has got",
            # standard contraction suffixes
            r"n't\b": " not",
            r"'re\b": " are",
            r"'s\b": " is",
            r"'d\b": " would",
            r"'ll\b": " will",
            r"'t\b": " not",
            r"'ve\b": " have",
            r"'m\b": " am",
        }

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)
        s = re.sub(r"\(([^)]+?)\)", "", s)
        s = re.sub(self.ignore_patterns, "", s)
        s = re.sub(r"\s+'", "'", s)  # space before apostrophe
        for pattern, replacement in self.replacers.items():
            s = re.sub(pattern, replacement, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)  # digit-group commas
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)  # periods not in numbers
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")
        s = self.number_normalizer(s)
        if self.spelling:
            s = " ".join(self.spelling.get(w, w) for w in s.split())
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)  # symbols not touching digits
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        s = re.sub(r"\s+", " ", s)
        return s.strip()


def ja_post_normalize(s: str) -> str:
    """ja eval post-rule (run_short_form_eval.py:202, exact literal
    replaces): strip all spaces, then `。.` -> `。`."""
    return s.replace(" ", "").replace("。.", "。")


def make_normalizer(lang: str, spelling: Mapping[str, str] | None = None):
    """Language-dispatched normalize fn (run_short_form_eval.py:196-206)."""
    if lang == "en":
        en = EnglishTextNormalizer(spelling)
        return lambda x: en(x)
    basic = BasicTextNormalizer()
    if lang == "ja":
        return lambda x: ja_post_normalize(basic(x))
    return lambda x: basic(x)
