"""Punctuation-restoration add-on (kotoba-whisper v1.1/v2.1 pipelines).

Counterpart of misc/whisper_add_on/punctuator.py: the reference wraps the
`punctuators` ONNX multilingual punctuation model (`pcs_47lang`) and
applies it per pipeline chunk through `validate_punctuation` (:17-26).
Here:

- `validate_punctuation` reproduces the reference's guard EXACTLY: reject
  model outputs containing 'unk'; collapse multiple 。 to a single one at
  the LAST position.
- The model is pluggable. `Punctuator.from_onnx()` loads the reference's
  actual ONNX model when the optional `punctuators` package is present
  (not on the training hot path, so an optional CPU dependency is
  acceptable — same call shape as punctuator.py:10-11).
  `RuleBasedJaPunctuator` is the dependency-free default (sentence-final
  。 insertion), kept behind an extra same-text-modulo-punctuation guard
  so a rule misfire can never alter the transcript content.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

PUNCT_CHARS = "。、．，!?！？.,"
JA_PUNCTUATIONS = ["!", "?", "、", "。"]  # punctuator.py:8


def strip_punct(s: str) -> str:
    return "".join(c for c in s if c not in PUNCT_CHARS)


def validate_punctuation(raw: str, punctuated: str) -> str:
    """Exact port of the reference's guard (punctuator.py:17-26): keep the
    raw text when the model emitted an 'unk' marker; when several 。
    appear, keep only the last one (at its original position)."""
    if "unk" in punctuated:
        return raw
    if punctuated.count("。") > 1:
        ind = punctuated.rfind("。")
        punctuated = punctuated.replace("。", "")
        punctuated = punctuated[: ind] + "。" + punctuated[ind:]
    return punctuated


@dataclass
class RuleBasedJaPunctuator:
    """Minimal default: append 。 to chunk-final text lacking terminal
    punctuation."""

    def __call__(self, texts: Sequence[str]) -> list[str]:
        out = []
        for t in texts:
            t2 = t.rstrip()
            if t2 and t2[-1] not in PUNCT_CHARS:
                t2 = t2 + "。"
            out.append(t2)
        return out


@dataclass
class Punctuator:
    punctuate_fn: Callable[[Sequence[str]], list[str]] = field(
        default_factory=RuleBasedJaPunctuator
    )
    # the rule-based default gets the extra modulo-punctuation guard; a
    # real model reproduces the reference behavior (validation only)
    guard_content: bool = True

    @classmethod
    def from_onnx(cls, model: str = "pcs_47lang") -> "Punctuator":
        """Load the reference's ONNX punctuation model
        (punctuator.py:10-11). Requires the optional `punctuators`
        package (ONNX-CPU); raises ImportError with guidance otherwise."""
        try:
            from punctuators.models import PunctCapSegModelONNX
        except ImportError as e:  # pragma: no cover - optional dep
            raise ImportError(
                "the ONNX punctuator needs the optional `punctuators` "
                "package (pip install punctuators); the rule-based "
                "default Punctuator() runs without it"
            ) from e
        m = PunctCapSegModelONNX.from_pretrained(model)

        def infer(texts: Sequence[str]) -> list[str]:
            return ["".join(e) for e in m.infer(list(texts))]

        return cls(punctuate_fn=infer, guard_content=False)

    @classmethod
    def default(cls) -> "Punctuator":
        """The v1.1/v2.1 eval default: the reference's real ONNX model
        when the optional `punctuators` package is installed (connected
        hosts), else the rule-based stand-in with a loud warning — so
        out-of-the-box behavior matches the reference wherever the model
        is actually obtainable."""
        try:
            return cls.from_onnx()
        except ImportError:
            import sys

            print(
                "warning: `punctuators` package not installed — using the "
                "rule-based ja punctuator stand-in (install punctuators "
                "for the reference's pcs_47lang ONNX model)",
                file=sys.stderr,
            )
            return cls()

    def punctuate(self, chunks: list[dict]) -> list[dict]:
        """Apply to pipeline chunks with the reference's validation."""
        texts = [c["text"] for c in chunks]
        restored = self.punctuate_fn(texts)
        out = []
        for c, r in zip(chunks, restored):
            r = validate_punctuation(c["text"], r)
            if self.guard_content and strip_punct(r) != strip_punct(c["text"]):
                r = c["text"]
            out.append({**c, "text": r})
        return out
