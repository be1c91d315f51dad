"""SentencePiece "Precompiled" charsmap normalizer (NMT-NFKC et al).

NLLB's tokenizer.json serializes its normalizer as a `Precompiled` blob:
a darts-clone double-array trie over UTF-8 byte sequences plus a pool of
NUL-terminated replacement strings (sentencepiece
normalizer.cc::DecodePrecompiledCharsMap layout: [u32 LE trie byte size]
[trie units u32 LE][pool]). This module decodes and applies it natively,
closing the documented NFKC≈NMT_NFKC approximation in
tokenizer/unigram.py: control-char stripping and the NMT
compatibility mappings live in the charsmap, not in unicodedata.NFKC.

The normalization algorithm mirrors HF tokenizers' `spm_precompiled`
crate (the consumer our unigram engine is parity-tested against): the
text is walked in grapheme-ish chunks — here a base char plus its
combining extenders (categories Mn/Mc/Me), which covers the charsmap
entries NMT-NFKC actually contains (e.g. kana + U+3099 voicing marks) —
chunks shorter than 6 bytes are looked up whole first, then per-char,
unmatched chars pass through.

Darts-clone unit layout (darts.h): [31 value-flag | 30..10 offset |
9 offset-extend | 8 has_leaf | 7..0 label]; traversal XORs offsets.
`build_charsmap` constructs small valid blobs for golden tests against
tokenizers.normalizers.Precompiled (tests/test_charsmap.py), and the
port's copy against the JAX package's (tests/test_torch_unigram.py).

A copy of the JAX package's tokenizer/charsmap.py, which imports no JAX.
"""
from __future__ import annotations

import struct
import unicodedata

_COMBINING = ("Mn", "Mc", "Me")


class PrecompiledCharsmap:
    def __init__(self, blob: bytes):
        (trie_size,) = struct.unpack("<I", blob[:4])
        trie = blob[4 : 4 + trie_size]
        self.pool = blob[4 + trie_size :]
        n = len(trie) // 4
        self.units = struct.unpack(f"<{n}I", trie[: n * 4])

    @classmethod
    def from_base64(cls, b64: str) -> "PrecompiledCharsmap":
        import base64

        return cls(base64.b64decode(b64))

    # ---- darts-clone traversal ------------------------------------------

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def _common_prefix_search(self, key: bytes) -> list[tuple[int, int]]:
        """[(match_len, value)] in increasing length order."""
        units = self.units
        if not units:
            return []
        out = []
        node_pos = 0
        unit = units[node_pos]
        node_pos ^= self._offset(unit)
        for i, c in enumerate(key):
            node_pos ^= c
            if node_pos >= len(units):
                break
            unit = units[node_pos]
            if (unit & (0x80000000 | 0xFF)) != c:  # label mismatch
                break
            node_pos ^= self._offset(unit)
            if (unit >> 8) & 1:  # has_leaf
                out.append((i + 1, units[node_pos] & 0x7FFFFFFF))
        return out

    def _transform(self, chunk: bytes) -> bytes | None:
        """spm_precompiled `transform` semantics, quirk included: the
        FIRST (shortest) prefix match's replacement is returned and the
        caller consumes the WHOLE chunk — e.g. a <6-byte chunk of
        NBSP+combining-mark collapses to the NBSP's replacement, the
        mark swallowed. Matching the HF crate exactly is the point: it is
        the implementation NLLB fast tokenizers actually run."""
        hits = self._common_prefix_search(chunk)
        if not hits:
            return None
        value = hits[0][1]
        end = self.pool.index(b"\0", value)
        return self.pool[value:end]

    # ---- normalization ---------------------------------------------------

    @staticmethod
    def _chunks(text: str):
        """Base char + combining extenders (grapheme approximation)."""
        buf = ""
        for ch in text:
            if buf and unicodedata.category(ch) in _COMBINING:
                buf += ch
                continue
            if buf:
                yield buf
            buf = ch
        if buf:
            yield buf

    def normalize(self, text: str) -> str:
        out = []
        for chunk in self._chunks(text):
            b = chunk.encode("utf-8")
            if len(b) < 6:
                rep = self._transform(b)
                if rep is not None:
                    out.append(rep.decode("utf-8"))
                    continue
            for ch in chunk:
                rep = self._transform(ch.encode("utf-8"))
                out.append(ch if rep is None else rep.decode("utf-8"))
        return "".join(out)


# ---------------------------------------------------------------------------
# Tiny darts-clone builder (tests only — real blobs ship inside
# tokenizer.json; this exists so goldens can drive the REAL consumer,
# tokenizers.normalizers.Precompiled, on known mappings)
# ---------------------------------------------------------------------------


def build_charsmap(mapping: dict[str, str]) -> bytes:
    """mapping: source string -> replacement. Returns a Precompiled blob."""
    pool = bytearray()
    keys: list[tuple[bytes, int]] = []
    for src, dst in sorted(mapping.items()):
        value = len(pool)
        pool += dst.encode("utf-8") + b"\0"
        keys.append((src.encode("utf-8"), value))

    # byte trie
    class Node:
        __slots__ = ("children", "value")

        def __init__(self):
            self.children: dict[int, Node] = {}
            self.value: int | None = None

    root = Node()
    for kb, v in keys:
        n = root
        for c in kb:
            n = n.children.setdefault(c, Node())
        n.value = v

    units = [0] * 16
    used = [False] * 16
    used[0] = True

    def ensure(i):
        nonlocal units, used
        while i >= len(units):
            units.extend([0] * len(units))
            used.extend([False] * len(used))

    def place(node: Node, pos: int) -> None:
        labels = sorted(node.children)
        base = 1
        while True:
            slots = [base ^ c for c in labels]
            if node.value is not None:
                slots.append(base)
            ensure(max(slots, default=base))
            if all(not used[s] for s in slots):
                break
            base += 1
        off = pos ^ base
        assert off < (1 << 21), "builder supports small tries only"
        ensure(pos)
        units[pos] |= (off << 10) | (
            (1 << 8) if node.value is not None else 0
        )
        if node.value is not None:
            used[base] = True
            units[base] = 0x80000000 | node.value
        for c in labels:
            used[base ^ c] = True
            units[base ^ c] = c
        for c in labels:
            place(node.children[c], base ^ c)

    place(root, 0)
    trie = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie)) + trie + bytes(pool)
