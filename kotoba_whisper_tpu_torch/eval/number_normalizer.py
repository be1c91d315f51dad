"""English number verbalization -> digits, for eval-text normalization.

The Whisper English normalizer rewrites spelled-out numbers to digit form
so WER doesn't penalize verbalization differences. This is a from-scratch
state machine matching the observable behavior of the reference stack's
normalizer on ASR-typical constructs (validated in
tests/test_number_normalizer.py):

  - cardinals with group concatenation ("nineteen eighty four" -> 1984,
    "one two three" -> 123) and additive merge ("twenty one" -> 21,
    "one hundred and twenty three" -> 123);
  - lone "one"/"ones" stay literal (pronoun ambiguity);
  - "oh"/"zero" digit sequences ("oh seven" -> 07, "zero zero seven" -> 007)
    and "double"/"triple" repetition;
  - decimals ("three point one four" -> 3.14, "point five" -> .5);
  - ordinals ("twentieth" -> 20th, "twenty first" -> 21st);
  - currency/percent suffix words ("twenty dollars" -> $20,
    "fifty cents" -> ¢50, "ten percent" -> 10%);
  - "minus"/"negative" prefixes;
  - plural/possessive suffixes ("sixties" -> 60s).

Rare constructs (roman numerals, spelled fractions) pass through verbatim —
they affect hypothesis and reference equally.
"""
from __future__ import annotations

ONES = {
    "one": 1, "two": 2, "three": 3, "four": 4, "five": 5, "six": 6,
    "seven": 7, "eight": 8, "nine": 9,
}
TEENS = {
    "ten": 10, "eleven": 11, "twelve": 12, "thirteen": 13, "fourteen": 14,
    "fifteen": 15, "sixteen": 16, "seventeen": 17, "eighteen": 18,
    "nineteen": 19,
}
TENS = {
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
    "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90,
}
MULTIPLIERS = {
    "hundred": 100, "thousand": 10**3, "million": 10**6,
    "billion": 10**9, "trillion": 10**12,
}
ORDINALS = {
    "first": 1, "second": 2, "third": 3, "fourth": 4, "fifth": 5,
    "sixth": 6, "seventh": 7, "eighth": 8, "ninth": 9, "tenth": 10,
    "eleventh": 11, "twelfth": 12, "thirteenth": 13, "fourteenth": 14,
    "fifteenth": 15, "sixteenth": 16, "seventeenth": 17, "eighteenth": 18,
    "nineteenth": 19, "twentieth": 20, "thirtieth": 30, "fortieth": 40,
    "fiftieth": 50, "sixtieth": 60, "seventieth": 70, "eightieth": 80,
    "ninetieth": 90, "hundredth": 100, "thousandth": 10**3,
    "millionth": 10**6,
}
SUFFIX_CURRENCY = {"dollar": "$", "dollars": "$", "pound": "£", "pounds": "£"}
SUFFIX_CENTS = {"cent": "¢", "cents": "¢"}
DIGIT_WORDS = {**{w: v for w, v in ONES.items()}, "zero": 0, "oh": 0, "o": 0}
NEGATIVES = {"minus", "negative"}


def _ordinal_suffix(n: int) -> str:
    if 10 <= n % 100 <= 20:
        return "th"
    return {1: "st", 2: "nd", 3: "rd"}.get(n % 10, "th")




class _Group:
    """One spoken number group being assembled."""

    def __init__(self):
        self.text = ""           # digit string so far (concat semantics)
        self.val = None          # arithmetic accumulator (int) or None
        self.big = 0             # completed multiplier total
        self.ordinal = None      # ordinal value if the group ended ordinal
        self.literal_one = False
        self.negative = False
        self.decimal = ""
        self.slot_open = False   # trailing 0 came from a tens word

    def started(self):
        return self.text != "" or self.val is not None or self.big > 0

    def merge_value(self, v: int, width: int):
        """Merge a sub-group of magnitude `width` (10 or 100 for tens/teens,
        10 for ones) using add-if-slot-empty else concatenate."""
        if self.val is None:
            if self.text:
                if width == 10 and self.slot_open and self.text.endswith("0"):
                    # fill the tens slot: "nineteen eighty" + "four" -> 1984
                    self.text = self.text[:-1] + str(v)
                else:
                    # concat mode continues ("one two" -> 12, "zero zero
                    # seven" -> 007)
                    self.text += str(v).zfill(len(str(width - 1)))
                self.slot_open = width == 100 and v % 10 == 0 and v >= 20
            else:
                self.val = v
                self.slot_open = False
            return
        if self.val % width == 0:
            # slot available: add ("twenty"+1, "hundred"+20)
            self.val += v
            self.slot_open = False
        else:
            # concat ("nineteen"+"eighty" -> 19|80, "one"+"two" -> 1|2)
            self.text = str(self.val) + str(v).zfill(len(str(width - 1)))
            self.val = None
            self.slot_open = width == 100 and v % 10 == 0 and v >= 20

    def apply_multiplier(self, m: int):
        base = self.val if self.val is not None else (int(self.text) if self.text else 1)
        self.text = ""
        if m == 100:
            self.val = base * 100
        else:
            self.big += base * m
            self.val = None

    def flush_int(self):
        v = self.big + (self.val or 0)
        if self.text:
            return self.text if not v else str(v) + self.text
        return str(v)

    def render(self, prefix="", suffix=""):
        if self.literal_one and not self.decimal and not suffix and not prefix:
            return "one"
        if self.literal_one:
            body = "one"
        elif not (self.text or self.val is not None or self.big):
            body = ""           # decimal-only group: "point five" -> ".5"
        else:
            body = self.flush_int()
        if self.decimal:
            body += "." + self.decimal
        if self.ordinal is not None:
            body += _ordinal_suffix(self.ordinal)
        out = prefix + body + suffix
        if self.negative:
            out = "-" + out
        return out


class EnglishNumberNormalizer:
    def __call__(self, text: str) -> str:
        words = text.split()
        out: list[str] = []
        i = 0
        n = len(words)
        while i < n:
            rendered, j = self._parse(words, i)
            if rendered is None:
                out.append(words[i])
                i += 1
            else:
                out.append(rendered)
                i = j
        return " ".join(out)

    # ------------------------------------------------------------------
    def _split_suffix(self, w: str) -> tuple[str, str]:
        if w.endswith("'s"):
            return w[:-2], "'s"
        return w, ""

    def _parse(self, words, i):
        g = _Group()
        j = i
        n = len(words)
        prefix = ""
        suffix = ""
        last_was_mult = False
        digit_concat_only = True  # group built purely from single digits/oh

        if words[j] in NEGATIVES and j + 1 < n:
            w_next, _ = self._split_suffix(words[j + 1])
            if self._is_number_word(w_next):
                g.negative = True
                j += 1

        start_j = j
        while j < n:
            raw = words[j]
            w, poss = self._split_suffix(raw)
            plural = ""
            if not poss and w.endswith("ies") and w[:-3] + "y" in TENS:
                w, plural = w[:-3] + "y", "s"   # "sixties" -> sixty + s
            elif not poss and len(w) > 1 and w.endswith("s") and (
                w[:-1] in TENS or w[:-1] in TEENS or w[:-1] in MULTIPLIERS
                or w[:-1] in ONES or w[:-1] == "zero"
            ):
                w, plural = w[:-1], "s"
                if w == "one":
                    # "ones" literal
                    if not g.started():
                        return None, i
                    break

            if w in ("oh", "o", "zero"):
                if w in ("oh", "o") and not g.started() and (
                    j + 1 >= n or not self._is_number_word(
                        self._split_suffix(words[j + 1])[0]
                    )
                ):
                    break  # lone "oh" is an interjection
                g.text += "0" if not (g.val is not None) else ""
                if g.val is not None:
                    g.text = str(g.big + g.val) + "0"
                    g.val = None
                    g.big = 0
                j += 1
                if plural or poss:
                    suffix = plural + poss
                    break
                continue

            if w in ("double", "triple") and j + 1 < n:
                nxt, _ = self._split_suffix(words[j + 1])
                d = None
                if nxt in ("oh", "o", "zero"):
                    d = "0"
                elif nxt in ONES:
                    d = str(ONES[nxt])
                if d is not None:
                    reps = 2 if w == "double" else 3
                    if g.val is not None:
                        g.text = str(g.big + g.val)
                        g.val = None
                        g.big = 0
                    g.text += d * reps
                    j += 2
                    continue
                break

            if w in ONES:
                before = g.started()
                if g.val is None and g.text == "" and w == "one":
                    # candidate literal "one": decided at group end
                    g.literal_one = True
                g.merge_value(ONES[w], 10)
                if w != "one" or before or (
                    j + 1 < n and self._is_number_continuer(words, j + 1)
                ):
                    g.literal_one = False
                digit_concat_only = digit_concat_only and True
                j += 1
                last_was_mult = False
                if plural or poss:
                    suffix = plural + poss
                    break
                continue

            if w in TEENS:
                g.literal_one = False
                g.merge_value(TEENS[w], 100)
                digit_concat_only = False
                j += 1
                last_was_mult = False
                if plural or poss:
                    suffix = plural + poss
                    break
                continue

            if w in TENS:
                g.literal_one = False
                g.merge_value(TENS[w], 100)
                digit_concat_only = False
                j += 1
                last_was_mult = False
                if plural or poss:
                    suffix = plural + poss
                    break
                continue

            if w in MULTIPLIERS:
                g.literal_one = False
                g.apply_multiplier(MULTIPLIERS[w])
                digit_concat_only = False
                j += 1
                last_was_mult = True
                if plural or poss:
                    suffix = plural + poss
                    break
                continue

            if w == "and" and last_was_mult and j + 1 < n:
                nxt, _ = self._split_suffix(words[j + 1])
                if self._is_number_word(nxt) and nxt not in MULTIPLIERS:
                    j += 1
                    continue
                break

            if w == "point" and (g.started() or (
                j + 1 < n and self._split_suffix(words[j + 1])[0] in DIGIT_WORDS
            )):
                k = j + 1
                dec = ""
                while k < n:
                    dw, dposs = self._split_suffix(words[k])
                    if dw in DIGIT_WORDS:
                        dec += str(DIGIT_WORDS[dw])
                        k += 1
                        if dposs:
                            break
                    else:
                        break
                if dec:
                    g.decimal = dec
                    j = k
                break

            if w in ORDINALS:
                v = ORDINALS[w]
                g.literal_one = False
                if g.started():
                    if g.val is not None and v < 100:
                        g.val += v
                        g.ordinal = g.big + g.val
                    elif v >= 100:
                        g.apply_multiplier(v)
                        g.ordinal = g.big + (g.val or 0)
                    else:
                        g.merge_value(v, 10)
                        g.ordinal = int(g.flush_int())
                else:
                    g.val = v
                    g.ordinal = v
                j += 1
                suffix = poss
                break

            if g.started():
                if w == "percent":
                    suffix = "%" + poss
                    j += 1
                    break
                if w in SUFFIX_CURRENCY:
                    prefix = SUFFIX_CURRENCY[w]
                    suffix = poss
                    j += 1
                    break
                if w in SUFFIX_CENTS:
                    prefix = SUFFIX_CENTS[w]
                    suffix = poss
                    j += 1
                    break
            break

        if j == start_j or not (g.started() or g.decimal):
            return None, i
        return g.render(prefix, suffix), j

    def _is_number_word(self, w: str) -> bool:
        return (
            w in ONES or w in TEENS or w in TENS or w in MULTIPLIERS
            or w in ("oh", "o", "zero", "point") or w in ORDINALS
        )

    def _is_number_continuer(self, words, k) -> bool:
        w, _ = self._split_suffix(words[k])
        if len(w) > 1 and w.endswith("s") and w[:-1] in MULTIPLIERS:
            return True
        return w in ONES or w in TEENS or w in TENS or w in MULTIPLIERS or w in (
            "oh", "o", "zero"
        )
