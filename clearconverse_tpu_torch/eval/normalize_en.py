"""English text normalization with openai-whisper's documented semantics.

A copy of the JAX package's eval/normalize_en.py for the port (host code,
same rules, same ``CC_TPU_SPELLING_JSON`` asset variable).

WER scored for parity must measure MODEL differences, not normalizer
differences: the whisper eval convention normalizes
both reference and hypothesis through EnglishTextNormalizer before
alignment. This module reimplements those semantics from the documented
behavior (Radford et al. 2022, Appendix C; openai-whisper
``normalizers/english.py``'s published rule list) as first-party code:

  1. lowercase; remove bracketed/parenthesized asides;
  2. remove hesitation fillers (hmm/mm/mhm/mmm/uh/um);
  3. expand contractions ("won't" -> "will not", "'re" -> " are", ...)
     and standardize title abbreviations ("mr" -> "mister", ...);
  4. strip punctuation/symbols except numeric-bearing ones (.%$ and
     currency marks), drop commas inside numbers, and fold diacritics;
  5. write numbers as digits ("twenty-three" -> "23", "two point five"
     -> "2.5", "first" -> "1st", "fifty percent" -> "50%", "ten dollars"
     -> "$10", "$10 and fifty cents" -> "$10.50");
  6. standardize British spellings to American ("colour" -> "color");
  7. collapse whitespace.

The spelling step approximates whisper's (which ships a ~40k-entry
mapping file) with a curated dict of common stems plus regular
inflections — the right trade for a no-assets build; swap in the full
mapping file via ``EnglishSpellingNormalizer.from_file(path)`` (or the
``CC_TPU_SPELLING_JSON`` env var, picked up automatically) when one is
available. Everything else matches whisper's rules.
"""

from __future__ import annotations

import re
import unicodedata
from fractions import Fraction
from typing import Dict, Iterator, List, Optional


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Replace markers/symbols/punctuation with a space and drop
    diacritics (NFKD fold), keeping any characters in ``keep``."""
    out = []
    for c in unicodedata.normalize("NFKD", s):
        if c in keep:
            out.append(c)
            continue
        cat = unicodedata.category(c)
        if cat == "Mn":                   # combining mark: drop (fold accent)
            continue
        if cat[0] in "MSP":               # marks/symbols/punctuation: space
            out.append(" ")
            continue
        out.append(c)
    return "".join(out)


# ---------------------------------------------------------------------------
# number words


_ONES: Dict[str, int] = {
    w: i for i, w in enumerate(
        ["one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"],
        start=1)
}
_ONES_ORDINAL: Dict[str, int] = {
    "first": 1, "second": 2, "third": 3, "fifth": 5, "eighth": 8,
    "ninth": 9, "twelfth": 12,
}
for _w, _v in _ONES.items():
    if _w not in ("one", "two", "three", "five", "eight", "nine", "twelve"):
        _ONES_ORDINAL[_w + "th"] = _v

_TENS: Dict[str, int] = {"twenty": 20, "thirty": 30, "forty": 40,
                         "fifty": 50, "sixty": 60, "seventy": 70,
                         "eighty": 80, "ninety": 90}
_TENS_ORDINAL: Dict[str, int] = {w[:-1] + "ieth": v for w, v in _TENS.items()}

_MULTIPLIERS: Dict[str, int] = {
    "hundred": 100, "thousand": 1_000, "million": 1_000_000,
    "billion": 1_000_000_000, "trillion": 1_000_000_000_000,
}

_CURRENCY_WORDS = {"dollar": "$", "dollars": "$", "pound": "£",
                   "pounds": "£", "euro": "€", "euros": "€"}
_CENT_WORDS = {"cent", "cents"}


def _ordinal_suffix(value: int) -> str:
    if value % 100 in (11, 12, 13):
        return "th"
    return {1: "st", 2: "nd", 3: "rd"}.get(value % 10, "th")


class EnglishNumberNormalizer:
    """Convert spelled-out English numbers to digit strings.

    Handles cardinals to the trillions with "and" connectors, ordinals
    ("twenty first" -> "21st"), decimals ("three point one four" ->
    "3.14"), percent, currency words with dollars-and-cents folding
    ("ten dollars and fifty cents" -> "$10.50"), "double"/"triple" digit
    repetition, and "a hundred"-style indefinite articles. Unknown words
    pass through untouched."""

    def __call__(self, text: str) -> str:
        words = text.split()
        out = " ".join(self._convert(words))
        return self._postprocess(out)

    # -- tokenizer-level pass ------------------------------------------

    def _convert(self, words: List[str]) -> Iterator[str]:
        i = 0
        n = len(words)
        while i < n:
            value, j, suffix = self._parse_number(words, i)
            if value is None:
                yield words[i]
                i += 1
                continue
            yield str(value) + suffix
            i = j

    @staticmethod
    def _slot_open(current: int, v: int) -> bool:
        """Can a ones-value ``v`` (1-19) compose onto ``current``?
        Open after a multiplier ("one hundred FIVE"), or a tens word with
        a free units digit ("twenty THREE", v<10 only)."""
        if current == 0 or current % 100 == 0:
            return True
        r = current % 100
        return r % 10 == 0 and 20 <= r <= 90 and v < 10

    def _parse_number(self, words: List[str], i: int):
        """Parse the longest spelled number starting at ``words[i]``.
        Returns (value_string_or_None, next_index, suffix). ``suffix``
        carries an ordinal/percent marker ("st", "%", ...)."""
        n = len(words)
        total = 0          # completed thousands groups
        current = 0        # the group being built (can reach 9900: "ninety
        #                    nine hundred")
        started = False
        ordinal: Optional[int] = None
        j = i
        # leading indefinite article: "a hundred", "a million"
        if (words[j] in ("a", "an") and j + 1 < n
                and words[j + 1] in _MULTIPLIERS):
            current = 1
            started = True
            j += 1
        elif words[j] == "zero":
            # "zero" starts a number only as a decimal lead ("zero point
            # five" -> 0.5); anything else ends it at 0 immediately —
            # "zero five" is digit dictation, not composition.
            j += 1
            if j < n and words[j] == "point":
                started = True             # loop entry hits the point branch
            elif j < n and words[j] == "percent":
                return ("0", j + 1, "%")
            else:
                return ("0", j, "")
        while j < n and ordinal is None:
            w = words[j]
            if w in _ONES:
                if not self._slot_open(current, _ONES[w]):
                    break
                current += _ONES[w]
                started = True
                j += 1
            elif w in _TENS:
                if current % 100 != 0:
                    break
                current += _TENS[w]
                started = True
                j += 1
            elif w in _ONES_ORDINAL:
                if not self._slot_open(current, _ONES_ORDINAL[w]):
                    break
                ordinal = current + _ONES_ORDINAL[w]
                started = True
                j += 1
            elif w in _TENS_ORDINAL:
                if current % 100 != 0:
                    break
                ordinal = current + _TENS_ORDINAL[w]
                started = True
                j += 1
            elif w == "hundredth" and started and 0 < current < 10:
                ordinal = current * 100
                j += 1
            elif w in ("thousandth", "millionth", "billionth",
                       "trillionth") and started:
                mult = _MULTIPLIERS[w[:-2]]
                ordinal = (total + max(current, 1)) * mult
                total = 0
                j += 1
            elif w in _MULTIPLIERS:
                if not started:
                    break                  # bare "hundred"/"thousand"
                mult = _MULTIPLIERS[w]
                if mult == 100:
                    # "three hundred" -> 300; "nineteen hundred" -> 1900;
                    # a filled hundreds place ("one hundred hundred") stops.
                    if current % 100 == 0 or current >= 1000:
                        break
                    current = ((current % 100) * 100
                               + (current - current % 100))
                else:
                    total += max(current, 1) * mult
                    current = 0
                j += 1
            elif w == "and" and started and j + 1 < n and (
                    words[j + 1] in _ONES or words[j + 1] in _TENS
                    or words[j + 1] in _ONES_ORDINAL
                    or words[j + 1] in _TENS_ORDINAL) and (
                        current % 100 == 0 and (current or total)):
                j += 1                     # "one hundred AND five"
            elif w == "point" and started and j + 1 < n and (
                    words[j + 1] in _ONES and _ONES[words[j + 1]] < 10
                    or words[j + 1] in ("zero", "oh")):
                # Decimal digits are single cardinals only — the guard must
                # match the collection loop (teens like "fifteen" are NOT
                # decimal digits; "three point fifteen" -> "3 point 15"
                # would otherwise emit a dangling "3.").
                digits = []
                k = j + 1
                while k < n and (words[k] in _ONES and _ONES[words[k]] < 10
                                 or words[k] in ("zero", "oh")):
                    digits.append("0" if words[k] in ("zero", "oh")
                                  else str(_ONES[words[k]]))
                    k += 1
                val = f"{total + current}." + "".join(digits)
                # Spelled decimals take the same trailing-percent attach as
                # integers ("two point five percent" -> "2.5%"); currency
                # words are handled by _postprocess on the digit form.
                if k < n and words[k] == "percent":
                    return (val, k + 1, "%")
                return (val, k, "")
            else:
                break
        if not started:
            # standalone zero / oh-as-zero is ambiguous; convert "zero"
            if i < n and words[i] == "zero":
                return ("0", i + 1, "")
            # double/triple digit dictation
            if i < n and words[i] in ("double", "triple") and i + 1 < n:
                nxt = words[i + 1]
                digit = ("0" if nxt in ("zero", "oh")
                         else str(_ONES[nxt]) if nxt in _ONES
                         and _ONES[nxt] < 10 else None)
                if digit is not None:
                    reps = 2 if words[i] == "double" else 3
                    return (digit * reps, i + 2, "")
            return (None, i, "")
        value = total + (ordinal if ordinal is not None else current)
        suffix = ""
        if ordinal is not None:
            suffix = _ordinal_suffix(value)
        # percent / currency attach as trailing words
        if j < n and words[j] == "percent" and ordinal is None:
            return (str(value), j + 1, "%")
        return (str(value), j, suffix)

    # -- phrase-level cleanup ------------------------------------------

    @staticmethod
    def _postprocess(s: str) -> str:
        # "[N] dollars" -> "$N"; same for pounds/euros; "[N] cents" -> "¢N"
        for word, sym in _CURRENCY_WORDS.items():
            s = re.sub(rf"\b(\d+(?:\.\d+)?) {word}\b",
                       lambda m, sym=sym: f"{sym}{m.group(1)}", s)
        s = re.sub(r"\b(\d+) cents?\b", r"¢\1", s)
        # "$10 and ¢50" -> "$10.50"
        s = re.sub(r"([$£€])(\d+) and ¢(\d{1,2})\b",
                   lambda m: f"{m.group(1)}{m.group(2)}."
                             f"{int(m.group(3)):02d}", s)
        # "1 half" -> "1/2" style simple fractions
        s = re.sub(r"\b(\d+) half\b",
                   lambda m: str(Fraction(int(m.group(1)), 2))
                   if int(m.group(1)) % 2 else str(int(m.group(1)) // 2), s)
        return s


class EnglishSpellingNormalizer:
    """British -> American spelling. Whisper ships a ~40k-entry mapping
    file; this no-assets build curates the common stems and derives the
    regular inflections (plural, -s/-d/-ing where applicable). Pass a
    full mapping via ``extra`` to override/extend."""

    _OUR = ["colour", "favour", "flavour", "honour", "labour", "neighbour",
            "behaviour", "humour", "rumour", "armour", "harbour", "odour",
            "parlour", "saviour", "splendour", "vigour", "valour",
            "endeavour", "demeanour", "glamour"]
    _RE = ["centre", "theatre", "metre", "litre", "fibre", "calibre",
           "sombre", "lustre", "spectre", "manoeuvre", "meagre", "sabre"]
    _ISE = ["organise", "realise", "recognise", "apologise", "criticise",
            "emphasise", "minimise", "maximise", "optimise", "summarise",
            "memorise", "categorise", "authorise", "capitalise",
            "characterise", "civilise", "colonise", "customise",
            "economise", "equalise", "familiarise", "finalise",
            "generalise", "harmonise", "hospitalise", "idealise",
            "initialise", "italicise", "legalise", "localise", "mobilise",
            "modernise", "neutralise", "normalise", "patronise",
            "penalise", "personalise", "popularise", "prioritise",
            "publicise", "randomise", "rationalise", "specialise",
            "stabilise", "standardise", "sterilise", "subsidise",
            "symbolise", "sympathise", "synchronise", "synthesise",
            "theorise", "utilise", "visualise", "vocalise", "vandalise",
            "serialise", "satirise", "scrutinise", "socialise", "stylise",
            "terrorise", "tranquillise", "trivialise", "urbanise",
            "victimise", "westernise", "baptise", "dramatise", "energise",
            "fantasise", "fertilise", "galvanise", "globalise",
            "immunise", "itemise", "jeopardise",
            "magnetise", "mechanise", "monopolise", "moralise",
            "naturalise", "oxidise",
            "plagiarise", "pulverise", "revolutionise", "romanticise"]
    _YSE = ["analyse", "paralyse", "catalyse", "breathalyse"]
    # -ogue -> -og (the tysto list whisper's mapping derives from folds
    # the whole family, not just catalog/dialog/analog).
    _OGUE = ["catalogue", "dialogue", "analogue", "monologue", "epilogue",
             "prologue", "travelogue", "demagogue", "pedagogue",
             "synagogue"]
    _PAIRS = {
        "defence": "defense", "offence": "offense", "pretence": "pretense",
        "licence": "license", "practise": "practice",
        "grey": "gray", "greyish": "grayish",
        "programme": "program", "programmes": "programs",
        "tyre": "tire", "tyres": "tires", "kerb": "curb", "kerbs": "curbs",
        "plough": "plow", "ploughs": "plows", "mould": "mold",
        "moulds": "molds", "moulding": "molding", "smoulder": "smolder",
        "ageing": "aging", "judgement": "judgment",
        "judgements": "judgments", "acknowledgement": "acknowledgment",
        "acknowledgements": "acknowledgments", "aeroplane": "airplane",
        "aeroplanes": "airplanes", "aluminium": "aluminum",
        "cheque": "check", "cheques": "checks", "draught": "draft",
        "draughts": "drafts", "gaol": "jail", "pyjamas": "pajamas",
        "sceptic": "skeptic", "sceptical": "skeptical", "storey": "story",
        "storeys": "stories", "jewellery": "jewelry",
        "marvellous": "marvelous", "travelled": "traveled",
        "travelling": "traveling", "traveller": "traveler",
        "travellers": "travelers", "cancelled": "canceled",
        "cancelling": "canceling", "labelled": "labeled",
        "labelling": "labeling", "modelled": "modeled",
        "modelling": "modeling", "signalled": "signaled",
        "signalling": "signaling", "fuelled": "fueled",
        "fuelling": "fueling", "quarrelled": "quarreled",
        "counselled": "counseled", "counselling": "counseling",
        "counsellor": "counselor", "counsellors": "counselors",
        "woollen": "woolen", "enrol": "enroll", "enrolment": "enrollment",
        "fulfil": "fulfill", "fulfilment": "fulfillment",
        "instalment": "installment", "instalments": "installments",
        "skilful": "skillful", "wilful": "willful",
        "distil": "distill", "instil": "instill",
        "tonne": "ton", "tonnes": "tons",
        "whilst": "while", "amongst": "among", "amidst": "amid",
        "learnt": "learned", "burnt": "burned", "dreamt": "dreamed",
        "spelt": "spelled", "spoilt": "spoiled", "leapt": "leaped",
        "mum": "mom", "mums": "moms", "arse": "ass",
    }

    def __init__(self, extra: Optional[Dict[str, str]] = None):
        m: Dict[str, str] = {}
        for w in self._OUR:                       # colour -> color (+forms)
            a = w[:-3] + "or"
            m[w] = a
            m[w + "s"] = a + "s"
            m[w + "ed"] = a + "ed"
            m[w + "ing"] = a + "ing"
            m[w[:-3] + "ourite"] = a + "ite"      # favourite -> favorite
            m[w[:-3] + "ourites"] = a + "ites"
            m[w[:-3] + "ourable"] = a + "able"    # honourable -> honorable
        for w in self._RE:                        # centre -> center (+forms)
            a = w[:-2] + "er"
            m[w] = a
            m[w + "s"] = a + "s"
            m[w + "d"] = w[:-2] + "ered"
        for w in self._ISE:                       # organise -> organize
            a = w[:-3] + "ize"
            m[w] = a
            m[w + "s"] = a + "s"
            m[w + "d"] = a + "d"
            m[w[:-1] + "ing"] = a[:-1] + "ing"
            m[w[:-3] + "isation"] = w[:-3] + "ization"
            m[w[:-3] + "isations"] = w[:-3] + "izations"
            m[w[:-1] + "er"] = a[:-1] + "er"
        for w in self._YSE:                       # analyse -> analyze
            a = w[:-3] + "yze"
            m[w] = a
            m[w + "s"] = a + "s"
            m[w + "d"] = a + "d"
            m[w[:-1] + "ing"] = a[:-1] + "ing"
        for w in self._OGUE:                      # monologue -> monolog
            a = w[:-2]
            m[w] = a
            m[w + "s"] = a + "s"
        m.update(self._PAIRS)
        if extra:
            m.update(extra)
        self.mapping = m

    @classmethod
    def from_file(cls, path: str) -> "EnglishSpellingNormalizer":
        """Load whisper's real mapping asset (``normalizers/english.json``,
        a flat ``{"british": "american"}`` JSON dict, ~40k entries) on top
        of the curated base — the drop-in path for when the public file
        is at hand."""
        import json
        with open(path, encoding="utf-8") as fh:
            extra = json.load(fh)
        if not isinstance(extra, dict) or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in extra.items()):
            raise ValueError(f"{path}: expected a flat str->str JSON dict")
        return cls(extra=extra)

    def __call__(self, text: str) -> str:
        return " ".join(self.mapping.get(w, w) for w in text.split())


class EnglishTextNormalizer:
    """The full whisper-convention normalization pipeline (module doc)."""

    _IGNORE = re.compile(r"\b(hmm|mm|mhm|mmm|uh|um)\b")
    # Order matters: specific contractions before the generic suffix rules.
    _REPLACERS = [
        (re.compile(r"\bwon't\b"), "will not"),
        (re.compile(r"\bcan't\b"), "can not"),
        (re.compile(r"\blet's\b"), "let us"),
        (re.compile(r"\bain't\b"), "aint"),
        (re.compile(r"\by'all\b"), "you all"),
        (re.compile(r"\bwanna\b"), "want to"),
        (re.compile(r"\bgotta\b"), "got to"),
        (re.compile(r"\bgonna\b"), "going to"),
        (re.compile(r"\bi'ma\b"), "i am going to"),
        (re.compile(r"\bimma\b"), "i am going to"),
        (re.compile(r"\bwoulda\b"), "would have"),
        (re.compile(r"\bcoulda\b"), "could have"),
        (re.compile(r"\bshoulda\b"), "should have"),
        (re.compile(r"\bma'am\b"), "madam"),
        (re.compile(r"\bmr\b"), "mister "),
        (re.compile(r"\bmrs\b"), "missus "),
        (re.compile(r"\bst\b"), "saint "),
        (re.compile(r"\bdr\b"), "doctor "),
        (re.compile(r"\bprof\b"), "professor "),
        (re.compile(r"\bcapt\b"), "captain "),
        (re.compile(r"\bgov\b"), "governor "),
        (re.compile(r"\bald\b"), "alderman "),
        (re.compile(r"\bgen\b"), "general "),
        (re.compile(r"\bsen\b"), "senator "),
        (re.compile(r"\brep\b"), "representative "),
        (re.compile(r"\bpres\b"), "president "),
        (re.compile(r"\brev\b"), "reverend "),
        (re.compile(r"\bhon\b"), "honorable "),
        (re.compile(r"\basst\b"), "assistant "),
        (re.compile(r"\bassoc\b"), "associate "),
        (re.compile(r"\blt\b"), "lieutenant "),
        (re.compile(r"\bcol\b"), "colonel "),
        (re.compile(r"\bjr\b"), "junior "),
        (re.compile(r"\bsr\b"), "senior "),
        (re.compile(r"\besq\b"), "esquire "),
        (re.compile(r"'d been\b"), " had been"),
        (re.compile(r"'s been\b"), " has been"),
        (re.compile(r"'d gone\b"), " had gone"),
        (re.compile(r"'s gone\b"), " has gone"),
        (re.compile(r"'d done\b"), " had done"),
        (re.compile(r"'s got\b"), " has got"),
        (re.compile(r"n't\b"), " not"),
        (re.compile(r"'re\b"), " are"),
        (re.compile(r"'s\b"), " is"),
        (re.compile(r"'d\b"), " would"),
        (re.compile(r"'ll\b"), " will"),
        (re.compile(r"'t\b"), " not"),
        (re.compile(r"'ve\b"), " have"),
        (re.compile(r"'m\b"), " am"),
    ]

    def __init__(self,
                 spelling: Optional[EnglishSpellingNormalizer] = None):
        self.numbers = EnglishNumberNormalizer()
        if spelling is None:
            # Zero-code-change drop-in for whisper's full english.json
            # mapping the moment the asset exists. A SET-but-missing path
            # fails loudly: silently falling back to the curated base would
            # score a parity sign-off under the wrong normalizer with no
            # warning.
            import os
            asset = os.environ.get("CC_TPU_SPELLING_JSON", "")
            if asset and not os.path.exists(asset):
                raise FileNotFoundError(
                    f"CC_TPU_SPELLING_JSON={asset!r} does not exist — "
                    "unset it or point it at whisper's english.json")
            spelling = (EnglishSpellingNormalizer.from_file(asset)
                        if asset else EnglishSpellingNormalizer())
        self.spelling = spelling

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)   # bracketed asides
        s = re.sub(r"\(([^)]+?)\)", "", s)        # parenthesized asides
        s = self._IGNORE.sub("", s)
        s = re.sub(r"\s+'", "'", s)               # "they 're" -> "they're"
        for pat, rep in self._REPLACERS:
            s = pat.sub(rep, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)      # 1,000 -> 1000
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)    # periods not in numbers
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")
        s = self.numbers(s)
        s = self.spelling(s)
        # symbols that survived only matter adjacent to digits
        s = re.sub(r"[.$¢€£]([^0-9]|$)", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        s = re.sub(r"\s+", " ", s)
        return s.strip()
