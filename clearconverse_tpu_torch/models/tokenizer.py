"""Whisper text tokenizer: GPT-2 byte-level BPE + whisper special-token
layout.

The reference gets this from openai-whisper/tiktoken (via
``model.transcribe``); here the BPE is first-party. Vocabulary files are
loaded from a model directory when present (HF ``vocab.json``+``merges.txt``
or tiktoken ``*.tiktoken`` base64 rank files). Without vocab files a
byte-fallback tokenizer keeps the full pipeline runnable (tests, benches) —
token ids then have no linguistic meaning but all shapes/specials hold.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

# Languages count fixes the special-token layout (whisper's table).
# large-v3-family models add "yue" for 100 and shift later specials by one.
_N_LANGUAGES = 99

# whisper's canonical language order: the language token for code c is
# sot + 1 + WHISPER_LANGUAGES.index(c).
WHISPER_LANGUAGES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
)


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    """Special-token ids. English-only layout (vocab 51864): eot 50256,
    sot 50257, langs 50258-50356, translate 50357, transcribe 50358,
    sot_lm 50359, sot_prev 50360, no_speech 50361, no_timestamps 50362,
    timestamps 50363-51863. Multilingual layout is shifted by +1."""

    eot: int
    sot: int
    translate: int
    transcribe: int
    sot_lm: int
    sot_prev: int
    no_speech: int
    no_timestamps: int
    timestamp_begin: int
    n_vocab: int

    @staticmethod
    def for_model(english: bool = True,
                  n_languages: int = _N_LANGUAGES) -> "SpecialTokens":
        eot = 50256 if english else 50257
        sot = eot + 1
        translate = sot + 1 + n_languages
        return SpecialTokens(
            eot=eot, sot=sot, translate=translate, transcribe=translate + 1,
            sot_lm=translate + 2, sot_prev=translate + 3,
            no_speech=translate + 4, no_timestamps=translate + 5,
            timestamp_begin=translate + 6,
            n_vocab=translate + 6 + 1501,
        )

    def sot_sequence(self, language_id: Optional[int] = None,
                     task_transcribe: bool = True) -> Tuple[int, ...]:
        if language_id is None:  # english-only models: bare SOT
            return (self.sot,)
        return (self.sot, language_id, self.transcribe if task_transcribe else self.translate)

    @property
    def english_only(self) -> bool:
        return self.eot == 50256

    def language_token(self, code: str) -> int:
        """<|lang|> id for an ISO code (whisper's canonical table order)."""
        n_langs = self.translate - self.sot - 1
        idx = WHISPER_LANGUAGES.index(code)
        if idx >= n_langs:
            raise ValueError(f"language {code!r} needs the {len(WHISPER_LANGUAGES)}"
                             f"-language (large-v3) token layout")
        return self.sot + 1 + idx


@lru_cache(maxsize=1)
def _split_pattern():
    """GPT-2's pre-tokenization split regex, compiled once per process."""
    import regex  # transformers dependency, present in the image

    return regex.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")


@lru_cache(maxsize=1)
def _byte_unicode_map() -> Dict[int, str]:
    """GPT-2's bytes→printable-unicode bijection."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class BPETokenizer:
    """GPT-2 byte-level BPE with whisper specials."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 english: bool = True, n_languages: int = _N_LANGUAGES):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.specials = SpecialTokens.for_model(english, n_languages)
        b2u = _byte_unicode_map()
        self._b2u = b2u
        self._u2b = {u: b for b, u in b2u.items()}
        self._bpe_cache: Dict[str, Tuple[str, ...]] = {}

    # -- encoding ----------------------------------------------------------
    def _bpe(self, token: str) -> Tuple[str, ...]:
        # The rolling-prompt path re-encodes overlapping context every 30 s
        # window on a 1-core host; identical pieces recur constantly, so the
        # merge walk is cached per piece (GPT-2 reference does the same).
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 30))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        out = tuple(word)
        if len(self._bpe_cache) < 65536:
            self._bpe_cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in _split_pattern().findall(text):
            mapped = "".join(self._b2u[b] for b in piece.encode("utf-8"))
            for sub in self._bpe(mapped):
                ids.append(self.vocab[sub])
        return ids

    # -- decoding ----------------------------------------------------------
    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        eot = self.specials.eot
        parts = []
        for i in ids:
            i = int(i)
            if skip_special and i >= eot:
                continue
            parts.append(self.inv_vocab.get(i, ""))
        data = bytes(self._u2b[ch] for ch in "".join(parts) if ch in self._u2b)
        return data.decode("utf-8", errors="replace")


class ByteFallbackTokenizer:
    """Deterministic stand-in when no vocabulary file is available: ids
    0-255 are raw bytes; specials follow the whisper layout. Lets every test
    and benchmark exercise real token flow without 0.5 GB of assets."""

    def __init__(self, english: bool = True, n_languages: int = _N_LANGUAGES):
        self.specials = SpecialTokens.for_model(english, n_languages)

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        keep = [int(i) for i in ids if int(i) < 256]
        return bytes(keep).decode("utf-8", errors="replace")


@dataclasses.dataclass(frozen=True)
class TekkenSpecials:
    """Voxtral's Tekken layout: 1000 control ids, then the 256 bytes at
    1000-1255, then the merges up to ``n_vocab``. The ids the
    transcription template uses (``<s>`` 1, ``</s>`` 2, ``[INST]`` 3,
    ``[/INST]`` 4, ``[AUDIO]`` 24, ``[BEGIN_AUDIO]`` 25, ``[TRANSCRIBE]``
    34) are the published ``tekken.json``'s as far as its template shows;
    they are assumed, not read."""

    bos: int = 1
    eos: int = 2
    inst: int = 3
    inst_end: int = 4
    audio: int = 24
    begin_audio: int = 25
    transcribe: int = 34
    n_special: int = 1000
    n_vocab: int = 131072

    def control_ids(self) -> Tuple[int, ...]:
        """Every control id but ``</s>``: never a transcript's token, so
        the decode suppresses them after the prompt."""
        return tuple(i for i in range(self.n_special) if i != self.eos)

    def prompt(self, lang_ids: Sequence[int]) -> Tuple[Tuple[int, ...],
                                                       Tuple[int, ...]]:
        """(ids before the audio rows, ids after them) of a transcription
        request: ``<s>[INST][BEGIN_AUDIO]`` · audio ·
        ``[/INST]`` ``lang_ids`` ``[TRANSCRIBE]``."""
        return ((self.bos, self.inst, self.begin_audio),
                (self.inst_end, *lang_ids, self.transcribe))


class TekkenByteTokenizer:
    """Voxtral's stand-in without ``tekken.json``: text is its UTF-8 bytes
    at ids 1000 + byte, and decoding keeps the byte ids only, as
    ``ByteFallbackTokenizer`` does for Whisper's layout."""

    def __init__(self, specials: Optional[TekkenSpecials] = None):
        self.specials = specials or TekkenSpecials()

    def encode(self, text: str) -> List[int]:
        return [self.specials.n_special + b for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        lo = self.specials.n_special
        keep = [int(i) - lo for i in ids if lo <= int(i) < lo + 256]
        return bytes(keep).decode("utf-8", errors="replace")

    def language_ids(self, language: Optional[str]) -> List[int]:
        """``lang:<code>`` of the transcription template; none for None."""
        return self.encode(f"lang:{language}") if language else []


# openai-whisper tokenizer.py non_speech_tokens: symbols suppressed when a
# single token (with or without leading space)...
_NON_SPEECH_SYMBOLS = (
    list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
    + "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split())
# ...and U+2640-267F miscellaneous symbols whose FIRST subtoken is suppressed
# even when the symbol spans multiple tokens (safe: those lead bytes only
# begin such symbols).
_MISC_SYMBOLS = tuple("♩♪♫♬♭♮♯")


def non_speech_tokens(tokenizer) -> Tuple[int, ...]:
    """Whisper's default suppress list (``suppress_tokens="-1"``), replicated
    from openai-whisper's ``Tokenizer.non_speech_tokens``: seeded with
    ``encode(" -")[0]`` / ``encode(" '")[0]`` (hyphens/quotes allowed between
    words but not starting one), then every non-speech symbol that encodes to
    a single token, plus the first subtoken of each miscellaneous musical
    symbol regardless of token count. Empty for the byte-fallback tokenizer
    (no linguistic vocabulary)."""
    if not getattr(tokenizer, "vocab", None):
        return ()
    ids = set()
    for seed in (" -", " '"):
        enc = tokenizer.encode(seed)
        if enc:
            ids.add(enc[0])
    for sym in _NON_SPEECH_SYMBOLS + list(_MISC_SYMBOLS):
        for cand in (sym, " " + sym):
            enc = tokenizer.encode(cand)
            if enc and (len(enc) == 1 or sym in _MISC_SYMBOLS):
                ids.add(enc[0])
    return tuple(sorted(ids))


def load_tokenizer(model_dir: Optional[str] = None, english: bool = True,
                   n_languages: int = _N_LANGUAGES):
    """HF vocab.json+merges.txt or tiktoken rank file → BPETokenizer; else
    ByteFallbackTokenizer."""
    if model_dir:
        vj = os.path.join(model_dir, "vocab.json")
        mg = os.path.join(model_dir, "merges.txt")
        if os.path.exists(vj) and os.path.exists(mg):
            with open(vj, encoding="utf-8") as fh:
                vocab = json.load(fh)
            merges: List[Tuple[str, str]] = []
            with open(mg, encoding="utf-8") as fh:
                for line in fh:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#version"):
                        continue
                    a, _, b = line.partition(" ")
                    merges.append((a, b))
            return BPETokenizer(vocab, merges, english, n_languages)
        for name in os.listdir(model_dir) if os.path.isdir(model_dir) else []:
            if name.endswith(".tiktoken"):
                vocab = {}
                with open(os.path.join(model_dir, name), "rb") as fh:
                    for line in fh:
                        if not line.strip():
                            continue
                        tok_b64, rank = line.split()
                        raw = base64.b64decode(tok_b64)
                        b2u = _byte_unicode_map()
                        vocab["".join(b2u[b] for b in raw)] = int(rank)
                # tiktoken files carry ranks implicitly ordered; merges are
                # reconstructed from contiguous rank order of multi-byte toks.
                merges = _merges_from_ranks(vocab)
                return BPETokenizer(vocab, merges, english, n_languages)
    return ByteFallbackTokenizer(english, n_languages)


def _merges_from_ranks(vocab: Dict[str, int]) -> List[Tuple[str, str]]:
    """Recover the exact merge list from a BPE rank table (tiktoken files
    carry only token→rank).

    For a genuinely BPE-trained table (GPT-2's), each multi-character token
    of rank r is the result of exactly one merge, and its two parents are
    what the merges of rank < r reduce its character sequence to. So walk
    tokens in rank order, BPE-encode each with the merges recovered so far,
    and when exactly two symbols remain they are that token's parents.
    (A first-valid-split heuristic is NOT equivalent: for "abc" with "a",
    "bc", "ab", "c" all in vocab it can pick ("a","bc") when the trained
    merge was ("ab","c"), silently changing encodings elsewhere.)

    Tokens that never reduce to two symbols (e.g. byte-alphabet leftovers
    or specials embedded in the table) contribute no merge — matching
    openai's published vocab where such entries don't appear in merges.txt.
    """
    ranks: Dict[Tuple[str, str], int] = {}
    merges: List[Tuple[str, str]] = []
    by_rank = sorted(vocab.items(), key=lambda kv: kv[1])
    big = 1 << 30
    for tok, _rank in by_rank:
        if len(tok) < 2:
            continue
        word = list(tok)
        while len(word) > 2:
            pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
            best = min(pairs, key=lambda p: ranks.get(p, big))
            if best not in ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        if len(word) == 2 and word[0] in vocab and word[1] in vocab:
            pair = (word[0], word[1])
            if pair not in ranks:
                ranks[pair] = len(merges)
                merges.append(pair)
    return merges
