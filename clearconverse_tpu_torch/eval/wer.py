"""Word error rate (jiwer-style, first-party — jiwer is not vendored).

A copy of the JAX package's eval/wer.py for the port (host code).

WER = (substitutions + deletions + insertions) / reference words, via
Levenshtein alignment over normalized word sequences.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple


_ENGLISH_NORMALIZER = None


def _english_normalizer():
    global _ENGLISH_NORMALIZER
    if _ENGLISH_NORMALIZER is None:
        from clearconverse_tpu_torch.eval.normalize_en import EnglishTextNormalizer
        _ENGLISH_NORMALIZER = EnglishTextNormalizer()
    return _ENGLISH_NORMALIZER


def normalize_text(text: str, style: str = "english") -> List[str]:
    """Tokenize for WER scoring.

    ``style="english"`` (default) applies whisper's EnglishTextNormalizer
    semantics (eval/normalize_en.py) — the convention the reference's WER
    would be scored under, so parity deltas measure models, not
    normalizers. ``style="light"`` keeps the old
    language-agnostic folding: lowercase, strip punctuation (keeping
    intra-word apostrophes), collapse whitespace."""
    if style == "english":
        return _english_normalizer()(text).split()
    text = text.lower()
    text = re.sub(r"[^\w\s']", " ", text)
    # Pad so string-boundary quotes match the \s-anchored pattern too —
    # without it "'hello" kept its quote and mis-scored as a substitution
    # while " 'hello " did not (position-dependent normalization).
    text = re.sub(r"\s'+|'+\s", " ", f" {text} ")
    return text.split()


def edit_ops(ref: Sequence[str], hyp: Sequence[str]) -> Dict[str, int]:
    """Minimal-edit alignment counts between token sequences."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, dels, ins)
    INF = 1 << 30
    prev = [(j, 0, 0, j) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur: List[Tuple[int, int, int, int]] = [(i, 0, i, 0)] + [(INF, 0, 0, 0)] * m
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                cand = [(prev[j - 1][0], *prev[j - 1][1:])]
            else:
                cand = [(prev[j - 1][0] + 1, prev[j - 1][1] + 1,
                         prev[j - 1][2], prev[j - 1][3])]
            cand.append((prev[j][0] + 1, prev[j][1], prev[j][2] + 1, prev[j][3]))
            cand.append((cur[j - 1][0] + 1, cur[j - 1][1], cur[j - 1][2],
                         cur[j - 1][3] + 1))
            cur[j] = min(cand)
        prev = cur
    _, subs, dels, ins = prev[m]
    return {"substitutions": subs, "deletions": dels, "insertions": ins,
            "hits": n - subs - dels}


def _style_for(language) -> str:
    """Normalizer style for a model/eval language. English (or unset —
    the reference's small.en default) scores under whisper's
    EnglishTextNormalizer; any pinned non-English language gets the
    language-agnostic ``light`` folding instead of English contraction
    expansion / British→American spelling / English number-word rules.
    Matching is case-insensitive and accepts regional tags ('EN',
    'English', 'en-US', 'en_GB'): env-provided language strings arrive
    unnormalized."""
    if language is None:
        return "english"
    lang = str(language).strip().lower()
    if lang in ("", "english") or lang == "en" or lang.startswith(("en-", "en_")):
        return "english"
    return "light"


def word_error_rate(reference: str, hypothesis: str,
                    normalize: bool = True,
                    language: str | None = None,
                    style: str | None = None) -> float:
    """WER as a bare float. ``language`` selects the normalizer via
    _style_for; an explicit ``style`` ("english"/"light") wins."""
    return word_error_rate_detail(reference, hypothesis,
                                  normalize=normalize, language=language,
                                  style=style)["wer"]


def word_error_rate_detail(reference: str, hypothesis: str,
                           normalize: bool = True,
                           language: str | None = None,
                           style: str | None = None) -> Dict[str, float]:
    """WER plus the alignment counts behind it.

    Returns {"wer", "substitutions", "deletions", "insertions",
    "ref_words", "hyp_words"}. The counts keep hallucination magnitude
    visible when the empty-reference cap clamps the rate: a 500-word
    hallucination against a filler-only reference and one inserted word
    both score 1.0, and ``hyp_words`` tells them apart."""
    style = style or _style_for(language)
    ref = normalize_text(reference, style) if normalize else reference.split()
    hyp = normalize_text(hypothesis, style) if normalize else hypothesis.split()
    if not ref:
        # An empty (post-normalization) reference has no defined rate
        # (jiwer raises here). Cap at 1.0 so one filler-only reference
        # can't contribute a word COUNT to a mean-WER aggregate and
        # swamp a parity sign-off; the insertion/hyp_words counts retain
        # the magnitude the cap hides.
        return {"wer": 0.0 if not hyp else 1.0, "substitutions": 0,
                "deletions": 0, "insertions": len(hyp),
                "ref_words": 0, "hyp_words": len(hyp)}
    ops = edit_ops(ref, hyp)
    wer = (ops["substitutions"] + ops["deletions"]
           + ops["insertions"]) / len(ref)
    return {"wer": wer, "substitutions": ops["substitutions"],
            "deletions": ops["deletions"], "insertions": ops["insertions"],
            "ref_words": len(ref), "hyp_words": len(hyp)}
