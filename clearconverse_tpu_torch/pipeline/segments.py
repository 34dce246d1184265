"""Pure segment algebra — behavior-compatible with the reference's interval
logic; a copy of the JAX package's pipeline/segments.py. Every function here
is host-side and deterministic.

Reference parity map:
  merge_segments            ← merge_diarization_segments (back/api.py:294-306)
  refine_segment_with_vad   ← back/api.py:312-321
  find_segment_overlaps     ← sweep line, back/api.py:323-343
  detect_overlap_regions    ← back/api.py:881-891 (min-duration filter)
  select_profile_segments   ← the top-duration + temporal-stride selection of
                              _build_speaker_profiles (back/api.py:893-921)
  merge_window_labels       ← the merging/boundary-adjustment tail of
                              _resegment_overlap (back/api.py:1014-1050)
  map_speakers              ← top-2 SPEAKER_A/B mapping (back/api.py:1347-1357)
  rapid_exchange / choose_prompt ← context rules (back/api.py:1398-1403,
                              1425-1430, 1463-1472)
"""

from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

Interval = Tuple[float, float]
LabeledSegment = Tuple[float, float, str]


@dataclasses.dataclass
class AudioSegment:
    """Reference AudioSegment (back/api.py:101-111) with the audio payload as
    a NumPy array instead of a torch tensor."""

    start: float
    end: float
    speaker_id: str
    audio: Optional[np.ndarray] = None
    is_overlap: bool = False
    transcription: Optional[str] = None
    confidence: float = 1.0
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start


def merge_segments(segments: Sequence[LabeledSegment], gap_threshold: float) -> List[LabeledSegment]:
    """Merge chronologically-adjacent same-speaker segments whose gap is
    within ``gap_threshold`` seconds."""
    if not segments:
        return []
    ordered = sorted(segments, key=lambda x: x[0])
    merged = []
    cur_start, cur_end, cur_spk = ordered[0]
    for start, end, spk in ordered[1:]:
        if spk == cur_spk and (start - cur_end) <= gap_threshold:
            cur_end = end
        else:
            merged.append((cur_start, cur_end, cur_spk))
            cur_start, cur_end, cur_spk = start, end, spk
    merged.append((cur_start, cur_end, cur_spk))
    return merged


def refine_segment_with_vad(segment: Interval,
                            vad_intervals: Sequence[Interval]) -> Optional[Interval]:
    """Clip a segment to the span of its intersections with VAD intervals;
    None when it touches no speech."""
    s, e = segment
    hits = [(max(s, vs), min(e, ve)) for vs, ve in vad_intervals
            if max(s, vs) < min(e, ve)]
    if not hits:
        return None
    return (min(h[0] for h in hits), max(h[1] for h in hits))


def find_segment_overlaps(segments: Sequence[LabeledSegment]) -> Dict[Interval, List[str]]:
    """Sweep line over start/end events → regions where 2+ speakers are
    simultaneously active, with the speaker set captured at region close.
    (Same event ordering as the reference: ends sort before starts at equal
    times because -1 < +1.)"""
    events = []
    for start, end, spk in segments:
        events.append((start, 1, spk))
        events.append((end, -1, spk))
    events.sort(key=lambda x: (x[0], x[1]))

    active: set = set()
    regions = []
    overlap_start = None
    for t, typ, spk in events:
        if typ == 1:
            active.add(spk)
            if len(active) > 1 and overlap_start is None:
                overlap_start = t
        else:
            if len(active) > 1 and overlap_start is not None:
                regions.append((overlap_start, t, set(active)))
            active.discard(spk)
            if len(active) <= 1:
                overlap_start = None
    return {(s, e): sorted(spks) for s, e, spks in regions}


def detect_overlap_regions(segments: Sequence[LabeledSegment],
                           min_duration: float) -> List[Tuple[float, float, List[str]]]:
    return [(s, e, spks) for (s, e), spks in find_segment_overlaps(segments).items()
            if (e - s) >= min_duration and len(spks) > 1]


def map_speakers(segments: Sequence[LabeledSegment]) -> Dict[str, str]:
    """Top-2 most frequent raw speakers → SPEAKER_A / SPEAKER_B."""
    counts = Counter(spk for _, _, spk in segments)
    if not counts:
        raise ValueError("No speakers detected in the audio file")
    if len(counts) < 2:
        return {next(iter(counts)): "SPEAKER_A"}
    (a, _), (b, _) = counts.most_common(2)
    return {a: "SPEAKER_A", b: "SPEAKER_B"}


def select_profile_segments(
    segments: Sequence[LabeledSegment],
    max_embedding_segments: int = 100,
    min_duration: float = 0.75,
) -> Dict[str, List[Tuple[float, float]]]:
    """Per speaker: half the budget to the longest segments, the other half
    to an even temporal stride over the remainder.

    REPRODUCED QUIRK (back/api.py:918): ``max_embedding_segments <= 1``
    makes ``half`` zero and ``len(rest) // half`` raise ZeroDivisionError —
    the reference crashes identically on that (pathological) config value,
    and the default (100) never reaches it. SURVEY §7 list."""
    by_speaker: Dict[str, List[Tuple[float, float, float]]] = defaultdict(list)
    for start, end, spk in segments:
        if (end - start) >= min_duration:
            by_speaker[spk].append((start, end, end - start))

    half = max_embedding_segments // 2
    out: Dict[str, List[Tuple[float, float]]] = {}
    for spk, segs in by_speaker.items():
        by_dur = sorted(segs, key=lambda x: x[2], reverse=True)
        top = by_dur[:half]
        rest = sorted([s for s in segs if s not in top], key=lambda x: x[0])
        step = max(1, len(rest) // half)
        diverse = rest[::step][:half]
        out[spk] = [(s, e) for s, e, _ in top + diverse]
    return out


def merge_window_labels(
    window_results: Sequence[Tuple[float, float, str, float]],
    seg_start: float,
    seg_end: float,
    step: float,
) -> List[LabeledSegment]:
    """Merge per-window speaker labels into spans (the tail of
    _resegment_overlap): permissive gap merge, fragment suppression, boundary
    adjustment with previous-span borrowing.

    DELIBERATE FIX vs the reference: the borrowing branch guards on
    ``final`` being non-empty. The reference indexes
    ``final_segments[-1]`` whenever ``i > 0`` (back/api.py:1036) and
    CRASHES with IndexError when the first merged span was clipped below
    ``min_duration`` and dropped; here the fragment is simply dropped
    without borrowing (docs/PARITY.md deviation #11)."""
    segment_duration = seg_end - seg_start
    if not window_results:
        return [(seg_start, seg_end, "UNKNOWN")]

    min_duration = min(0.3, segment_duration / 10)
    merged: List[Tuple[float, float, str]] = []
    cur_start, cur_end, cur_spk, cur_conf = window_results[0]
    for start, end, spk, conf in window_results[1:]:
        if spk == cur_spk and start - cur_end <= max(step * 1.5, 0.2):
            cur_end = end
            cur_conf = (cur_conf + conf) / 2
        else:
            if (cur_end - cur_start) >= min_duration:
                merged.append((cur_start, cur_end, cur_spk))
            cur_start, cur_end, cur_spk, cur_conf = start, end, spk, conf
    if (cur_end - cur_start) >= min_duration:
        merged.append((cur_start, cur_end, cur_spk))

    final: List[LabeledSegment] = []
    for i, (start, end, spk) in enumerate(merged):
        a_start, a_end = max(seg_start, start), min(seg_end, end)
        if a_end - a_start < min_duration and i > 0 and final:
            p_start, p_end, p_spk = final[-1]
            if p_end - p_start > min_duration * 1.5:
                gap = min_duration - (a_end - a_start)
                p_end -= min(gap, p_end - p_start - min_duration)
                a_start = p_end
                final[-1] = (p_start, p_end, p_spk)
        if a_end - a_start >= min_duration:
            final.append((a_start, a_end, spk))
    return [(max(seg_start, s), min(seg_end, e), spk) for s, e, spk in final]


def window_hysteresis(
    similarities: Sequence[Tuple[str, float]],
    prev_speaker: Optional[str],
    confidence_gap: float = 0.15,
    runnerup_ratio: float = 0.65,
) -> Tuple[str, float]:
    """Sliding-window speaker pick with continuity hysteresis: when the top
    two profiles are within ``confidence_gap`` and the runner-up is the
    previous speaker with ≥ ``runnerup_ratio``× the top score, keep the
    previous speaker (back/api.py:992-996)."""
    ranked = sorted(similarities, key=lambda x: x[1], reverse=True)
    top_spk, top_conf = ranked[0]
    if len(ranked) > 1:
        second_spk, second_conf = ranked[1]
        if (top_conf - second_conf) < confidence_gap and prev_speaker and prev_speaker != top_spk:
            if second_spk == prev_speaker and second_conf > runnerup_ratio * top_conf:
                return prev_speaker, second_conf
    return top_spk, top_conf


def is_rapid_exchange(prev_speaker: Optional[str], speaker: str,
                      prev_end: float, start: float) -> bool:
    """<0.5 s speaker turnaround (back/api.py:1398-1403)."""
    return (prev_speaker is not None and prev_speaker != speaker
            and 0 < (start - prev_end) < 0.5)


DEFAULT_PROMPT = "This is a conversation between two people."
SECONDARY_PROMPT = "This is a clear conversation with complete sentences."
RAPID_PROMPT = "This is a fast-paced conversation with quick speaker changes. "
OVERLAP_PROMPT = "This is a single speaker talking."


def choose_prompt(speaker: str, prev_speaker: Optional[str], prev_end: float,
                  start: float, prev_transcript: str, rapid: bool,
                  base_prompt: str = DEFAULT_PROMPT) -> str:
    """Context prompt rules of the per-segment loop (back/api.py:1463-1472)."""
    prompt = base_prompt
    if speaker == prev_speaker and (start - prev_end) < 1.0:
        prompt = f"{prev_transcript.strip()} "
    if rapid:
        prompt = RAPID_PROMPT
    return prompt


def extract_segment(audio: np.ndarray, start: float, end: float, sr: int) -> np.ndarray:
    """Time-sliced [T] samples with the reference's clamping semantics
    (back/api.py:840-860): negative start → 0, end clipped to duration,
    inverted range → 100 zeros."""
    duration = audio.shape[-1] / sr
    start = max(start, 0.0)
    end = min(end, duration)
    i0, i1 = int(start * sr), int(end * sr)
    if i0 >= i1:
        return np.zeros(100, np.float32)
    return np.asarray(audio[..., i0:i1], np.float32).reshape(-1)


def extract_segment_lazy(audio, start: float, end: float, sr: int):
    """extract_segment's exact clamping/quirk semantics WITHOUT reading
    bytes: returns a decode.LazyClip view (or the 100-zeros quirk array),
    so ``audio`` may be a LazyAudio whose device download is still in
    flight. len() of the result equals len(extract_segment(...))."""
    from clearconverse_tpu_torch.audio.decode import lazy_slice
    if isinstance(audio, np.ndarray):
        # Eager arrays take extract_segment itself (a cheap view slice):
        # [C, T] inputs must use the TIME axis for duration and flatten
        # like the reference — a len(audio)-based path read the CHANNEL
        # count as the duration and sliced the wrong axis.
        return extract_segment(audio, start, end, sr)
    duration = len(audio) / sr          # lazy views are 1-D by construction
    start = max(start, 0.0)
    end = min(end, duration)
    i0, i1 = int(start * sr), int(end * sr)
    if i0 >= i1:
        return np.zeros(100, np.float32)
    return lazy_slice(audio, i0, i1)
