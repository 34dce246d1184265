"""Diarization: batched segmentation + embedding clustering.

Replaces the reference's black-box pyannote pipelines (VAD back/api.py:1311,
diarization back/api.py:1317 → 1052) with an explicit, testable stack:

  1. cut the file into fixed overlapping windows and score ALL windows'
     frame-wise speaker activity in ONE device call (bundle.segment_frames),
  2. stitch overlapping window scores (mean) into a file-level activity
     matrix [frames, max_local_speakers],
  3. VAD = any-speaker activity, binarized with hysteresis,
  4. carve per-slot active intervals into subsegments, embed them in ONE
     device call, AHC-cluster on host with min/max speaker constraints,
  5. emit (start, end, "SPEAKER_%02d") labeled segments.

The reference runs this again per file for secondary diarization of
low-similarity segments (back/api.py:1120-1137) — the same entry point here
with (1, 2) speaker bounds. A copy of the JAX package's pipeline/diarize.py
over the port's bundle.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from clearconverse_tpu_torch.pipeline.clustering import binarize, cluster_speakers
from clearconverse_tpu_torch.utils.errors import is_fatal

logger = logging.getLogger(__name__)

Interval = Tuple[float, float]
LabeledSegment = Tuple[float, float, str]

WINDOW_S = 10.0
HOP_S = 5.0
MAX_LOCAL = 3          # speaker slots the segmentation model emits
MIN_SUBSEG_S = 0.4     # minimum carveable subsegment
EMBED_PAD_S = 3.0      # subsegments padded/trimmed to this for embedding


def _window_starts(n_samples: int, sr: int) -> List[int]:
    """Sliding-window start samples — the ONE place the window layout
    lives (file_activities' store path and _window_chunks both consume
    it; a second copy once drifted per-file probs slicing)."""
    hop = int(HOP_S * sr)
    return list(range(0, max(n_samples - hop, 1), hop))


def _window_chunks(audio: np.ndarray, sr: int) -> np.ndarray:
    win = int(WINDOW_S * sr)
    starts = _window_starts(len(audio), sr)
    chunks = np.zeros((len(starts), win), np.float32)
    for i, s in enumerate(starts):
        seg = audio[s : s + win]
        chunks[i, : len(seg)] = seg
    return chunks


def _stitch(probs: np.ndarray, n_samples: int, sr: int,
            fhop: float) -> np.ndarray:
    """Mean-stitch per-window frame scores [W, Fw, S] → file-level
    [F, S], trimming frames past the true audio end.

    Each window's frame offset is rounded PER WINDOW
    (round(i·HOP_S/fhop)), not via a shared integer frames-per-hop: at
    the production frame hop (270/16000 s) HOP_S/fhop = 296.296, and a
    rounded-once 296 would drift the placement 5 ms per window —
    cumulative (~0.6 s of timestamp error on a 10-minute file)."""
    Fw = probs.shape[1]
    los = [int(round(i * HOP_S / fhop)) for i in range(len(probs))]
    total_frames = (los[-1] if los else 0) + Fw
    acc = np.zeros((total_frames, probs.shape[2]), np.float64)
    cnt = np.zeros((total_frames, 1), np.float64)
    for i, lo in enumerate(los):
        acc[lo : lo + Fw] += probs[i]
        cnt[lo : lo + Fw] += 1.0
    valid = int(n_samples / sr / fhop)
    return (acc / np.maximum(cnt, 1.0))[:valid].astype(np.float32)


def _file_activity(bundle, audio: np.ndarray, sr: int) -> Tuple[np.ndarray, float]:
    """Whole-file per-frame speaker activity [F, MAX_LOCAL] by scoring all
    sliding windows in one batch and mean-stitching overlaps."""
    probs = bundle.segment_frames(_window_chunks(audio, sr))  # [W, Fw, S]
    fhop = bundle.frame_hop_seconds
    return _stitch(probs, len(audio), sr, fhop), fhop


def file_activity(bundle, audio: np.ndarray, sr: int):
    """Public entry: one batched segmentation pass → (activity, frame_hop).
    The engine computes this ONCE and feeds both VAD and diarization (the
    reference runs two separate full-file neural passes, back/api.py:1311 +
    1317)."""
    return _file_activity(bundle, audio, sr)


def file_activities(bundle, audios: List[np.ndarray], sr: int,
                    store=None, store_rows=None):
    """Multi-file variant: EVERY file's windows score in ONE device call
    (process_files batches segmentation across requests — the per-file
    version costs one dispatch per file). Returns [(activity, fhop), ...].

    With ``store``/``store_rows`` (pipeline/bundle.AudioStore + per-file row
    indices), windows gather ON DEVICE from the resident audio instead of
    re-uploading ~2x the audio as 50%-overlap chunks."""
    if not audios:
        return []
    win = int(WINDOW_S * sr)
    use_store = (store is not None and store_rows is not None
                 and all(r is not None for r in store_rows)
                 and hasattr(bundle, "segment_frames_store"))
    counts = []
    if use_store:
        rows, starts = [], []
        for audio, r in zip(audios, store_rows):
            file_starts = _window_starts(len(audio), sr)
            counts.append(len(file_starts))
            rows.extend([r] * len(file_starts))
            starts.extend(file_starts)
        probs = bundle.segment_frames_store(store, rows, starts, win)
    else:
        chunks = []
        for audio in audios:
            c = _window_chunks(audio, sr)
            counts.append(len(c))
            chunks.append(c)
        probs = bundle.segment_frames(np.concatenate(chunks, axis=0))
    fhop = bundle.frame_hop_seconds
    out = []
    lo = 0
    for audio, n in zip(audios, counts):
        out.append((_stitch(probs[lo : lo + n], len(audio), sr, fhop), fhop))
        lo += n
    return out


def vad_intervals(bundle, audio: np.ndarray, sr: int,
                  onset: float = 0.5, offset: float = 0.5,
                  min_on: float = 0.1, min_off: float = 0.1,
                  activity=None) -> List[Interval]:
    """Voice activity = any-speaker activity (reference back/api.py:1311)."""
    act, fhop = activity if activity is not None else _file_activity(bundle, audio, sr)
    speech = act.max(axis=1) if act.size else np.zeros(0, np.float32)
    return binarize(speech, fhop, onset, offset, min_on, min_off)


def _carve_subsegments(audio: np.ndarray, act, fhop: float, sr: int,
                       onset: float, offset: float):
    """Carve per-slot activity into subsegments. For the embedding used in
    clustering, keep only frames where the slot is EXCLUSIVELY active —
    overlap frames mix speakers and chain-collapse the clustering
    (pyannote's diarization does the same). Returns (subsegs, slots, clean,
    descs) — ``descs`` describe each clip as gather coordinates
    (("frames", starts[int64], ends[int64]) for exclusive-frame
    concatenations, ("slice", i0, i1) for contiguous fallbacks). No audio
    BYTES are read here: callers with a device-resident AudioStore assemble
    the clips on device, and the host path materializes via
    _clips_from_descs — so ``audio`` may be a decode.LazyAudio whose
    download is still in flight (only len(audio) is consulted)."""
    subsegs: List[Interval] = []
    slots: List[int] = []
    clean: List[bool] = []
    descs: List[tuple] = []
    n = len(audio)
    for slot in range(act.shape[1]):
        others = [o for o in range(act.shape[1]) if o != slot]
        # "Exclusively active" = no OTHER slot above the same speech onset
        # the binarization uses — a hard-coded 0.5 here would let
        # overlapped frames into the clean clips whenever the deployment
        # lowers diarization_onset.
        exclusive = (act[:, slot] > onset) & np.all(act[:, others] <= onset,
                                                    axis=1)
        for s, e in binarize(act[:, slot], fhop, onset, offset,
                             min_duration_on=MIN_SUBSEG_S, min_duration_off=0.1):
            # binarize returns frame-aligned times (frame · fhop); round —
            # plain int() truncates to frame-1 for ~14% of indices at the
            # production hop (e.g. 125·fhop/fhop = 124.99999999999999).
            f0 = int(round(s / fhop))
            f1 = min(int(round(e / fhop)), len(exclusive))
            # Vectorized frame→sample mapping (the per-frame comprehension
            # was part of the diarizer's host hotspot). Operation ORDER
            # matches the scalar `int(f * fhop * sr)` exactly:
            # (f · fhop) · sr in float64, truncated.
            fr = np.flatnonzero(exclusive[f0:f1]).astype(np.int64) + f0
            fs = np.minimum(((fr * fhop) * sr).astype(np.int64), n)
            fe = np.minimum((((fr + 1) * fhop) * sr).astype(np.int64), n)
            total = int((fe - fs).sum())
            is_clean = len(fr) > 0 and total >= MIN_SUBSEG_S * sr
            if is_clean:
                descs.append(("frames", fs, fe))
            else:
                i0, i1 = int(s * sr), min(int(e * sr), n)
                descs.append(("slice", i0, max(i1, i0)))
            subsegs.append((s, e))
            slots.append(slot)
            clean.append(is_clean)
    return subsegs, slots, clean, descs


def _clips_from_descs(audio, descs: List[tuple]) -> List[np.ndarray]:
    """Materialize carve descriptors into host clip arrays (the host-upload
    embedding path). Byte-identical to the clips the pre-descriptor code
    built inline."""
    clips: List[np.ndarray] = []
    for d in descs:
        if d[0] == "frames":
            _, fs, fe = d
            clips.append(np.concatenate(
                [np.asarray(audio[a:b], np.float32)
                 for a, b in zip(fs, fe)]) if len(fs)
                else np.zeros(0, np.float32))
        else:
            clips.append(np.asarray(audio[d[1]: d[2]], np.float32))
    return clips


def _embed_descs_store(bundle, store, rows: List[int], descs: List[tuple],
                       sr: int):
    """Embed carve descriptors via ON-DEVICE store gathers (no clip upload):
    exclusive-frame clips through bundle.embed_frames_store, contiguous
    slices through bundle.embed_store. Bit-equivalent to embedding the
    host-assembled clips of _pad_clips over the same gated audio.

    Returns ``(embs [N, D], missing_ids)``: frame clips whose frame
    lengths are non-uniform WITHIN the clip (float hop × sr rounding,
    e.g. sr=22050) don't fit the fixed-frame gather — their rows are
    zeros and their indices land in ``missing_ids`` for the caller to
    host-embed individually, instead of aborting the whole batch back to
    the per-clip upload path. Returns None only when nothing
    could be embedded on device (caller falls back to host entirely)."""
    pad = int(EMBED_PAD_S * sr)
    frame_ids = [i for i, d in enumerate(descs) if d[0] == "frames"]
    slice_ids = [i for i, d in enumerate(descs) if d[0] == "slice"]
    missing: List[int] = []
    # Group frame clips by their (per-clip uniform) frame length — clips
    # with mixed lengths inside can't ride the fixed-fr gather.
    by_fr: Dict[int, List[int]] = {}
    for i in frame_ids:
        _, fs, fe = descs[i]
        lens = np.unique(fe - fs)
        if len(lens) == 1 and int(lens[0]) > 0:
            by_fr.setdefault(int(lens[0]), []).append(i)
        else:
            missing.append(i)
    if not by_fr and not slice_ids:
        return None
    emb_map = {}
    CHUNK = 128
    for fr, ids in by_fr.items():
        F = -(-pad // fr)                       # ceil: F*fr >= pad
        starts = np.zeros((len(ids), F), np.int32)
        totals = np.ones(len(ids), np.int32)
        rws = np.asarray([rows[i] for i in ids], np.int32)
        for k, i in enumerate(ids):
            _, fs, _ = descs[i]
            n = min(len(fs), F)
            starts[k, :n] = fs[:n]
            totals[k] = max(min(len(fs) * fr, pad), 1)
        for lo in range(0, len(ids), CHUNK):
            hi = min(lo + CHUNK, len(ids))
            embs = bundle.embed_frames_store(store, rws[lo:hi],
                                             starts[lo:hi], totals[lo:hi],
                                             fr, pad)
            for k, i in enumerate(ids[lo:hi]):
                emb_map[i] = embs[k]
    if slice_ids:
        for lo in range(0, len(slice_ids), CHUNK):
            ids = slice_ids[lo:lo + CHUNK]
            embs = bundle.embed_store(
                store, [rows[i] for i in ids],
                [descs[i][1] for i in ids],
                [max(min(descs[i][2] - descs[i][1], pad), 1) for i in ids],
                pad)
            for k, i in enumerate(ids):
                emb_map[i] = embs[k]
    if not emb_map:
        return None
    dim = len(next(iter(emb_map.values())))
    zero = np.zeros(dim, np.float32)
    return (np.stack([emb_map.get(i, zero) for i in range(len(descs))]),
            missing)


def _pad_clips(emb_clips: List[np.ndarray], sr: int):
    """Clip list → fixed-size padded (batch [N, pad], lengths [N])."""
    pad = int(EMBED_PAD_S * sr)
    batch = np.zeros((len(emb_clips), pad), np.float32)
    lengths = np.zeros(len(emb_clips), np.int64)
    for i, clip in enumerate(emb_clips):
        seg = clip[:pad]
        batch[i, : len(seg)] = seg
        lengths[i] = max(len(seg), 1)
    return batch, lengths


def _cluster_subsegments(embs, subsegs, slots, clean,
                         min_speakers: int, max_speakers: int,
                         cluster_threshold: float) -> List[LabeledSegment]:
    """Cluster CLEAN subsegments only — mixed-overlap embeddings sit between
    speaker manifolds and chain-collapse average-linkage AHC. Mixed ones
    are then assigned by their slot's majority cluster (slot identity is
    locally consistent) or nearest centroid."""
    clean_idx = [i for i, c in enumerate(clean) if c]
    labels = np.zeros(len(subsegs), np.int32)
    if clean_idx:
        clean_labels = cluster_speakers(embs[clean_idx],
                                        threshold=cluster_threshold,
                                        min_speakers=min_speakers,
                                        max_speakers=max_speakers)
        for i, l in zip(clean_idx, clean_labels):
            labels[i] = l
        n_clusters = int(clean_labels.max()) + 1
        centroids = np.stack([embs[[i for i, l in zip(clean_idx, clean_labels)
                                    if l == c]].mean(axis=0)
                              for c in range(n_clusters)])
        for i, c in enumerate(clean):
            if c:
                continue
            same_slot = [labels[j] for j in clean_idx if slots[j] == slots[i]]
            if same_slot:
                labels[i] = np.bincount(same_slot).argmax()
            else:
                d = 1.0 - centroids @ embs[i] / np.maximum(
                    np.linalg.norm(centroids, axis=1) * np.linalg.norm(embs[i]), 1e-12)
                labels[i] = int(np.argmin(d))
    else:
        labels = cluster_speakers(embs, threshold=cluster_threshold,
                                  min_speakers=min_speakers,
                                  max_speakers=max_speakers)

    out = [(s, e, f"SPEAKER_{int(l):02d}") for (s, e), l in zip(subsegs, labels)]
    out.sort(key=lambda x: x[0])
    return out


def diarize(bundle, audio: np.ndarray, sr: int,
            min_speakers: int = 1, max_speakers: int = 2,
            onset: float = 0.5, offset: float = 0.5,
            cluster_threshold: float = 0.7,
            activity=None) -> List[LabeledSegment]:
    """Full diarization → chronologically sorted labeled segments."""
    act, fhop = activity if activity is not None else _file_activity(bundle, audio, sr)
    if act.size == 0:
        return []
    subsegs, slots, clean, descs = _carve_subsegments(
        audio, act, fhop, sr, onset, offset)
    if not subsegs:
        return []
    batch, lengths = _pad_clips(_clips_from_descs(audio, descs), sr)
    embs = bundle.embed_batch(batch, lengths)
    return _cluster_subsegments(embs, subsegs, slots, clean,
                                min_speakers, max_speakers, cluster_threshold)


def diarize_many(bundle, audios: List[np.ndarray], sr: int,
                 min_speakers: int = 1, max_speakers: int = 2,
                 onset: float = 0.5, offset: float = 0.5,
                 cluster_threshold: float = 0.7,
                 activities=None, store=None,
                 store_rows=None) -> List[Optional[List[LabeledSegment]]]:
    """Multi-file diarization with ONE embedding device call for every
    file's subsegments. Clustering stays per file — embeddings never mix
    across files.
    Semantically identical to [diarize(f) for f in files], except a file
    whose clustering throws yields None (per-file isolation) instead of
    failing the batch.

    ``store``/``store_rows`` (pipeline/bundle.AudioStore + per-file rows of
    the SAME gated audio as ``audios``) assemble the embedding clips on
    the device instead of uploading each clip.

    CONTRACT: ``sr`` applies to EVERY file — callers must resample to a
    uniform rate first (the engine resamples everything to
    Config.target_sample_rate before reaching here). Passing mixed-rate
    audios would silently produce wrong timestamps."""
    if activities is None:
        activities = file_activities(bundle, audios, sr,
                                     store=store, store_rows=store_rows)
    carved, counts = [], []
    for audio, (act, fhop) in zip(audios, activities):
        c = (_carve_subsegments(audio, act, fhop, sr, onset, offset)
             if act.size else ([], [], [], []))
        carved.append(c)
        counts.append(len(c[0]))
    use_store = (store is not None and store_rows is not None
                 and all(r is not None for r in store_rows)
                 and hasattr(bundle, "embed_frames_store")
                 and hasattr(bundle, "embed_store"))
    if sum(counts):
        embs = None
        if use_store:
            clip_rows = [r for c, r in zip(carved, store_rows)
                         for _ in c[0]]
            all_descs = [d for c in carved for d in c[3]]
            try:
                res = _embed_descs_store(bundle, store, clip_rows,
                                         all_descs, sr)
                if res is not None:
                    embs, missing = res
                    if missing:
                        # Host-embed ONLY the clips the fixed-frame gather
                        # couldn't express (ragged frame lengths) — the
                        # rest stayed on device.
                        clip_audio = [a for a, c in zip(audios, carved)
                                      for _ in c[0]]
                        ragged = [_clips_from_descs(clip_audio[i],
                                                    [all_descs[i]])[0]
                                  for i in missing]
                        batch, lengths = _pad_clips(ragged, sr)
                        embs[np.asarray(missing)] = bundle.embed_batch(
                            batch, lengths)
            except Exception as exc:  # noqa: BLE001 — host fallback
                if is_fatal(exc):
                    raise
                logger.error("store-gathered diarize embeds failed: %s", exc)
                embs = None
        if embs is None:
            # Host path: materializing clips here (not in carve) keeps the
            # store path byte-free so LazyAudio downloads stay in flight.
            all_clips = [clip for audio, c in zip(audios, carved)
                         for clip in _clips_from_descs(audio, c[3])]
            batch, lengths = _pad_clips(all_clips, sr)
            embs = bundle.embed_batch(batch, lengths)
    out: List[List[LabeledSegment]] = []
    lo = 0
    for fi, ((subsegs, slots, clean, _descs), n) in enumerate(
            zip(carved, counts)):
        if not subsegs:
            out.append([])
            continue
        try:
            out.append(_cluster_subsegments(
                embs[lo: lo + n], subsegs, slots, clean,
                min_speakers, max_speakers, cluster_threshold))
        except Exception as exc:  # noqa: BLE001 — per-file isolation: one
            # pathological file must not discard the other files' results
            # (the caller falls back to per-file diarize for None entries).
            if is_fatal(exc):
                raise
            logger.error("clustering failed for file %d: %s", fi, exc)
            out.append(None)
        lo += n
    return out
