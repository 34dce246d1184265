"""TranscriptionEngine — the pipeline orchestrator, on the port's bundle.

Behavioral parity target: ``EnhancedAudioProcessor`` (back/api.py:584-1549):
the same stages, interval/prompt/hysteresis rules and transcript format, a
copy of the JAX package's pipeline/engine.py. Every model evaluation is
gathered into batched device calls:

  reference (per file)                     this engine (per request group)
  ───────────────────────────────          ─────────────────────────────────
  ≤100 embeds/speaker, one at a time   →   ONE embed batch for all profiles
  per-window embed in overlap loop     →   ONE embed batch for all windows
  per-span separate_batch              →   ONE separation batch
  per-segment whisper.transcribe       →   bucket-batched decode *wavefront*:
                                           context-chained prompts resolve in
                                           generations, so chained segments
                                           keep the reference's prompt
                                           semantics while independent ones
                                           decode together.

The engine keeps the JAX package's per-file isolation (a file that fails
returns None), but never for a missing piece of the port or a CUDA error
(``utils/errors.is_fatal``): those propagate, so an unported method or a
failed launch cannot turn into a quietly different transcript.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import weakref
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from clearconverse_tpu_torch.config import Config, TorchConfig
from clearconverse_tpu_torch.pipeline import segments as S
from clearconverse_tpu_torch.pipeline.batching import batch_audio
from clearconverse_tpu_torch.pipeline.cancel import ProcessingCancelled, check_cancel
from clearconverse_tpu_torch.pipeline.diarize import diarize, file_activity, vad_intervals
from clearconverse_tpu_torch.utils.errors import is_fatal
from clearconverse_tpu_torch.utils.tracing import StageTimer

logger = logging.getLogger(__name__)

MIN_EMBED_S = 0.5   # embeddings unreliable below this (back/api.py:864)

# One run lock per BUNDLE (weak, so bundles die normally): engines sharing a
# bundle serialize whole runs against each other.
_BUNDLE_LOCKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_BUNDLE_LOCKS_GUARD = threading.Lock()


def _run_lock_for(models) -> threading.Lock:
    with _BUNDLE_LOCKS_GUARD:
        try:
            lock = _BUNDLE_LOCKS.get(models)
            if lock is None:
                lock = threading.Lock()
                _BUNDLE_LOCKS[models] = lock
        except TypeError:
            # An unhashable or un-weakref-able test double: a private lock
            # still serializes this engine's own runs.
            lock = threading.Lock()
        return lock


def _new_separation_counts() -> Dict[str, int]:
    """A run's overlap path: ``separate_batch`` calls, the rows they ran
    (after the bundle's row bucket) and the real ones among them, the
    samples run and the real ones, the separator's segments, its layers
    that ran the segment attention and feed-forward kernels, and the
    embedding calls of the resegmentation windows and of the separated
    sources."""
    return dict.fromkeys(("calls", "rows", "real_rows", "samples",
                          "real_samples", "segments", "fused_attn_layers",
                          "fused_ffn_layers", "reseg_calls",
                          "source_calls"), 0)


class TranscriptionEngine:
    """Runs on ``device`` (``cuda`` unless the caller passes ``"cpu"``):
    the bundle it builds lives there, and so do the audio gate and store.
    An injected ``models`` bundle brings its own device."""

    def __init__(self, config: Optional[Config] = None,
                 torch_config: Optional[TorchConfig] = None,
                 models=None, model_dir: str = "./models",
                 load_models_immediately: bool = False, device="cuda"):
        self.config = config or Config()
        self.torch_config = torch_config or TorchConfig()
        created = models is None
        if created:
            from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
            models = ModelBundle(self.config, self.torch_config, model_dir,
                                 device=device)
        self.device = torch.device(getattr(models, "device", None) or device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TranscriptionEngine: no CUDA device is "
                               "available; pass device='cpu' to run on the CPU")
        self.models = models
        # One run at a time per bundle: a run installs per-run state on the
        # (possibly shared) bundle — the cancel gate and the config.
        self._run_lock = _run_lock_for(models)
        if not created and hasattr(models, "config"):
            # A shared bundle reads config fields per call, so it must see
            # this engine's config; re-pointed under the bundle's lock.
            with self._run_lock:
                models.config = self.config
        self._inflight_hosts: List = []
        # What the last run separated (see _new_separation_counts).
        self.last_run_separation: Dict[str, int] = _new_separation_counts()
        if load_models_immediately:
            self.models.load_with_progress()

    # ------------------------------------------------------------ plumbing
    def models_are_loaded(self) -> bool:
        return self.models.models_are_loaded()

    def load_models_with_progress(self, progress_callback=None) -> bool:
        return self.models.load_with_progress(progress_callback)

    # ------------------------------------------------------------ helpers
    def _count_separation(self, padded: np.ndarray, lens: np.ndarray) -> None:
        """Adds one ``separate_batch`` call of ``padded`` rows of ``lens``
        samples to ``last_run_separation``, with what the bundle says it
        ran (its row bucket; the padded batch for a bundle that says
        nothing)."""
        ran = getattr(self.models, "last_separation", None) or {}
        c = self.last_run_separation
        c["calls"] += 1
        c["real_rows"] += len(lens)
        c["real_samples"] += int(np.sum(lens))
        c["rows"] += int(ran.get("rows", padded.shape[0]))
        c["samples"] += int(ran.get("samples", padded.size))
        for key in ("segments", "fused_attn_layers", "fused_ffn_layers"):
            c[key] += int(ran.get(key, 0))

    def _diar_kwargs(self) -> Dict[str, float]:
        """Configured diarization hyperparameters (binarization hysteresis
        + AHC cluster threshold). Callers that feed ``vad_intervals`` keep
        only onset/offset."""
        kw: Dict[str, float] = {}
        tc = self.torch_config
        if tc.diarization_onset is not None:
            kw["onset"] = tc.diarization_onset
        if tc.diarization_offset is not None:
            kw["offset"] = tc.diarization_offset
        if tc.diarization_cluster_threshold is not None:
            kw["cluster_threshold"] = tc.diarization_cluster_threshold
        return kw

    @contextlib.contextmanager
    def _phase(self, run_timer, name: str):
        """run_timer.stage(name) that also records the bundle's device
        sub-spans (embed_dev / segment_dev / separate_dev / decode_dev, each
        a device call with its result copy) taken during the phase as
        ``name.*`` children."""
        snap = dict(getattr(self.models, "stage_times", {}))
        try:
            with run_timer.stage(name):
                yield
        finally:
            for k, v in getattr(self.models, "stage_times", {}).items():
                delta = v - snap.get(k, 0.0)
                if delta > 0:
                    run_timer.spans.append((f"{name}.{k}", delta))

    def _embed_many(self, clips: List[np.ndarray], sr: int,
                    refs: Optional[List] = None,
                    count: Optional[str] = None) -> List[Optional[np.ndarray]]:
        """Batched embedding honoring the reference's <0.5 s → None rule.

        ``refs`` (aligned; entries (store, row, start-sample) or None) route
        clips that are contiguous slices of device-resident audio through
        store gathers instead of host uploads. ``count`` names the key of
        ``last_run_separation`` that counts the device calls."""
        out: List[Optional[np.ndarray]] = [None] * len(clips)
        valid = [i for i, c in enumerate(clips) if len(c) >= MIN_EMBED_S * sr]
        if not valid:
            return out
        use_store = refs is not None and hasattr(self.models, "embed_store")
        host_idx = [i for i in valid if not (use_store and refs[i])]
        store_idx = [i for i in valid if use_store and refs[i]]
        bs = self.config.transcription_batch_size * 4
        buckets = self.torch_config.duration_buckets
        for idx, padded, lens in batch_audio([clips[i] for i in host_idx],
                                             sr, buckets, bs):
            embs = self.models.embed_batch(padded, lens)
            if count:
                self.last_run_separation[count] += 1
            for row, j in enumerate(idx):
                out[host_idx[j]] = embs[row]
        if store_idx:
            from clearconverse_tpu_torch.pipeline.bundle import iter_store_batches
            for sub, sb in iter_store_batches(
                    [refs[i] for i in store_idx],
                    [len(clips[i]) for i in store_idx], sr, buckets, bs):
                embs = self.models.embed_store(sb.store, sb.rows, sb.starts,
                                               sb.lens, sb.bucket)
                if count:
                    self.last_run_separation[count] += 1
                for j, e in zip(sub, embs):
                    out[store_idx[j]] = e
        return out

    @staticmethod
    def _cos(a: np.ndarray, b: np.ndarray) -> float:
        na = np.linalg.norm(a) * np.linalg.norm(b)
        return float(a @ b / na) if na > 0 else 0.0

    def _build_profiles(self, audio: np.ndarray, sr: int,
                        raw_segments: List[S.LabeledSegment]) -> Dict[str, np.ndarray]:
        """Variance-weighted speaker profiles (back/api.py:893-959), with the
        per-segment denoise + embed loop collapsed into batches."""
        return self._build_profiles_many([(audio, raw_segments)], sr)[0]

    def _build_profiles_many(self, file_items: List[Tuple[np.ndarray, List]],
                             sr: int,
                             store_refs: Optional[List] = None
                             ) -> List[Dict[str, np.ndarray]]:
        """Profiles for MANY files with all files' clips sharing denoise +
        embed batches. ``store_refs`` ((store, row) per file, optional)
        route clips through device gathers."""
        if not self.config.use_speaker_embeddings:
            return [{} for _ in file_items]
        # With a store ref, clips stay lazy: the device embeds and
        # variance-weights them from the AudioStore.
        flats: List[List[Tuple[str, object]]] = []
        crefs: List = []
        vars_: List[Optional[float]] = []
        for fi, (audio, raw_segments) in enumerate(file_items):
            fref = store_refs[fi] if store_refs else None
            duration = len(audio) / sr
            selected = S.select_profile_segments(
                raw_segments, self.config.max_embedding_segments)
            flat: List[Tuple[str, object]] = []
            for spk, spans in selected.items():
                for (s, e) in spans:
                    clip = (S.extract_segment_lazy(audio, s, e, sr) if fref
                            else S.extract_segment(audio, s, e, sr))
                    if len(clip) > 0.5 * sr:
                        flat.append((spk, clip))
                        i0 = int(max(s, 0.0) * sr)
                        use_ref = (fref is not None
                                   and i0 < int(min(e, duration) * sr))
                        crefs.append((fref[0], fref[1], i0)
                                     if use_ref else None)
                        # Host np.var only off the store path; the device
                        # variance fills the None entries below.
                        vars_.append(None if use_ref
                                     else float(np.var(np.asarray(clip))))
            flats.append(flat)

        clips = [c for flat in flats for _, c in flat]
        embs: List[Optional[np.ndarray]] = [None] * len(clips)
        if not clips:
            return [{} for _ in file_items]
        buckets = self.torch_config.duration_buckets
        amount = self.config.noise_reduction_amount
        store_ids = [i for i, r in enumerate(crefs)
                     if r and hasattr(self.models, "embed_denoised_store")]
        if store_ids:
            from clearconverse_tpu_torch.pipeline.bundle import iter_store_batches
            for sub, sb in iter_store_batches(
                    [crefs[i] for i in store_ids],
                    [len(clips[i]) for i in store_ids], sr, buckets, 64):
                e, v = self.models.embed_denoised_store(
                    sb.store, sb.rows, sb.starts, sb.lens, amount, sb.bucket,
                    with_var=True)
                for j, emb, var in zip(sub, e, v):
                    embs[store_ids[j]] = emb
                    vars_[store_ids[j]] = float(var)
        store_id_set = set(store_ids)
        host_ids = [i for i in range(len(clips)) if i not in store_id_set]
        for i in host_ids:      # store ref present but no device var path
            if vars_[i] is None:
                vars_[i] = float(np.var(np.asarray(clips[i])))
        host_clips = [np.asarray(clips[i], np.float32) for i in host_ids]
        if host_ids and hasattr(self.models, "embed_denoised_batch"):
            for idx, padded, lens in batch_audio(host_clips, sr, buckets, 64):
                e = self.models.embed_denoised_batch(padded, lens, amount, sr)
                for row, j in enumerate(idx):
                    embs[host_ids[j]] = e[row]
        elif host_ids:
            # A bundle without a fused gate + embed: gate on the engine's
            # device, then embed the gated clips.
            from clearconverse_tpu_torch.audio.denoise import (
                spectral_gate_normalized)
            denoised: List[Tuple[int, np.ndarray]] = []
            for idx, padded, lens in batch_audio(host_clips, sr, buckets, 64):
                clean = spectral_gate_normalized(
                    torch.from_numpy(padded).to(self.device), amount,
                    torch.from_numpy(lens).to(self.device), sr=sr).cpu().numpy()
                for row, j in enumerate(idx):
                    denoised.append((j, clean[row, : lens[row]]))
            denoised.sort(key=lambda x: x[0])
            for i, emb in zip(host_ids,
                              self._embed_many([c for _, c in denoised], sr)):
                embs[i] = emb

        out: List[Dict[str, np.ndarray]] = []
        pos = 0
        for flat in flats:
            profiles: Dict[str, np.ndarray] = {}
            by_spk: Dict[str, List[Tuple[np.ndarray, float]]] = {}
            for (spk, _), emb, var in zip(flat, embs[pos : pos + len(flat)],
                                          vars_[pos : pos + len(flat)]):
                if emb is not None and var is not None:
                    by_spk.setdefault(spk, []).append((emb, var))
            pos += len(flat)
            for spk, pairs in by_spk.items():
                total = sum(v for _, v in pairs)
                if total > 0:
                    profiles[spk] = sum(e * (v / total) for e, v in pairs)
                else:
                    profiles[spk] = np.mean([e for e, _ in pairs], axis=0)
            out.append(profiles)
        return out

    def _resegment_overlaps(self, jobs: List[Tuple], sr: int
                            ) -> List[List[List[S.LabeledSegment]]]:
        """Sliding-window re-labeling of each overlap segment
        (back/api.py:961-1050) of MANY files, ALL windows of ALL segments
        embedded in one batch. ``jobs`` holds (audio, overlap_items,
        profiles, store_ref) per file; a window is gathered on the device
        when its file's ``store_ref`` = (store, row). Returns each file's
        spans per overlap segment."""
        wsize = self.config.sliding_window_size
        windows: List[np.ndarray] = []
        refs: List = []
        owners: List[List[Tuple[int, float, float, float]]] = []
        for audio, overlap_items, _, store_ref in jobs:
            own = []     # (seg, ws, we, step) per window of this file
            for si, (seg_start, seg_end) in enumerate(overlap_items):
                step = self.config.sliding_window_step
                if (seg_end - seg_start) < 2.0:
                    step = min(step, (seg_end - seg_start) / 4)
                curr = seg_start
                while curr + wsize <= seg_end:
                    windows.append(
                        S.extract_segment_lazy(audio, curr, curr + wsize, sr))
                    refs.append((store_ref[0], store_ref[1],
                                 int(max(curr, 0.0) * sr)) if store_ref
                                else None)
                    own.append((si, curr, curr + wsize, step))
                    curr += step
            owners.append(own)

        embs = iter(self._embed_many(windows, sr, refs=refs,
                                     count="reseg_calls"))
        out = []
        for (_, overlap_items, profiles, _), own in zip(jobs, owners):
            results: List[List[Tuple[float, float, str, float]]] = \
                [[] for _ in overlap_items]
            prev_by_seg: List[Optional[str]] = [None] * len(overlap_items)
            for si, ws, we, _ in own:
                emb = next(embs)
                if emb is not None and profiles:
                    sims = [(spk, self._cos(emb, prof))
                            for spk, prof in profiles.items()]
                    spk, conf = S.window_hysteresis(sims, prev_by_seg[si])
                    prev_by_seg[si] = spk
                else:
                    spk = prev_by_seg[si] or "UNKNOWN"
                    conf = 0.0
                results[si].append((ws, we, spk, conf))
            # A segment without a window takes its file's first step.
            step = own[0][3] if own else self.config.sliding_window_step
            out.append([S.merge_window_labels(
                results[si], seg_start, seg_end,
                next((o[3] for o in own if o[0] == si), step))
                for si, (seg_start, seg_end) in enumerate(overlap_items)])
        return out

    def _separate_spans(self, clips: List[np.ndarray], sr: int
                        ) -> List[Optional[np.ndarray]]:
        """Every clip's [T, 2] sources, separated in duration-bucketed
        batches of 16 rows with their lengths. A call that fails with a
        non-fatal error leaves its rows None: they keep their mixed
        clips."""
        out: List[Optional[np.ndarray]] = [None] * len(clips)
        for idx, padded, lens in batch_audio(
                clips, sr, self.torch_config.duration_buckets, 16):
            try:
                sep = self.models.separate_batch(padded, lens)
                self._count_separation(padded, lens)
                for row, j in enumerate(idx):
                    out[j] = sep[row, : lens[row], :]
            except ProcessingCancelled:
                raise
            except Exception as exc:  # noqa: BLE001 → the mixed clip
                if is_fatal(exc):
                    raise
                logger.error("Separation failed: %s", exc)
        return out

    def _best_sources(self, sep_sources: List[Optional[np.ndarray]],
                      profiles: List[Optional[np.ndarray]], sr: int
                      ) -> List[Optional[Tuple[np.ndarray, float]]]:
        """Each separated span's peak-normalised source closest to its
        speaker's profile (``profiles``, aligned; a span without one takes
        its first embeddable source) with that similarity, None for a span
        without one: every span's sources embedded in one batch."""
        src_clips, src_owner = [], []
        for j, sep in enumerate(sep_sources):
            if sep is None:
                continue
            for k in range(sep.shape[-1]):
                src = sep[:, k]
                src = src / (np.max(np.abs(src)) + 1e-8)
                src_clips.append(src.astype(np.float32))
                src_owner.append(j)
        best: List[Optional[Tuple[np.ndarray, float]]] = \
            [None] * len(sep_sources)
        src_embs = self._embed_many(src_clips, sr, count="source_calls")
        for j, emb, clip in zip(src_owner, src_embs, src_clips):
            if emb is None:
                continue
            prof = profiles[j]
            simv = self._cos(emb, prof) if prof is not None else 1.0
            if best[j] is None or simv > best[j][1]:
                best[j] = (clip, simv)
        return best

    def _overlap_path(self, plans: List[Dict], timer: StageTimer,
                      should_cancel: Optional[Callable[[], bool]] = None
                      ) -> List[Dict]:
        """Resegmentation, separation and the sources' embeddings of the
        overlap segments of every file in ``plans``, each phase one batched
        pass over all the files' work, with a cancel check before each.
        Returns per plan its spans per overlap segment (``spans_per_seg``),
        each span's mixed clip (``span_clips``) and its best source with
        that source's similarity, or None (``best_source``)."""
        sr = plans[0]["sr"]
        check_cancel(should_cancel)
        # The two ranges keep their per-file names at any timer's scope.
        with timer.stage("overlap_reseg", scope="file"):
            spans = self._resegment_overlaps(
                [(p["audio"], [p["refined"][i][:2] for i in p["ov_idx"]],
                  p["mapped_profiles"],
                  (p["store"], p["srow"]) if p["store"] is not None
                  and p["srow"] is not None else None) for p in plans], sr)
        out = [dict(spans_per_seg=sp, span_clips=[]) for sp in spans]
        clips, profiles = [], []
        for p, o in zip(plans, out):
            for seg_spans in o["spans_per_seg"]:
                for ss, se, sspk in seg_spans:
                    o["span_clips"].append(
                        S.extract_segment(p["audio"], ss, se, sr))
                    profiles.append(p["mapped_profiles"].get(sspk))
            clips.extend(o["span_clips"])
        check_cancel(should_cancel)
        with timer.stage("separation", scope="file"):
            sep_sources = self._separate_spans(clips, sr)
        check_cancel(should_cancel)
        with timer.stage("source_embeds"):
            best = self._best_sources(sep_sources, profiles, sr)
        base = 0
        for o in out:
            n = len(o["span_clips"])
            o["best_source"] = best[base: base + n]
            base += n
        return out

    # ------------------------------------------------------------ main
    def process_file(self, file_path: str,
                     should_cancel: Optional[Callable[[], bool]] = None
                     ) -> Optional[Dict]:
        """Single-file entry (back/api.py:1298): the one-file case of
        process_files."""
        return self.process_files([file_path], should_cancel)[0]

    def process_files(self, file_paths: List[str],
                      should_cancel: Optional[Callable[[], bool]] = None
                      ) -> List[Optional[Dict]]:
        """Batched multi-file processing: the analysis phases run over all
        files together, then ALL files' transcription items merge into one
        wavefront so segments of different requests share device batches.
        Returns one result dict per file, None for a file that failed."""
        # The whole call, lock and joins included, as one profiler range;
        # last_run_stage_times keeps the stages inside it.
        with StageTimer().stage("process_files"), self._run_lock:
            if hasattr(self.models, "config"):
                self.models.config = self.config
            if hasattr(self.models, "should_cancel"):
                self.models.should_cancel = should_cancel
            try:
                return self._process_files_inner(file_paths, should_cancel)
            finally:
                if hasattr(self.models, "should_cancel"):
                    self.models.should_cancel = None
                # Join the run's gated-audio download even on the cancel or
                # error path, so it never outlives the run.
                for a in self._inflight_hosts:
                    if hasattr(a, "wait"):
                        a.wait()
                self._inflight_hosts = []

    def _process_files_inner(self, file_paths: List[str],
                             should_cancel: Optional[Callable[[], bool]] = None
                             ) -> List[Optional[Dict]]:
        from clearconverse_tpu_torch.audio.decode import load_audio_many
        from clearconverse_tpu_torch.pipeline.diarize import (
            diarize_many, file_activities)

        # A task cancelled before the run starts pays no device work.
        check_cancel(should_cancel)
        # Run-level stage clock over the shared batched phases, exposed as
        # self.last_run_stage_times.
        run_timer = StageTimer()
        self.last_run_stage_times = run_timer.as_dict()
        sr0 = self.config.target_sample_rate
        store = None
        row_map: List[Optional[int]] = [None] * len(file_paths)
        load_sub: Dict[str, float] = {}
        # What crossed the audio wire this run (format, width, bytes) and
        # how its batch was staged (rows read as they are, rows converted,
        # the staging buffer reused).
        self.last_run_wire: Dict[str, object] = {}
        self.last_run_separation = _new_separation_counts()
        if hasattr(self.models, "last_decode"):
            # Voxtral's decode counters add up over this pass's calls.
            self.models.last_decode = {}
        if getattr(self.models, "supports_store", False):
            with run_timer.stage("load_gate"):
                # Hosts come back as LazyAudio views: the gated batch stays
                # on the device and is downloaded only when read.
                hosts, dev_batch, row_map = load_audio_many(
                    file_paths, sr0, self.config.noise_reduction_amount,
                    return_device=True, stage_times=load_sub,
                    host_async=True, wire_info=self.last_run_wire,
                    staging_info=self.last_run_wire, device=self.device)
            if dev_batch is not None:
                # The gated audio stays resident: decode, segmentation and
                # embedding batches gather windows from it.
                try:
                    with run_timer.stage("make_store"):
                        store = self.models.make_store(dev_batch, sr0)
                except ProcessingCancelled:
                    raise
                except Exception as exc:  # noqa: BLE001 — host fallback
                    if is_fatal(exc):
                        raise
                    logger.error("audio store failed: %s", exc)
        else:
            with run_timer.stage("load_gate"):
                hosts = load_audio_many(file_paths, sr0,
                                        self.config.noise_reduction_amount,
                                        stage_times=load_sub,
                                        wire_info=self.last_run_wire,
                                        staging_info=self.last_run_wire,
                                        device=self.device)
        # (load_sub spans are appended at the end of the run: the async
        # download's timings land after load_gate closes.)
        self._inflight_hosts = [h for h in hosts if h is not None]
        loaded: List[Optional[Tuple]] = [
            (w, sr0) if w is not None else None for w in hosts]
        ok = [i for i, l in enumerate(loaded) if l is not None]
        preloads: List[Optional[Dict]] = [None] * len(file_paths)
        # A failed shared phase degrades to _prepare_file's per-file
        # analysis (and its per-file None, api.py:1546), never errors the
        # whole group — unless the failure is fatal (is_fatal).
        for i in ok:
            preloads[i] = dict(audio=loaded[i][0], sr=loaded[i][1],
                               store=store, store_row=row_map[i])
        try:
            with self._phase(run_timer, "segmentation"):
                acts = file_activities(
                    self.models, [loaded[i][0] for i in ok], loaded[ok[0]][1],
                    store=store,
                    store_rows=[row_map[i] for i in ok]) if ok else []
            for i, act in zip(ok, acts):
                preloads[i]["activity"] = act
        except ProcessingCancelled:
            raise
        except Exception as exc:  # noqa: BLE001 — per-file fallback
            if is_fatal(exc):
                raise
            logger.error("batched segmentation failed: %s", exc, exc_info=True)
        hyst = self._diar_kwargs()
        with_act = [i for i in ok if "activity" in preloads[i]]
        if with_act:
            try:
                # One embedding call for all files' subsegments; clustering
                # stays per file.
                with self._phase(run_timer, "diarize_cluster"):
                    many = diarize_many(
                        self.models, [preloads[i]["audio"] for i in with_act],
                        preloads[with_act[0]]["sr"],
                        self.config.min_speakers, self.config.max_speakers,
                        activities=[preloads[i]["activity"] for i in with_act],
                        store=store,
                        store_rows=[row_map[i] for i in with_act],
                        **hyst)
                for i, raw in zip(with_act, many):
                    if raw is not None:   # None → that file's clustering
                        # failed; _prepare_file re-diarizes it per file.
                        preloads[i]["raw_segments"] = raw
            except ProcessingCancelled:
                raise
            except Exception as exc:  # noqa: BLE001 — fall back in-prep
                if is_fatal(exc):
                    raise
                logger.error("batched diarize failed: %s", exc, exc_info=True)
        with_raw = [i for i in ok
                    if preloads[i] and "raw_segments" in preloads[i]]
        if with_raw:
            try:
                with self._phase(run_timer, "profiles"):
                    profs = self._build_profiles_many(
                        [(preloads[i]["audio"], preloads[i]["raw_segments"])
                         for i in with_raw], loaded[with_raw[0]][1],
                        store_refs=[(store, row_map[i])
                                    if store is not None
                                    and row_map[i] is not None
                                    else None for i in with_raw])
                for i, prof in zip(with_raw, profs):
                    preloads[i]["profiles"] = prof
            except ProcessingCancelled:
                raise
            except Exception as exc:  # noqa: BLE001 — per-file fallback
                if is_fatal(exc):
                    raise
                logger.error("batched profiles failed: %s", exc, exc_info=True)

        # Plan every file on the host, then embed ALL files' non-overlap
        # segments in one batched call.
        plans: List[Optional[Dict]] = [None] * len(file_paths)
        with run_timer.stage("plan_files"):
            for i, (p, pre) in enumerate(zip(file_paths, preloads)):
                if pre is None:
                    continue
                try:
                    plans[i] = self._plan_file(p, should_cancel,
                                               preloaded=pre, index=i)
                    # Snapshot the per-file timer now: _prepare_file keeps
                    # appending to it.
                    plans[i]["_plan_spans"] = dict(
                        plans[i]["timer"].as_dict())
                except ProcessingCancelled:
                    raise
                except Exception as exc:  # noqa: BLE001 — per-file
                    if is_fatal(exc):
                        raise
                    logger.error("Error in process_file: %s", exc,
                                 exc_info=True)
                    preloads[i] = None
        embs_per_file: List[Optional[Dict]] = [None] * len(file_paths)
        jobs = [(i, si) for i, plan in enumerate(plans) if plan is not None
                for si in plan["non_ov_idx"]]
        if jobs:
            try:
                with self._phase(run_timer, "segment_embeds"):
                    embs = self._embed_many(
                        [plans[i]["seg_audio"][si] for i, si in jobs],
                        plans[jobs[0][0]]["sr"],
                        refs=[plans[i]["seg_ref"](plans[i]["refined"][si][0],
                                                  plans[i]["refined"][si][1])
                              for i, si in jobs])
                for (i, si), emb in zip(jobs, embs):
                    if embs_per_file[i] is None:
                        embs_per_file[i] = {}
                    embs_per_file[i][si] = emb
            except ProcessingCancelled:
                raise
            except Exception as exc:  # noqa: BLE001 — per-file fallback
                if is_fatal(exc):
                    raise
                logger.error("batched segment embeddings failed: %s", exc,
                             exc_info=True)
                embs_per_file = [None] * len(file_paths)
        # The overlap path once for the pass: every file's windows, spans
        # and sources share device batches. Its spans, as a file's own,
        # land under prepare_files.*.
        overlap_timer = StageTimer()
        overlaps: List[Optional[Dict]] = [None] * len(file_paths)
        with self._phase(run_timer, "prepare_files"):
            planned = [i for i, plan in enumerate(plans) if plan is not None]
            if planned:
                try:
                    shares = self._overlap_path([plans[i] for i in planned],
                                                overlap_timer, should_cancel)
                    for i, share in zip(planned, shares):
                        overlaps[i] = share
                except ProcessingCancelled:
                    raise
                except Exception as exc:  # noqa: BLE001 — per-file fallback
                    if is_fatal(exc):
                        raise
                    logger.error("batched overlap path failed: %s", exc,
                                 exc_info=True)
            preps = [self._prepare_file(p, should_cancel, preloaded=pre,
                                        plan=plans[i],
                                        seg_embs=embs_per_file[i],
                                        overlap=overlaps[i])
                     if pre is not None else None
                     for i, (p, pre) in enumerate(zip(file_paths, preloads))]
        with run_timer.stage("merge"):
            # Per-file sub-stages summed across files, with the pass's
            # overlap path: spans recorded during plan_files as
            # plan_files.*, the rest as prepare_files.* (the two phases
            # share one timer per file).
            prep_sub: Dict[str, float] = overlap_timer.as_dict()
            plan_sub: Dict[str, float] = {}
            for plan in plans:
                if plan is not None:
                    for k, v in plan.get("_plan_spans", {}).items():
                        plan_sub[k] = plan_sub.get(k, 0.0) + v
            for prep, plan in zip(preps, plans):
                if prep is None:
                    continue
                snap = plan.get("_plan_spans", {}) if plan is not None else {}
                for k, v in prep["timer"].as_dict().items():
                    delta = v - snap.get(k, 0.0)
                    if delta > 0:
                        prep_sub[k] = prep_sub.get(k, 0.0) + delta
            for k, v in plan_sub.items():
                run_timer.spans.append((f"plan_files.{k}", v))
            for k, v in prep_sub.items():
                run_timer.spans.append((f"prepare_files.{k}", v))
            merged: List[Dict] = []
            offsets: List[int] = []
            for prep in preps:
                offsets.append(len(merged))
                if prep is None:
                    continue
                off = len(merged)
                for it in prep["items"]:
                    it = dict(it)
                    if it["depends_on"] is not None:
                        it["depends_on"] += off
                    merged.append(it)
            # Start the gated-audio download now, under the decode
            # wavefront: _finalize needs the bytes, and the decode moves
            # little else.
            for a in self._inflight_hosts:
                if hasattr(a, "prefetch"):
                    a.prefetch()
        if merged:
            sr = next(p["sr"] for p in preps if p is not None)
            with self._phase(run_timer, "decode_wavefront"):
                self._transcribe_wavefront(merged, sr, should_cancel)
        results: List[Optional[Dict]] = []
        # The first read of host bytes (lazy views wait for the async
        # download here), then the download's join and flush.
        with run_timer.stage("finalize"):
            for prep, off in zip(preps, offsets):
                if prep is None:
                    results.append(None)
                    continue
                n = len(prep["items"])
                for local, it in zip(prep["items"], merged[off : off + n]):
                    local["text"] = it.get("text", "")
                try:
                    results.append(self._finalize(prep))
                except ProcessingCancelled:
                    raise
                except Exception as exc:  # noqa: BLE001 — per-file
                    # isolation: _finalize is the first host-byte access on
                    # store paths, so a failed download surfaces here; that
                    # file becomes None.
                    if is_fatal(exc):
                        raise
                    logger.error("finalize failed for %s: %s",
                                 file_paths[len(results)], exc)
                    results.append(None)
            for pre in preloads:
                if pre is not None:
                    a = pre.get("audio")
                    if hasattr(a, "wait"):
                        a.wait()      # the shared download ends with the run
                    flush = getattr(a, "stats_flush", None)
                    if flush is not None:
                        flush()   # one flush covers the shared batch download
                        break
        for k, v in load_sub.items():   # sub-decomposition of load_gate
            run_timer.spans.append((f"load_gate.{k}", v))
        self.last_run_stage_times = run_timer.as_dict()
        return results

    def _plan_file(self, file_path: str,
                   should_cancel: Optional[Callable[[], bool]] = None,
                   preloaded: Optional[Dict] = None,
                   index: Optional[int] = None) -> Dict:
        """Analysis planning for one file: load / vad / diarization /
        profiles (normally preloaded by process_files' batched phases)
        through segment classification. Raises on failure; the caller owns
        per-file isolation. ``index``, the file's place in its run, goes
        with the profiler ranges of the file's spans."""
        cfg = self.config
        timer = StageTimer(scope="file",
                           args=None if index is None else {"file": index})

        def ck():  # one cancel check per analysis stage boundary
            check_cancel(should_cancel)

        from clearconverse_tpu_torch.audio.decode import ensure_wav_format, load_audio
        pre = preloaded or {}
        activity = pre.get("activity")
        with timer.stage("load_audio"):
            if "audio" in pre:
                audio, sr = pre["audio"], pre["sr"]
            else:
                file_path = ensure_wav_format(file_path)
                wave, sr = load_audio(file_path, cfg.target_sample_rate,
                                      cfg.noise_reduction_amount,
                                      device=self.device)
                audio = wave.cpu().numpy().astype(np.float32)
        duration = len(audio) / sr
        logger.info("Processing audio file: %.2f seconds", duration)

        hyst = self._diar_kwargs()
        vad_kw = {k: v for k, v in hyst.items() if k in ("onset", "offset")}
        ck()
        with timer.stage("vad"):
            if activity is None:
                activity = file_activity(self.models, audio, sr)
            vad = vad_intervals(self.models, audio, sr,
                                activity=activity, **vad_kw)
        ck()
        with timer.stage("diarization"):
            raw_segments = pre.get("raw_segments")
            if raw_segments is None:
                raw_segments = diarize(self.models, audio, sr,
                                       cfg.min_speakers, cfg.max_speakers,
                                       activity=activity, **hyst)
        logger.info("Diarization found %d raw segments", len(raw_segments))

        merged = S.merge_segments(raw_segments, cfg.merge_gap_threshold)
        if cfg.use_vad_refinement:
            refined = []
            for start, end, spk in merged:
                r = S.refine_segment_with_vad((start, end), vad)
                if r and (r[1] - r[0]) >= cfg.min_segment_duration:
                    refined.append((r[0], r[1], spk))
        else:
            refined = merged

        ck()
        with timer.stage("profiles"):
            profiles = pre.get("profiles")
            if profiles is None:
                profiles = self._build_profiles(audio, sr, raw_segments)
        mapping = S.map_speakers(refined)
        overlap_regions = S.detect_overlap_regions(raw_segments,
                                                   cfg.overlap_threshold)
        refined.sort(key=lambda x: x[0])

        # ---------- phase 1: classify segments ----------------------------
        # Device-resident audio refs: (store, row, start-sample) per segment
        # when the clip is a clean contiguous slice; with a store, segment
        # clips stay lazy until a host-only path reads their bytes.
        store, srow = pre.get("store"), pre.get("store_row")
        seg_audio = [(S.extract_segment_lazy(audio, s, e, sr)
                      if store is not None and srow is not None
                      else S.extract_segment(audio, s, e, sr))
                     for s, e, _ in refined]
        duration_all = len(audio) / sr

        def seg_ref(s, e):
            if store is None or srow is None:
                return None
            i0 = int(max(s, 0.0) * sr)
            i1 = int(min(e, duration_all) * sr)
            return (store, srow, i0) if i0 < i1 else None
        is_overlap: List[bool] = []
        involved: List[List[str]] = []
        for (s, e, _spk) in refined:
            hit = next(((os_, oe, spks) for os_, oe, spks in overlap_regions
                        if max(s, os_) < min(e, oe)), None)
            is_overlap.append(hit is not None)
            involved.append(hit[2] if hit else [])

        long_enough = [(e - s) >= cfg.min_segment_duration
                       for s, e, _ in refined]
        non_ov_idx = [i for i, ov in enumerate(is_overlap)
                      if not ov and long_enough[i]]
        ov_idx = [i for i, ov in enumerate(is_overlap)
                  if ov and long_enough[i]]
        timer.spans.append(("classify", 0.0))
        return dict(file_path=file_path, timer=timer, audio=audio, sr=sr,
                    duration=duration, hyst=hyst, refined=refined,
                    profiles=profiles, mapping=mapping, seg_audio=seg_audio,
                    store=store, srow=srow, seg_ref=seg_ref,
                    is_overlap=is_overlap, involved=involved,
                    non_ov_idx=non_ov_idx, ov_idx=ov_idx,
                    mapped_profiles={mapping.get(k, k): v
                                     for k, v in profiles.items()})

    def _prepare_file(self, file_path: str,
                      should_cancel: Optional[Callable[[], bool]] = None,
                      preloaded: Optional[Dict] = None,
                      plan: Optional[Dict] = None,
                      seg_embs: Optional[Dict] = None,
                      overlap: Optional[Dict] = None) -> Optional[Dict]:
        """Turn one file's analysis plan into transcription items.
        ``plan``/``seg_embs``/``overlap`` (its share of ``_overlap_path``)
        come from process_files' batched phases; without them the whole
        per-file path runs here."""
        cfg = self.config

        def ck():  # one cancel check per analysis stage boundary
            check_cancel(should_cancel)

        try:
            if plan is None:
                plan = self._plan_file(file_path, should_cancel, preloaded)
            timer = plan["timer"]
            sr, duration, hyst = plan["sr"], plan["duration"], plan["hyst"]
            refined, profiles = plan["refined"], plan["profiles"]
            mapping, seg_audio = plan["mapping"], plan["seg_audio"]
            seg_ref = plan["seg_ref"]
            is_overlap, involved = plan["is_overlap"], plan["involved"]
            non_ov_idx, ov_idx = plan["non_ov_idx"], plan["ov_idx"]

            ck()
            with timer.stage("segment_embeddings"):
                if seg_embs is not None:     # cross-file batched embeddings
                    embs = [seg_embs.get(i) for i in non_ov_idx]
                else:
                    embs = self._embed_many(
                        [seg_audio[i] for i in non_ov_idx], sr,
                        refs=[seg_ref(refined[i][0], refined[i][1])
                              for i in non_ov_idx])
            needs_secondary: Dict[int, bool] = {}
            for i, emb in zip(non_ov_idx, embs):
                if emb is None:   # too short to embed → no rescue (api.py:1407)
                    needs_secondary[i] = False
                    continue
                prof = profiles.get(refined[i][2])
                # A missing profile counts as similarity 0 → secondary
                # diarization (api.py:1412-1414).
                sim = self._cos(emb, prof) if prof is not None else 0.0
                needs_secondary[i] = sim < cfg.secondary_diarization_threshold

            secondary: Dict[int, List[S.LabeledSegment]] = {}
            ck()
            with timer.stage("secondary_diarization"):
                for i, flagged in needs_secondary.items():
                    if not flagged:
                        continue
                    s, e, _ = refined[i]
                    try:
                        subs = diarize(self.models, seg_audio[i], sr, 1, 2,
                                       **hyst)
                        subs = S.merge_segments(subs, cfg.merge_gap_threshold) \
                            if subs else [(0.0, e - s, "UNKNOWN")]
                    except ProcessingCancelled:
                        raise
                    except Exception as exc:  # → UNKNOWN (back/api.py:1135-1137)
                        if is_fatal(exc):
                            raise
                        logger.error("Secondary diarization failed: %s", exc)
                        subs = [(0.0, e - s, "UNKNOWN")]
                    secondary[i] = subs

            # Overlap resegmentation, separation and source embeddings.
            if overlap is None:
                overlap = self._overlap_path([plan], timer, should_cancel)[0]
            spans_per_seg = overlap["spans_per_seg"]
            span_clips = overlap["span_clips"]
            best_source = overlap["best_source"]

            # ---------- phase 2: build transcription items ---------------
            items: List[Dict] = []      # chronological work items
            prev_end, prev_speaker, prev_item = 0.0, None, None
            meta_counts: Dict[str, int] = {"SPEAKER_A": 0, "SPEAKER_B": 0}
            span_cursor = 0

            for i, (seg_start, seg_end, orig_spk) in enumerate(refined):
                if (seg_end - seg_start) < cfg.min_segment_duration:
                    continue
                spk_label = mapping.get(orig_spk, "UNKNOWN")
                rapid = S.is_rapid_exchange(prev_speaker, orig_spk, prev_end, seg_start)

                if not is_overlap[i]:
                    if secondary.get(i):
                        for (rs, re_, new_spk) in secondary[i]:
                            clip = S.extract_segment(seg_audio[i], rs, re_, sr)
                            dep = (prev_item if new_spk == prev_speaker
                                   and (seg_start - prev_end) < 1.0 and not rapid else None)
                            prompt = (S.RAPID_PROMPT if rapid
                                      else (None if dep is not None else S.SECONDARY_PROMPT))
                            final = mapping.get(new_spk, spk_label)
                            items.append(dict(
                                start=seg_start + rs, end=seg_start + re_,
                                speaker=final, audio=clip, is_overlap=False,
                                prompt=prompt, depends_on=dep,
                                rapid=rapid, confidence=1.0,
                                metadata={"rapid_exchange": rapid}))
                            meta_counts[final] = meta_counts.get(final, 0) + 1
                            prev_end, prev_speaker = seg_start + re_, new_spk
                            prev_item = len(items) - 1
                        continue

                    dep = (prev_item if orig_spk == prev_speaker
                           and (seg_start - prev_end) < 1.0 and not rapid else None)
                    prompt = (S.RAPID_PROMPT if rapid
                              else (None if dep is not None else S.DEFAULT_PROMPT))
                    items.append(dict(
                        start=seg_start, end=seg_end, speaker=spk_label,
                        audio=seg_audio[i], is_overlap=False, prompt=prompt,
                        depends_on=dep, rapid=rapid, confidence=1.0,
                        store_ref=seg_ref(seg_start, seg_end),
                        metadata={"rapid_exchange": rapid}))
                    meta_counts[spk_label] = meta_counts.get(spk_label, 0) + 1
                    prev_end, prev_speaker = seg_end, orig_spk
                    prev_item = len(items) - 1
                else:
                    # Context reset after overlap (back/api.py:1503-1505).
                    prev_speaker, prev_item = None, None
                    pos = ov_idx.index(i)
                    for (ss, se, sspk) in spans_per_seg[pos]:
                        j = span_cursor
                        span_cursor += 1
                        clip, conf = best_source[j] or (span_clips[j], 0.0)
                        items.append(dict(
                            start=seg_start, end=seg_end, speaker=sspk,
                            audio=clip, is_overlap=True,
                            prompt=S.OVERLAP_PROMPT, depends_on=None,
                            rapid=False, confidence=conf,
                            metadata={"overlap_speakers":
                                      [mapping.get(s_, s_) for s_ in involved[i]]}))
                    prev_end = seg_end

            return {"items": items, "sr": sr, "duration": duration,
                    "mapping": mapping, "meta_counts": meta_counts,
                    "timer": timer}
        except ProcessingCancelled:
            raise
        except Exception as exc:  # noqa: BLE001 — reference returns None (api.py:1546)
            if is_fatal(exc):
                raise
            logger.error("Error in process_file: %s", exc, exc_info=True)
            return None

    def _finalize(self, prep: Dict) -> Dict:
        items, timer = prep["items"], prep["timer"]
        # AudioSegment.audio is a public np.ndarray: lazy views materialize
        # here, at the pipeline boundary.
        processed = [S.AudioSegment(
            start=it["start"], end=it["end"], speaker_id=it["speaker"],
            audio=np.asarray(it["audio"], np.float32),
            is_overlap=it["is_overlap"],
            transcription=it.get("text", ""), confidence=it["confidence"],
            metadata=it["metadata"]) for it in items]
        processed.sort(key=lambda x: x.start)

        metadata = {
            "duration": prep["duration"],
            "speaker_a_segments": prep["meta_counts"].get("SPEAKER_A", 0),
            "speaker_b_segments": prep["meta_counts"].get("SPEAKER_B", 0),
            "total_segments": len(processed),
            "speakers": list(prep["mapping"].values()),
            "rapid_exchanges": sum(1 for s_ in processed
                                   if s_.metadata.get("rapid_exchange", False)),
            "stage_times": timer.as_dict(),
        }
        if logger.isEnabledFor(logging.INFO):
            logger.info("pipeline stages: %s", timer.summary())
        return {"segments": processed, "metadata": metadata}

    def _transcribe_wavefront(self, items: List[Dict], sr: int,
                              should_cancel: Optional[Callable[[], bool]] = None
                              ) -> None:
        """Resolve context-chained prompts in generations; each generation is
        one set of bucket-batched decode calls, with a cancel check between
        batches.

        Segments longer than whisper's 30 s window decode through the
        timestamp-seek path: each window decodes with timestamp tokens,
        keeps its text up to its last complete segment, and the next window
        starts at that segment's end (whisper transcribe's seek loop,
        reached via back/api.py:1474-1480), so window seams drop no words.
        Successive windows chain on each other's tokens
        (condition_on_previous_text). Bundles without
        ``transcribe_long_batch`` (test fakes), and those that do not seek
        (``seeks`` false: Voxtral), take fixed 30 s cuts."""
        from clearconverse_tpu_torch.audio.decode import lazy_slice
        from clearconverse_tpu_torch.pipeline.batching import split_long

        long_ok = (hasattr(self.models, "transcribe_long_batch")
                   and getattr(self.models, "seeks", True))
        win = int(30.0 * sr)
        buckets = self.torch_config.duration_buckets
        batch_size = self.config.transcription_batch_size

        # Expand items into decode units. A long item starts with ONE window
        # unit; each successor is appended when its predecessor resolves
        # (its start depends on the decoded seek).
        units: List[Dict] = []
        item_units: List[List[int]] = []
        for i, it in enumerate(items):
            audio = it["audio"]          # may be lazy
            ref = it.get("store_ref")
            unit_ids = []
            if long_ok and len(audio) > win:
                units.append(dict(item=i, audio=lazy_slice(audio, 0, win),
                                  text=None,
                                  prev_unit=None, long=True, cursor=0,
                                  sref=(ref + (min(win, len(audio)),)
                                        if ref else None)))
                unit_ids.append(len(units) - 1)
            else:
                for k, chunk in enumerate(split_long(audio, sr, 30.0)):
                    units.append(dict(
                        item=i, audio=chunk, text=None,
                        prev_unit=unit_ids[-1] if k else None, long=False,
                        sref=((ref[0], ref[1], ref[2] + k * win, len(chunk))
                              if ref else None)))
                    unit_ids.append(len(units) - 1)
            item_units.append(unit_ids)

        def item_text(i: int) -> str:
            # Skipped (no-speech) windows have empty text and must not leave
            # a double space in the joined transcript.
            parts = ((units[u]["text"] or "").strip()
                     for u in item_units[i])
            return " ".join(t for t in parts if t).strip()

        remaining = set(range(len(units)))
        while remaining:
            ready = []
            for u in remaining:
                unit = units[u]
                if unit["prev_unit"] is not None:
                    if unit["prev_unit"] in remaining:
                        continue
                else:
                    dep = items[unit["item"]]["depends_on"]
                    if dep is not None and any(v in remaining
                                               for v in item_units[dep]):
                        continue
                ready.append(u)
            if not ready:  # deps point backwards; cannot happen
                ready = list(remaining)

            def unit_prompt(u):
                unit = units[u]
                it = items[unit["item"]]
                if unit["prev_unit"] is not None:
                    # whisper transcribe's rolling prompt: all tokens decoded
                    # since the last prompt reset; the initial context
                    # survives until the first reset. Resets: conditioning
                    # off (after every window), or a window whose kept
                    # result decoded hotter than 0.5 (reset_after).
                    if not self.config.condition_on_previous_text:
                        return ""
                    ids = item_units[unit["item"]]
                    prior = ids[: ids.index(u)]
                    start = 0
                    for j, p in enumerate(prior):
                        if units[p].get("reset_after"):
                            start = j + 1
                    init = ""
                    if start == 0:
                        init = (it["prompt"] if it["prompt"] is not None
                                else f"{item_text(it['depends_on'])} ")
                    window = prior[start:]
                    if window and all(units[p].get("ctx_tokens") is not None
                                      for p in window):
                        # Token-level chaining: the kept ids, timestamps
                        # included, go back as a (init_text, ids) prompt.
                        toks: List[int] = []
                        for p in window:
                            toks.extend(units[p]["ctx_tokens"])
                        if toks or init.strip():
                            return (init, toks)
                        return ""
                    body = " ".join((units[p]["text"] or "").strip()
                                    for p in window).strip()
                    parts = [p for p in (init.strip(), body) if p]
                    return f"{' '.join(parts)} " if parts else ""
                if it["prompt"] is not None:
                    return it["prompt"]
                return f"{item_text(it['depends_on'])} "

            def store_groups(uids, fixed_bucket=None):
                """Group store-ref'd units into StoreBatch device batches."""
                from clearconverse_tpu_torch.pipeline.bundle import iter_store_batches
                refs = [units[u]["sref"] for u in uids]
                for sub, sb in iter_store_batches(
                        refs, [r[3] for r in refs], sr, buckets, batch_size,
                        fixed_bucket=fixed_bucket):
                    yield [uids[j] for j in sub], sb

            def spawn_next_window(u, advance_s):
                """Append the successor window after a long window resolves
                (its start = this window's last complete segment end)."""
                unit = units[u]
                i = unit["item"]
                total = len(items[i]["audio"])
                cursor = unit["cursor"] + int(advance_s * sr)
                if total - cursor <= int(0.1 * sr):
                    return
                base = items[i].get("store_ref")
                units.append(dict(
                    item=i, text=None, prev_unit=u, long=True, cursor=cursor,
                    audio=lazy_slice(items[i]["audio"], cursor, cursor + win),
                    sref=((base[0], base[1], base[2] + cursor,
                           min(win, total - cursor)) if base else None)))
                nid = len(units) - 1
                item_units[i].append(nid)
                remaining.add(nid)

            def take_long(u, res):
                # res = (text, advance, reset_context, ctx_tokens) from the
                # bundle; test fakes may return bare (text, advance) pairs,
                # which chain at the text level.
                text, advance_s, *rest = res
                units[u]["text"] = text
                units[u]["reset_after"] = bool(rest and rest[0])
                units[u]["ctx_tokens"] = rest[1] if len(rest) > 1 else None
                spawn_next_window(u, advance_s)

            short = [u for u in ready if not units[u].get("long")]
            longs = [u for u in ready if units[u].get("long")]
            s_host = [u for u in short if not units[u]["sref"]]
            s_store = [u for u in short if units[u]["sref"]]
            l_host = [u for u in longs if not units[u]["sref"]]
            l_store = [u for u in longs if units[u]["sref"]]

            clips = [units[u]["audio"] for u in s_host]
            prompts = [unit_prompt(u) for u in s_host]
            for idx, padded, lens in batch_audio(clips, sr, buckets,
                                                 batch_size):
                check_cancel(should_cancel)
                texts = self.models.transcribe_batch(
                    padded, [prompts[j] for j in idx],
                    temperature=self.config.temperature)
                for row, j in enumerate(idx):
                    units[s_host[j]]["text"] = texts[row]

            for sub, sb in store_groups(s_store):
                check_cancel(should_cancel)
                texts = self.models.transcribe_batch(
                    sb, [unit_prompt(u) for u in sub],
                    temperature=self.config.temperature)
                for u, t in zip(sub, texts):
                    units[u]["text"] = t

            lclips = [units[u]["audio"] for u in l_host]
            lprompts = [unit_prompt(u) for u in l_host]
            for idx, padded, lens in batch_audio(lclips, sr, buckets,
                                                 batch_size):
                check_cancel(should_cancel)
                results = self.models.transcribe_long_batch(
                    padded, [lprompts[j] for j in idx], lens,
                    temperature=self.config.temperature)
                for row, j in enumerate(idx):
                    take_long(l_host[j], results[row])

            for sub, sb in store_groups(l_store, fixed_bucket=win):
                check_cancel(should_cancel)
                results = self.models.transcribe_long_batch(
                    sb, [unit_prompt(u) for u in sub],
                    temperature=self.config.temperature)
                for u, res in zip(sub, results):
                    take_long(u, res)
            remaining -= set(ready)

        for i in range(len(items)):
            items[i]["text"] = item_text(i)

    # ------------------------------------------------------------ outputs
    def save_segments(self, segs: List[S.AudioSegment], output_dir: str) -> None:
        """Per-segment WAV dumps (back/api.py:1139-1156 layout)."""
        from clearconverse_tpu_torch.audio.wav import write_wav
        out = Path(output_dir)
        (out / "regular_segments").mkdir(parents=True, exist_ok=True)
        (out / "overlap_segments").mkdir(parents=True, exist_ok=True)
        for seg in segs:
            ts = f"{seg.start:.2f}-{seg.end:.2f}"
            sub = "overlap_segments" if seg.is_overlap else "regular_segments"
            name = (f"overlap_{ts}_{seg.speaker_id}.wav" if seg.is_overlap
                    else f"{ts}_{seg.speaker_id}.wav")
            if seg.audio is not None and len(seg.audio):
                write_wav(str(out / sub / name), np.asarray(seg.audio),
                          self.config.target_sample_rate)

    def save_debug_segments(self, segs: List[S.AudioSegment], output_dir: str) -> None:
        """Debug dump with amplitude stats (back/api.py:1158-1202)."""
        from clearconverse_tpu_torch.audio.wav import write_wav
        debug = Path(output_dir) / "debug_segments"
        metadata = []
        for idx, seg in enumerate(segs):
            seg_id = f"segment_{idx:03d}"
            sub = debug / ("overlap" if seg.is_overlap else "regular")
            sub.mkdir(parents=True, exist_ok=True)
            wav_path = sub / f"{seg_id}.wav"
            a = np.asarray(seg.audio) if seg.audio is not None else np.zeros(1)
            write_wav(str(wav_path), a, self.config.target_sample_rate)
            metadata.append({
                "segment_id": seg_id,
                "start_time": f"{seg.start:.3f}",
                "end_time": f"{seg.end:.3f}",
                "duration": f"{seg.end - seg.start:.3f}",
                "speaker_id": seg.speaker_id,
                "is_overlap": seg.is_overlap,
                "transcription": seg.transcription,
                "audio_file": str(wav_path),
                "audio_stats": {
                    "max_amplitude": float(np.max(np.abs(a))),
                    "mean_amplitude": float(np.mean(np.abs(a))),
                    "samples": int(a.shape[-1]),
                },
            })
        debug.mkdir(parents=True, exist_ok=True)
        with open(debug / "segments_metadata.json", "w") as fh:
            json.dump(metadata, fh, indent=2)

    def _write_outputs(self, results: Dict, output_dir: str,
                       debug_mode: bool, cb: Callable):
        """The output tail of run(): segment dumps + transcript.txt
        (back/api.py:1244-1274 semantics)."""
        cb(60, "Saving processed segments")
        segs = results.get("segments") or []
        if not segs:
            logger.error("No segments were generated during processing")
            return None, None
        if not any(s.transcription and s.transcription.strip() for s in segs):
            logger.error("No transcriptions were generated for any segments")
            return None, None

        self.save_segments(segs, output_dir)
        if debug_mode:
            self.save_debug_segments(segs, output_dir)

        cb(80, "Saving transcript")
        transcript = ""
        for seg in segs:
            transcript += f"[{seg.speaker_id}] {seg.start:.2f}s - {seg.end:.2f}s\n"
            transcript += f"{seg.transcription}\n\n"
        if not transcript.strip():
            logger.error("Generated transcript is empty")
            return None, None
        transcript_path = os.path.join(output_dir, "transcript.txt")
        with open(transcript_path, "w", encoding="utf-8") as fh:
            fh.write(transcript)
        cb(100, "Processing completed")
        return transcript, transcript_path

    def run(self, input_file: str, output_dir: str = "processed_audio",
            debug_mode: bool = False,
            progress_callback: Optional[Callable] = None,
            should_cancel: Optional[Callable[[], bool]] = None):
        """Reference ``run`` contract (back/api.py:1204-1280): returns
        (input_file, transcript, transcript_path) or (None, None, None);
        progress at 5/30/60/80/100. ``should_cancel`` aborts between device
        batches by raising ProcessingCancelled."""
        def cb(pct, msg):
            if progress_callback:
                progress_callback(pct, msg)

        cb(5, "Starting processing")
        if not self.models_are_loaded():
            if not self.load_models_with_progress(progress_callback):
                return None, None, None
        os.makedirs(output_dir, exist_ok=True)

        cb(30, "Running file processing")
        results = self.process_file(input_file, should_cancel)
        if results is None:
            return None, None, None
        transcript, transcript_path = self._write_outputs(
            results, output_dir, debug_mode, cb)
        if transcript is None:
            return None, None, None
        return input_file, transcript, transcript_path

    def run_many(self, inputs: List[Tuple[str, str]],
                 progress_callbacks: Optional[List[Callable]] = None,
                 should_cancel: Optional[Callable[[], bool]] = None):
        """Grouped run: (input_file, output_dir) pairs processed with the
        transcription phase batched across files (process_files). Returns
        one (input_file, transcript, transcript_path) or (None, None, None)
        per input, the run() contract."""
        cbs = progress_callbacks or [None] * len(inputs)

        def cb(i, pct, msg):
            if cbs[i]:
                cbs[i](pct, msg)

        for i in range(len(inputs)):
            cb(i, 5, "Starting processing")
        if not self.models_are_loaded():
            if not self.load_models_with_progress(cbs[0]):
                return [(None, None, None)] * len(inputs)
        for i, (_, out_dir) in enumerate(inputs):
            os.makedirs(out_dir, exist_ok=True)
            cb(i, 30, "Running file processing")

        results = self.process_files([p for p, _ in inputs], should_cancel)
        out = []
        for i, ((path, out_dir), res) in enumerate(zip(inputs, results)):
            if res is None:
                out.append((None, None, None))
                continue
            transcript, tpath = self._write_outputs(
                res, out_dir, False, lambda pct, msg, i=i: cb(i, pct, msg))
            out.append((path, transcript, tpath) if transcript
                       else (None, None, None))
        return out
