"""ModelBundle: the engine's interface to the device.

Mirrors the JAX package's pipeline/bundle.py. The transcription program:
``transcribe_batch`` takes a batch of padded segments (host arrays or
windows into a device-resident ``AudioStore``) and runs pad/trim → log-mel
→ encoder → cross-KV → prefill → KV-cached token loop on the bundle's
device, with whisper's temperature / best_of / no-speech semantics on the
host; ``transcribe_long_batch`` decodes one ≤30 s window of a longer
segment with timestamp tokens (whisper's seek loop). The speaker half:
PyanNet segmentation (``segment_frames``) and ECAPA embeddings
(``embed_*``), from host batches or from store windows, with the same row
bucketing as the transcription program. The overlap half: RE-SepFormer
separation (``separate_batch``) and the word-timestamp alignment pass
(``transcribe_batch(word_timestamps=True)``). Greedy rungs with
``beam_size > 1`` decode by beam search (``models/decoding.beam_decode``);
multilingual models without a pinned language detect it per row first
(``detect_language_from_audio``). ``save_native`` / ``load_native`` keep
all four families in one ``torch.save`` file with a dims meta block.

On a (data, model) mesh (``TorchConfig.data_axis`` × ``model_axis`` > 1,
``parallel/``) every rank holds a bundle: batch rows split over ``data``
and the results are gathered, Whisper's decode runs on this rank's
tensor-parallel shard over ``model`` (which replaces the whole model once
per load, so a rank holds only its shard; language detection and word
alignment run on it too), and the speaker and separation models are
replicated. Under a serving controller (``parallel/serve.py``) rank 0's
batched calls are replayed on the other ranks first.
"""

from __future__ import annotations

import functools
import logging
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from clearconverse_tpu_torch.config import Config, TorchConfig
from clearconverse_tpu_torch.models.whisper import tensor_parallel
from clearconverse_tpu_torch.pipeline.cancel import ProcessingCancelled
from clearconverse_tpu_torch.utils.errors import is_fatal
from clearconverse_tpu_torch.utils.precision import pin_bf16_reductions
from clearconverse_tpu_torch.utils.tracing import StageTimer

logger = logging.getLogger(__name__)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _unpack_decode(out: dict, max_tokens: int):
    """Fetch a greedy_decode result with ONE device→host copy via its
    "packed" [B, max_tokens+3] int32 array. Results without "packed" (test
    stand-ins) fall back to per-key fetches."""
    if "packed" not in out:
        return (_host(out["tokens"]), _host(out["lengths"]),
                _host(out["sum_logprob"]), _host(out["no_speech_prob"]))
    pk = _host(out["packed"])
    return (pk[:, :max_tokens], pk[:, max_tokens],
            pk[:, max_tokens + 1].copy().view(np.float32),
            pk[:, max_tokens + 2].copy().view(np.float32))


def _row_bucket(n: int) -> int:
    """Next power-of-two row count: every device batch pads to one of a tiny
    set of shapes."""
    b = 1
    while b < n:
        b *= 2
    return b


def _pad_rows(arrays, fills, b: int):
    """Pad each array's leading axis to ``b`` rows with its ``fills`` value
    (1 for lengths, so padded rows stay valid); returns (padded arrays,
    n_real)."""
    n_real = len(arrays[0])
    if b == n_real:
        return arrays, n_real
    out = []
    for a, fill in zip(arrays, fills):
        a = np.asarray(a)
        widths = [(0, b - n_real)] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(a, widths, constant_values=fill))
    return out, n_real


class AudioStore:
    """Gated full-file audio resident on the device as one ``[N, T+30 s]``
    tensor (30 s of trailing zeros so window gathers never clamp). Batch
    consumers pass (row, start, len) descriptors instead of audio."""

    def __init__(self, dev: torch.Tensor, sr: int):
        self.dev = dev
        self.sr = sr


class StoreBatch:
    """A batch of fixed-bucket windows into an AudioStore: (row, start,
    valid-len) per entry, with the row indexing/padding the transcribe
    fallback loop applies to plain arrays."""

    def __init__(self, store: AudioStore, rows, starts, lens, bucket: int):
        self.store = store
        self.bucket = int(bucket)
        self.rows = np.asarray(rows, np.int32)
        self.starts = np.asarray(starts, np.int32)
        self.lens = np.asarray(lens, np.int32)

    @property
    def shape(self):
        return (len(self.rows), self.bucket)

    def __getitem__(self, idx):
        return StoreBatch(self.store, self.rows[idx], self.starts[idx],
                          self.lens[idx], self.bucket)

    def pad_rows(self, extra: int) -> "StoreBatch":
        z = np.zeros(extra, np.int32)
        return StoreBatch(self.store,
                          np.concatenate([self.rows, z]),
                          np.concatenate([self.starts, z]),
                          np.concatenate([self.lens, np.ones(extra, np.int32)]),
                          self.bucket)

    def gather(self) -> torch.Tensor:
        """Device gather → [B, bucket]."""
        from clearconverse_tpu_torch.models.decoding import gather_windows
        dev = self.store.dev.device
        return gather_windows(self.store.dev,
                              torch.as_tensor(self.rows, device=dev),
                              torch.as_tensor(self.starts, device=dev),
                              torch.as_tensor(self.lens, device=dev),
                              self.bucket)


def iter_store_batches(refs, lens, sr, buckets, batch_size,
                       fixed_bucket=None):
    """Group (store, row, start) refs with per-item valid lengths by
    (store, duration bucket) into StoreBatch batches.

    Yields (original_indices, StoreBatch)."""
    from clearconverse_tpu_torch.pipeline.batching import pick_bucket
    groups = {}
    for i, (ref, n) in enumerate(zip(refs, lens)):
        b = (fixed_bucket if fixed_bucket is not None
             else int(pick_bucket(n / sr, buckets) * sr))
        groups.setdefault((id(ref[0]), b), []).append(i)
    for (_, b), ids in sorted(groups.items()):
        for lo in range(0, len(ids), batch_size):
            sub = ids[lo:lo + batch_size]
            yield sub, StoreBatch(refs[sub[0]][0],
                                  [refs[i][1] for i in sub],
                                  [refs[i][2] for i in sub],
                                  [max(min(lens[i], b), 1) for i in sub], b)


def _batched(fn):
    """Marks a bundle method that starts device work. Under a serving
    controller (``parallel/serve.py``) the call is replayed on every other
    rank before it runs here."""
    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        if self._controller is None:
            return fn(self, *args, **kwargs)
        return self._controller.call(self, fn, args, kwargs)
    return call


class ModelBundle:
    """Whisper, RE-SepFormer, PyanNet and ECAPA on one device (``cuda``
    unless the caller passes ``device="cpu"``). Lazy: ``_ensure`` loads on
    first use; ``load_with_progress`` follows the reference's staged
    percentages."""

    supports_store = True

    def __init__(self, config: Optional[Config] = None,
                 torch_config: Optional[TorchConfig] = None,
                 model_dir: str = "./models", device="cuda"):
        self.config = config or Config()
        self.torch_config = torch_config or TorchConfig()
        self.model_dir = model_dir
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ModelBundle: no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        pin_bf16_reductions()
        self._loaded = False
        # Where the weights came from on the last load: "checkpoint" or
        # "random_init".
        self.load_source: dict = {}
        self._whisper = None       # (Whisper module, dims, tokenizer)
        # (Voxtral module, dims, tokenizer) when Config.whisper_model_size
        # names Voxtral (models/voxtral.py); then ``_whisper`` stays None.
        self._voxtral = None
        self._sepformer = None     # Sepformer module (models/resepformer)
        self._ecapa = None         # ECAPA weights (models/ecapa)
        self._pyannet = None       # PyanNet weights (models/pyannet)
        # Dims default to the production configurations; tests inject
        # smaller ones alongside their weights.
        self._ecapa_dims = None
        self._pyannet_dims = None
        self._voxtral_dims = None
        # Cancel gate: the engine installs it per run, and every batched
        # compute method probes it before it starts device work.
        self.should_cancel: Optional[Callable[[], bool]] = None
        # Per-call sampling seed: fallback rungs draw fresh randomness on
        # every decode. One generator, reseeded on every sampling call; on
        # the card the decode graphs reseed their own from its seed.
        self._decode_seed = 0
        self._decode_gen: Optional[torch.Generator] = None
        # Wall-clock spans of the transcribe calls ("decode_dev" = device
        # program incl. the result copy). Totals only: the bundle lives as
        # long as the server.
        self._stage_timer = StageTimer(totals_only=True, scope="bundle")
        # When set, every decode call records its stages' spans here (see
        # decoding.greedy_decode); StageTimer(sync=True) times device work.
        self.decode_timer: Optional[StageTimer] = None
        # When set, the published separator records its spans here
        # (``sep.{encoder,seg_block,mem_block,decoder}``, see
        # resepformer.sepformer_separate).
        self.sep_timer: Optional[StageTimer] = None
        # What the last separate_batch call ran: rows after the row bucket,
        # samples, the published layout's segments, and the separator layers
        # that ran its two kernels (ops/sb_attention.py, ops/sb_ffn.py).
        self.last_separation: dict = {}
        # Voxtral's decode counters (decoding.voxtral_counts), summed over
        # the decode calls since the engine last cleared them (once a pass):
        # prefix_rows, prefix_positions, rows, steps, suffix_positions,
        # prefix_reads, fused_attn_layers (n_layer a call on the card);
        # prefix_copies, the most of any call.
        self.last_decode: dict = {}
        # The (data, model) mesh, built at first use from the TorchConfig
        # axes; the serving controller on rank 0 of a mesh.
        self._mesh = None
        self._mesh_built = False
        self._controller = None

    @property
    def seeks(self) -> bool:
        """Whether segments over 30 s take Whisper's timestamp seek
        (``transcribe_long_batch``); Voxtral's take the engine's fixed 30 s
        cuts."""
        return not self._is_voxtral()

    def _is_voxtral(self) -> bool:
        from clearconverse_tpu_torch.models.voxtral import is_voxtral
        return is_voxtral(self.config.whisper_model_size)

    @property
    def stage_times(self) -> dict:
        return self._stage_timer.as_dict()

    def _put(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), device=self.device)

    # ----------------------------------------------------------------- mesh
    @property
    def mesh(self):
        """The (data, model) mesh of the TorchConfig axes, built at first
        use (every rank of the process group must reach it together); None
        at 1×1. A mesh needs a process group with enough ranks and raises
        without one; this rank runs on the bundle's device."""
        if not self._mesh_built:
            cfg = self.torch_config
            if cfg.data_axis * cfg.model_axis > 1:
                import torch.distributed as dist
                from clearconverse_tpu_torch.parallel.mesh import build_mesh
                world = dist.get_world_size() if dist.is_initialized() else 1
                self._mesh = build_mesh(cfg.data_axis, cfg.model_axis,
                                        devices=[self.device] * world)
            self._mesh_built = True
        return self._mesh

    def _rows(self, n: int) -> int:
        """Row bucket, rounded up so the data axis divides it evenly."""
        rows = _row_bucket(n)
        d = self.torch_config.data_axis
        if d > 1 and rows % d:
            rows = -(-rows // d) * d
        return max(rows, d)

    def _pad(self, arrays, fills):
        """``_pad_rows`` to this bundle's row bucket."""
        return _pad_rows(arrays, fills, self._rows(len(arrays[0])))

    def _by_rows(self, fn, *arrays):
        """``fn`` over this data rank's block of rows of each host array
        (put on the device); its tensor result, or tuple of results,
        gathered over the data axis into host arrays."""
        from clearconverse_tpu_torch.parallel.mesh import DATA_AXIS
        from clearconverse_tpu_torch.parallel.sharding import batch_spec
        mesh = self.mesh
        split = mesh is not None and mesh.data > 1
        out = fn(*[self._put(batch_spec(np.asarray(a), mesh)) for a in arrays])
        outs = out if isinstance(out, tuple) else (out,)
        if split:
            outs = tuple(mesh.all_gather(o.contiguous(), DATA_AXIS)
                         for o in outs)
        outs = tuple(_host(o) for o in outs)
        return outs if isinstance(out, tuple) else outs[0]

    def _whisper_on_mesh(self):
        """(Whisper, dims, tokenizer) as this rank runs it: on a mesh with
        model > 1, this rank's tensor-parallel shard, which replaces a
        whole model (once per load) so that the rank holds no more than
        its shard; the whole model otherwise."""
        model, dims, tok = self._whisper
        mesh = self.mesh
        if mesh is not None and mesh.model > 1 and \
                tensor_parallel(model) is None:
            from clearconverse_tpu_torch.parallel.sharding import shard_whisper
            model = shard_whisper(model, mesh)
            self._whisper = (model, dims, tok)
        return model, dims, tok

    @_batched
    def make_store(self, dev_audio, sr: int) -> AudioStore:
        """Wrap [N, T] gated audio as an AudioStore on the bundle's device,
        adding the 30 s zero tail window gathers rely on (on a mesh every
        rank holds the whole store)."""
        dev = torch.as_tensor(dev_audio, dtype=torch.float32,
                              device=self.device)
        return AudioStore(F.pad(dev, (0, 30 * sr)), sr)

    # ---------------------------------------------------------------- load
    def models_are_loaded(self) -> bool:
        return self._loaded

    @property
    def _cdt(self) -> torch.dtype:
        return (torch.bfloat16 if self.torch_config.compute_dtype == "bfloat16"
                else torch.float32)

    def load_with_progress(self, progress_callback: Optional[Callable] = None) -> bool:
        """The reference's staged load (back/api.py:617-655) and its
        percentages: separation (10) → Whisper and tokenizer (40) → speaker
        models (70) → done (100). Weights land on the device once;
        ``load_source`` names where each family's weights came from
        ("checkpoint" or "random_init")."""
        from clearconverse_tpu_torch.models.convert import (
            init_whisper, load_whisper)
        from clearconverse_tpu_torch.models.tokenizer import load_tokenizer

        def cb(pct, msg):
            if progress_callback:
                progress_callback(pct, msg)

        try:
            self.load_source = {}
            cb(10, "Loading separation model")
            self._sepformer = self._load_sepformer()
            cb(40, "Loading Whisper model")
            size = self.config.whisper_model_size
            if self._is_voxtral():
                self._voxtral = self._load_voxtral(size)
            else:
                model, dims = load_whisper(self.model_dir, size, self.device,
                                           self._cdt)
                if model is None:
                    logger.warning("no whisper checkpoint in %s; using "
                                   "random init", self.model_dir)
                    model = init_whisper(dims, 0, self.device, self._cdt)
                    self.load_source["whisper"] = "random_init"
                else:
                    self.load_source["whisper"] = "checkpoint"
                tok = load_tokenizer(self.model_dir,
                                     english=size.endswith(".en"))
                self.load_source["tokenizer"] = type(tok).__name__
                self._whisper = (model, dims, tok)
            cb(70, "Loading speaker models")
            self._ecapa = self._load_ecapa()
            self._pyannet = self._load_pyannet()
            cb(100, "Models loaded")
            self._loaded = True
            return True
        except Exception as exc:  # noqa: BLE001 — load failure is recoverable
            if is_fatal(exc):
                raise
            logger.exception("model loading failed")
            return False

    def _load_voxtral(self, name: str):
        """(Voxtral, dims, tokenizer): HF Voxtral weights from
        ``{model_dir}/{name}/*.safetensors`` (``convert.load_voxtral``) or
        a seeded random init, and the Tekken layout's byte tokenizer. One
        card: a (data, model) mesh is refused."""
        from clearconverse_tpu_torch.models import voxtral as vx
        from clearconverse_tpu_torch.models.convert import load_voxtral
        from clearconverse_tpu_torch.models.tokenizer import (
            TekkenByteTokenizer, TekkenSpecials)
        cfg = self.torch_config
        if cfg.data_axis * cfg.model_axis > 1:
            raise ValueError("Voxtral runs on one card: no (data, model) "
                             "mesh")
        dims = self._voxtral_dims or vx.VOXTRALS[name]
        model = load_voxtral(self.model_dir, name, dims, self.device,
                             self._cdt)
        if model is None:
            logger.warning("no %s checkpoint in %s; using random init",
                           name, self.model_dir)
            model = vx.init_voxtral(dims, 0, self.device, self._cdt)
            self.load_source["voxtral"] = "random_init"
        else:
            self.load_source["voxtral"] = "checkpoint"
        tok = TekkenByteTokenizer(TekkenSpecials(n_vocab=dims.n_vocab))
        self.load_source["tokenizer"] = type(tok).__name__
        return model, dims, tok

    def _load_sepformer(self):
        """The separator ``TorchConfig.separator`` names. The sketch:
        ``{model_dir}/resepformer-ft/{encoder,masknet,decoder}.ckpt`` (the
        reference's fine-tuned triplet) or a seeded random init; the
        checkpoint's shapes give the dims, the head count and chunk size
        stay at the production defaults. ``"resepformer-wsj02mix"``, the
        published layout: a seeded random init (no checkpoint of it is
        read yet)."""
        import os
        from clearconverse_tpu_torch.models import resepformer as rsf
        from clearconverse_tpu_torch.models.convert import load_torch_state_dict
        name = self.torch_config.separator
        if name not in rsf.SEPARATORS:
            raise ValueError(f"unknown separator {name!r}; known: "
                             f"{sorted(rsf.SEPARATORS)}")
        dims = rsf.SEPARATORS[name]
        if isinstance(dims, rsf.ResepformerDims):
            self.load_source["sepformer"] = "random_init"
            model = rsf.init_resepformer(dims, seed=1, device=self.device)
            rsf.prepare_kernels(model)
            return model
        ft = os.path.join(self.model_dir, "resepformer-ft")
        names = ["encoder.ckpt", "masknet.ckpt", "decoder.ckpt"]
        if all(os.path.exists(os.path.join(ft, n)) for n in names):
            try:
                sds = [load_torch_state_dict(os.path.join(ft, n)) for n in names]
                tree = rsf.convert_speechbrain_sepformer(*sds)
                dims = rsf.infer_sepformer_dims(tree)
                self.load_source["sepformer"] = "checkpoint"
                return rsf.sepformer_from_jax_params(tree, dims, self.device)
            except Exception as exc:  # noqa: BLE001 — init fallback, as the JAX bundle
                if is_fatal(exc):
                    raise
                logger.warning("resepformer-ft load failed (%s); using init", exc)
        self.load_source["sepformer"] = "random_init"
        return rsf.init_sepformer(rsf.SepformerDims(), seed=1,
                                  device=self.device)

    def _load_ecapa(self):
        """``{model_dir}/embedding/embedding_model.ckpt`` (speechbrain) or a
        seeded random init."""
        import os
        from clearconverse_tpu_torch.models import ecapa
        from clearconverse_tpu_torch.models.convert import load_torch_state_dict
        ckpt = os.path.join(self.model_dir, "embedding", "embedding_model.ckpt")
        if os.path.exists(ckpt):
            try:
                tree = ecapa.convert_speechbrain_ecapa(load_torch_state_dict(ckpt))
                self._ecapa_dims = ecapa.infer_ecapa_dims(tree)
                self.load_source["ecapa"] = "checkpoint"
                return ecapa.ecapa_from_jax_params(tree, self.device)
            except Exception as exc:  # noqa: BLE001 — init fallback, as the JAX bundle
                if is_fatal(exc):
                    raise
                logger.warning("ecapa ckpt load failed (%s); using init", exc)
        self.load_source["ecapa"] = "random_init"
        return ecapa.init_ecapa(self._ecapa_dims or ecapa.EcapaDims(),
                                seed=2, device=self.device)

    def _load_pyannet(self):
        """``{model_dir}/segmentation/pytorch_model.bin`` (pyannote) or a
        seeded random init."""
        import os
        from clearconverse_tpu_torch.models import pyannet
        from clearconverse_tpu_torch.models.convert import load_torch_state_dict
        ckpt = os.path.join(self.model_dir, "segmentation", "pytorch_model.bin")
        if os.path.exists(ckpt):
            try:
                tree = pyannet.convert_pyannote_pyannet(load_torch_state_dict(ckpt))
                self._pyannet_dims = pyannet.infer_pyannet_dims(tree)
                self.load_source["pyannet"] = "checkpoint"
                return pyannet.pyannet_from_jax_params(
                    tree, self._pyannet_dims, self.device)
            except Exception as exc:  # noqa: BLE001 — init fallback, as the JAX bundle
                if is_fatal(exc):
                    raise
                logger.warning("pyannet ckpt load failed (%s); using init", exc)
        self.load_source["pyannet"] = "random_init"
        return pyannet.init_pyannet(self._pyannet_dims or pyannet.PyannetDims(),
                                    seed=3, device=self.device)

    def check_cancel(self):
        """Raise ProcessingCancelled when the cancel gate says so."""
        if self.should_cancel is not None and self.should_cancel():
            raise ProcessingCancelled()

    def _ensure(self):
        """Probe the cancel gate, then load lazily — called at the top of
        every compute method, so no device work starts for a cancelled
        task. Under a serving controller the gate was probed before the call
        went to the other ranks, and is not probed again: every rank must
        run the call it was sent."""
        if self._controller is None:
            self.check_cancel()
        if not self._loaded and not self.load_with_progress():
            raise RuntimeError("ModelBundle: model loading failed")

    # ------------------------------------------------------------- compute
    def _prompt_batch(self, prompts, tok, dims, timestamps: bool,
                      languages=None):
        """openai-whisper prompt assembly: context encodes as
        " " + prompt.strip() kept to the last n_text_ctx//2-1 tokens,
        terminated by the SOT sequence — bare [sot] for .en models,
        [sot, <|lang|>, <|transcribe|>] for multilingual ones — plus
        notimestamps outside timestamp mode. A prompt may also be a tuple
        ``(init_text, token_ids)``: encode(" "+init_text) ++ token_ids.
        Prompt lengths bucket into a tiny static set."""
        from clearconverse_tpu_torch.models.decoding import build_prompt_batch
        sp = tok.specials
        ctx_keep = dims.n_text_ctx // 2 - 1
        if sp.english_only:
            tails = [[sp.sot]] * len(prompts)
        else:
            langs = (languages if languages is not None
                     else [self.torch_config.language or "en"] * len(prompts))
            tails = [list(sp.sot_sequence(sp.language_token(lang)))
                     for lang in langs]
        tail_len = len(tails[0])
        if not timestamps:
            tails = [t + [sp.no_timestamps] for t in tails]
            tail_len += 1

        def ctx_ids(p):
            if isinstance(p, tuple):
                init, ids = p
                return (tok.encode(" " + init.strip()) if init.strip()
                        else []) + [int(t) for t in ids]
            return tok.encode(" " + p.strip()) if p.strip() else []

        prompt_lists = []
        for i, p in enumerate(prompts):
            ids = ctx_ids(p)
            prompt_lists.append(
                (([sp.sot_prev] + ids[-ctx_keep:]) if ids else []) + tails[i])
        need = max(len(p) for p in prompt_lists)
        max_p = next(b for b in (4, 16, 64, 256) if b >= min(need, 256))
        toks, lens = build_prompt_batch(prompt_lists, max_p, pad_id=sp.eot)
        return toks, lens, max_p, tail_len    # tail length = SOT offset

    def _suppress_ids(self, tok, timestamps: bool):
        """Whisper's per-step suppression set: non-speech symbols +
        specials, plus the timestamp range (non-timestamp mode) or the
        notimestamps token (timestamp mode)."""
        from clearconverse_tpu_torch.models.tokenizer import non_speech_tokens
        sp = tok.specials
        ids = (set(non_speech_tokens(tok))
               | {sp.sot, sp.sot_prev, sp.sot_lm, sp.translate,
                  sp.transcribe, sp.no_speech})
        if timestamps:
            ids |= {sp.no_timestamps}
        else:
            ids |= set(range(sp.timestamp_begin, sp.n_vocab))
        return tuple(sorted(ids))

    def _decode_with_fallback(self, decode_rows, audio_all, toks, lens,
                              temperature, n_real: int, text_of, eot: int):
        """Whisper's decode_with_fallback semantics.

        A SCALAR temperature is one rung (the reference passes 0.1): every
        row draws best_of sampled replicas at t > 0 and the max
        sum_logprob/length one is kept (MaximumLikelihoodRanker). A tuple
        temperature is the fallback schedule: rows whose text is degenerate
        (compression ratio > 2.4) or low-confidence (avg logprob <
        logprob_threshold) retry at the next rung — unless no_speech_prob
        clears the no-speech threshold. Retries are row-sparse.

        ``decode_rows(audio_rows, toks_rows, lens_rows, temp, replicas)``
        → (tokens [R, mt], lengths, sum_logprob, no_speech_prob);
        ``audio_rows`` carries UNIQUE rows, toks/lens and the outputs carry
        rows × replicas (replica-consecutive). Returns (tokens [R, mt],
        lengths [R], sum_lp [R], nsp [R], avg [R], texts list[n_real],
        final_temp [R]) — nsp is from the FIRST rung."""
        import zlib

        cfg = self.torch_config
        nst, lpt = cfg.no_speech_threshold, cfg.logprob_threshold
        n_rows = len(toks)
        mt = cfg.max_decode_tokens

        def avg_logprob(s: float, n: int) -> float:
            return s / max(n + 1, 1)    # whisper: +1 counts the EOT

        def rank_score(s: float, n: int) -> float:
            return s / max(n, 1)        # MaximumLikelihoodRanker (no +1)

        def quality_ok(text: str, a: float) -> bool:
            data = text.encode("utf-8")
            ratio = (len(data) / len(zlib.compress(data))) if data else 0.0
            return ratio <= 2.4 and a >= lpt

        if isinstance(temperature, (tuple, list)):
            ladder = [float(t) for t in temperature] or [0.0]
        else:
            ladder = [float(temperature)]
        ladder = ladder[: max(1, cfg.max_fallback_attempts)]

        def rep_for(temp: float) -> int:
            """best_of on sampling rungs, beam_size on greedy rungs."""
            if temp > 0:
                return max(1, cfg.best_of)
            return max(1, cfg.beam_size)

        def decode_selected(row_idx, temp):
            """Decode original rows ``row_idx``, each replicated rep_for(temp)
            times inside the decode; keep the best replica per row by
            rank_score. Returns {row: (tokens, n, sum_lp, nsp)}."""
            rep = rep_for(temp)
            uidx = np.asarray(row_idx, np.int64)
            b = self._rows(len(uidx))
            # Pad rows replicate the last row (kept shapes, ignored).
            uidx = np.concatenate([uidx, np.repeat(uidx[-1:], b - len(uidx))])
            idx = np.repeat(uidx, rep)      # prompt rows, replica-consecutive
            t_s, l_s, s_s, n_s = decode_rows(audio_all[uidx], toks[idx],
                                             lens[idx], temp, replicas=rep)
            out = {}
            for fi, row in enumerate(row_idx):
                best_r = max(range(fi * rep, (fi + 1) * rep),
                             key=lambda r: rank_score(float(s_s[r]),
                                                      int(l_s[r])))
                out[row] = (t_s[best_r], int(l_s[best_r]),
                            float(s_s[best_r]), float(n_s[best_r]))
            return out

        if rep_for(ladder[0]) > 1:
            sel = decode_selected(list(range(n_real)), ladder[0])
            final_tokens = np.full((n_rows, mt), eot, np.int32)
            final_lens = np.zeros((n_rows,), np.int32)
            sum_lp = np.zeros((n_rows,), np.float32)
            nsp = np.zeros((n_rows,), np.float32)
            for row, (tk, n, s, ns) in sel.items():
                final_tokens[row, : tk.shape[0]] = tk
                final_lens[row] = n
                sum_lp[row] = s
                nsp[row] = ns
        else:
            tokens, lengths, sum_lp, nsp = decode_rows(audio_all, toks,
                                                       lens, ladder[0])
            final_tokens, final_lens = tokens.copy(), lengths.copy()
        final_avg = np.array([avg_logprob(float(sum_lp[i]),
                                          int(final_lens[i]))
                              for i in range(n_rows)])
        final_temp = np.full((n_rows,), ladder[0], np.float32)
        texts: List[str] = [text_of(final_tokens[i], int(final_lens[i]))
                            for i in range(n_real)]

        def flag(i: int) -> bool:
            # no_speech_prob above the threshold clears needs_fallback.
            if nsp[i] > nst:
                return False
            return not quality_ok(texts[i], final_avg[i])

        flagged = [i for i in range(n_real) if flag(i)]
        for temp in ladder[1:]:
            if not flagged:
                break
            sel = decode_selected(flagged, temp)
            still: List[int] = []
            for row, (tk, n, s, _ns) in sel.items():
                # This rung's result stands, even when it still fails.
                final_tokens[row, : tk.shape[0]] = tk
                final_lens[row] = n
                final_avg[row] = avg_logprob(s, n)
                final_temp[row] = temp
                texts[row] = text_of(tk, n)
                if flag(row):
                    still.append(row)
            flagged = still
        return (final_tokens, final_lens, sum_lp, nsp, final_avg, texts,
                final_temp)

    def _detect_languages(self, audio, model, dims, tok, target: int):
        """Per-row language codes by whisper detect_language for a
        multilingual model without a pinned ``TorchConfig.language``; None
        otherwise. Detection runs its own encoder forward: the codes must
        come back to the host to build the prompts."""
        if tok.specials.english_only or self.torch_config.language is not None:
            return None
        from clearconverse_tpu_torch.models.decoding import (
            detect_language_from_audio)
        from clearconverse_tpu_torch.models.tokenizer import WHISPER_LANGUAGES
        sp = tok.specials
        wav = audio.gather() if isinstance(audio, StoreBatch) else audio
        lang_lo = sp.sot + 1
        ids = _host(detect_language_from_audio(
            model, wav, dims, sp.sot, lang_lo, sp.translate, target,
            self._cdt))
        return [WHISPER_LANGUAGES[i - lang_lo] for i in ids]

    def _decode_rows(self, timestamps: bool, sot_off: int, max_p: int,
                     target: int):
        """The device program of one fallback rung, for
        ``_decode_with_fallback``: ``decode_rows(audio_rows, toks_rows,
        lens_rows, temp, replicas)`` decodes host or StoreBatch rows padded
        or trimmed to ``target`` samples, with timestamp tokens when
        ``timestamps``. On a mesh each data rank decodes its block of the
        rows on its Whisper shard (sampling noise drawn for the whole batch
        and sliced, so t > 0 samples as at 1×1) and the packed results are
        gathered over the data axis."""
        from clearconverse_tpu_torch.models import decoding as dec
        from clearconverse_tpu_torch.parallel.mesh import DATA_AXIS
        cfg = self.torch_config
        model, dims, tok = self._whisper_on_mesh()
        sp = tok.specials
        suppress = self._suppress_ids(tok, timestamps=timestamps)
        mesh = self.mesh
        split = mesh is not None and mesh.data > 1

        def decode_rows(audio_rows, toks_rows, lens_rows, temp: float,
                        replicas: int = 1):
            noise_rows = (0, 0)
            if split:
                n = audio_rows.shape[0]
                sl = mesh.rows(n)
                rs = slice(sl.start * replicas, sl.stop * replicas)
                audio_rows = audio_rows[sl]
                toks_rows, lens_rows = toks_rows[rs], lens_rows[rs]
                noise_rows = (rs.start, n * replicas)
            opts = dec.DecodeOptions(
                max_tokens=cfg.max_decode_tokens,
                temperature=temp, eot=sp.eot,
                suppress_blank=True, blank_token=220,
                suppress_tokens=suppress,
                compute_dtype=self._cdt,
                cross_kv_bits=cfg.cross_kv_bits,
                self_kv_bits=cfg.self_kv_bits,
                no_speech_token=sp.no_speech, sot_from_end=sot_off,
                timestamps=timestamps, timestamp_begin=sp.timestamp_begin,
                replicas=replicas, beam=(temp == 0 and replicas > 1),
                noise_rows=noise_rows)
            gen = None
            if temp > 0:
                self._decode_seed += 1
                if self._decode_gen is None:
                    self._decode_gen = torch.Generator(device=self.device)
                gen = self._decode_gen.manual_seed(self._decode_seed)
            with self._stage_timer.stage("decode_dev"):
                if isinstance(audio_rows, StoreBatch):
                    out = dec.greedy_decode_from_store(
                        model, audio_rows.store.dev,
                        self._put(audio_rows.rows), self._put(audio_rows.starts),
                        self._put(audio_rows.lens),
                        self._put(toks_rows), self._put(lens_rows),
                        dims, opts, max_p, gen, target_len=target,
                        bucket=audio_rows.bucket, timer=self.decode_timer)
                else:
                    out = dec.greedy_decode_from_audio(
                        model, audio_rows, self._put(toks_rows),
                        self._put(lens_rows), dims, opts, max_p, gen,
                        target_len=target, timer=self.decode_timer)
                if split:
                    out = {"packed": mesh.all_gather(out["packed"], DATA_AXIS)}
                return _unpack_decode(out, opts.max_tokens)
        return decode_rows

    @_batched
    def transcribe_batch(self, audio, prompts: Sequence[str],
                         temperature: float = 0.0,
                         word_timestamps: bool = False):
        """[B, T] padded 16 kHz segments (host array or StoreBatch) +
        per-row prompt strings → texts: pad/trim → log-mel → encoder →
        batched KV-cached decode on the bundle's device.

        ``word_timestamps=True`` (the reference passes it on every call,
        back/api.py:1290) also returns per-row word lists
        [{"word", "start", "end"}] from a teacher-forced cross-attention
        pass over the same padded rows → (texts, words)."""
        self._ensure()
        if self._voxtral is not None:
            if word_timestamps:
                raise ValueError("word timestamps are Whisper's alignment "
                                 "pass; Voxtral has none")
            return self._transcribe_voxtral(audio, len(prompts), temperature)
        cfg = self.torch_config
        model, dims, tok = self._whisper_on_mesh()
        sp = tok.specials
        n_real = len(prompts)
        rows = self._rows(n_real)
        is_store = isinstance(audio, StoreBatch)
        if rows > n_real:
            audio = (audio.pad_rows(rows - n_real) if is_store else
                     np.pad(np.asarray(audio), ((0, rows - n_real), (0, 0))))
            prompts = list(prompts) + [""] * (rows - n_real)
        if cfg.pad_to_full_window:
            target = 30 * 16000
        else:  # bucket-length windows: shorter encoder ctx, less cross-KV
            target = min(-(-audio.shape[1] // 16000) * 16000, 30 * 16000)
        if not is_store:
            audio = torch.as_tensor(np.asarray(audio, np.float32),
                                    device=self.device)

        languages = self._detect_languages(audio, model, dims, tok, target)
        toks, lens, max_p, sot_off = self._prompt_batch(prompts, tok, dims,
                                                        timestamps=False,
                                                        languages=languages)
        decode_rows = self._decode_rows(False, sot_off, max_p, target)

        (final_tokens, final_lengths, _sum_lp, nsp, final_avg,
         texts, _ftemp) = self._decode_with_fallback(
            decode_rows, audio, toks, lens, temperature, n_real,
            text_of=lambda tk, n: tok.decode(tk[:n]), eot=sp.eot)

        # Whisper's no-speech gate: skip the segment when no_speech_prob
        # exceeds the threshold unless avg logprob clears logprob_threshold.
        for i in range(n_real):
            if nsp[i] > cfg.no_speech_threshold and \
                    final_avg[i] <= cfg.logprob_threshold:
                texts[i] = ""
                final_lengths[i] = 0
        if not word_timestamps:
            return texts[:n_real]
        return texts[:n_real], self._align(model, dims, tok, audio, target,
                                           final_tokens, final_lengths, n_real,
                                           languages)

    def _transcribe_voxtral(self, audio, n_real: int, temperature):
        """``transcribe_batch`` on Voxtral: the rows padded to the row
        bucket and to 30 s, then ``decoding.voxtral_decode_from_audio``
        under ``_decode_with_fallback`` (best_of's ranking, the quality
        gates and the temperature ladder). The prompts are not read: the
        transcription template has no slot for earlier text. Whisper's
        language detection, no-speech gate and seek are not run."""
        from clearconverse_tpu_torch.models import decoding as dec
        cfg = self.torch_config
        model, dims, tok = self._voxtral
        sp = tok.specials
        rows = self._rows(n_real)
        is_store = isinstance(audio, StoreBatch)
        if rows > n_real:
            audio = (audio.pad_rows(rows - n_real) if is_store else
                     np.pad(np.asarray(audio), ((0, rows - n_real), (0, 0))))
        if not is_store:
            audio = torch.as_tensor(np.asarray(audio, np.float32),
                                    device=self.device)
        head, tail = sp.prompt(tok.language_ids(cfg.language))
        target = 30 * 16000

        def decode_rows(audio_rows, _toks, _lens, temp: float,
                        replicas: int = 1):
            opts = dec.DecodeOptions(
                max_tokens=cfg.max_decode_tokens, temperature=temp,
                eot=sp.eos, suppress_blank=False,
                suppress_tokens=sp.control_ids(), compute_dtype=self._cdt,
                replicas=replicas, beam=(temp == 0 and replicas > 1))
            gen = None
            if temp > 0:
                self._decode_seed += 1
                if self._decode_gen is None:
                    self._decode_gen = torch.Generator(device=self.device)
                gen = self._decode_gen.manual_seed(self._decode_seed)
            with self._stage_timer.stage("decode_dev"):
                if isinstance(audio_rows, StoreBatch):
                    with dec._span(self.decode_timer, "gather"):
                        audio_rows = audio_rows.gather()
                out = dec.voxtral_decode_from_audio(
                    model, audio_rows, head, tail, opts, gen,
                    target_len=target, timer=self.decode_timer)
                self._count_decode(out["counts"])
                return _unpack_decode(out, opts.max_tokens)

        zeros = np.zeros((rows, 1), np.int32)
        texts = self._decode_with_fallback(
            decode_rows, audio, zeros, zeros[:, 0], temperature, n_real,
            text_of=lambda tk, n: tok.decode(tk[:n]), eot=sp.eos)[5]
        return texts[:n_real]

    def _count_decode(self, counts: dict) -> None:
        """Adds one Voxtral decode call's counters to ``last_decode``."""
        for k, v in counts.items():
            if k == "prefix_copies":
                self.last_decode[k] = max(self.last_decode.get(k, 0), v)
            else:
                self.last_decode[k] = self.last_decode.get(k, 0) + v

    @torch.no_grad()
    def _align(self, model, dims, tok, audio, target: int, tokens, lengths,
               n_real: int, languages=None):
        """Word timestamps of the decoded rows: the rows re-encoded (log-mel,
        encoder) and one teacher-forced pass replaying openai-whisper's
        find_alignment conditioning — the full SOT sequence (with each
        row's ``languages`` entry, when detected) and <|notimestamps|> — on
        the decode's padded row count; pad rows run with length 0 and give
        empty lists."""
        from clearconverse_tpu_torch.audio.mel import log_mel_auto, pad_or_trim
        from clearconverse_tpu_torch.models.alignment import align_batch
        from clearconverse_tpu_torch.models.whisper import whisper_encode
        sp = tok.specials
        rows = len(tokens)
        if isinstance(audio, StoreBatch):
            audio = audio.gather()
        mel = log_mel_auto(pad_or_trim(audio.float(), target), dims.n_mels)
        feats = whisper_encode(model, mel, dims, self._cdt)
        if sp.english_only:
            pres = [[sp.sot, sp.no_timestamps]] * rows
        else:
            langs = (list(languages[:n_real]) if languages is not None
                     else [self.torch_config.language or "en"] * n_real)
            pres = ([list(sp.sot_sequence(sp.language_token(lang)))
                     + [sp.no_timestamps] for lang in langs]
                    + [[sp.sot, sp.no_timestamps]] * (rows - n_real))
        lens = np.zeros(rows, np.int32)
        lens[:n_real] = np.asarray(lengths[:n_real], np.int32)
        return align_batch(model, tok, tokens, lens, feats, dims,
                           prefixes=pres, eot=sp.eot)[:n_real]

    @_batched
    def transcribe_long_batch(self, audio, prompts: Sequence,
                              lengths: Optional[np.ndarray] = None,
                              temperature: float = 0.0):
        """One ≤30 s window per row of a longer segment → [(text,
        advance_seconds, reset_context, ctx_tokens)]: whisper transcribe's
        timestamp-driven seek (reached via back/api.py:1474-1480).

        Each window decodes with timestamp tokens. Per row: the text up to
        the last complete <ts>text<ts> segment, and the cursor advance = that
        segment's end; the dropped tail re-decodes in the caller's next
        window. A row ending in a lone timestamp (or with no complete pair,
        or a sub-second advance) keeps all text and advances the whole
        window. ``ctx_tokens`` are the kept ids, timestamps included (the
        caller chains the next window's prompt from them); a skipped silent
        window gives []. ``reset_context`` is whisper's prompt-reset rule:
        conditioning is off, or the kept result decoded hotter than 0.5.
        Whisper's only: Voxtral does not seek (``seeks``)."""
        self._ensure()
        if self._voxtral is not None:
            raise ValueError("Voxtral does not seek: segments over 30 s take "
                             "the engine's fixed 30 s cuts")
        cfg = self.torch_config
        model, dims, tok = self._whisper_on_mesh()
        sp = tok.specials
        is_store = isinstance(audio, StoreBatch)
        if not is_store:
            audio = np.asarray(audio, np.float32)
        n_real = len(prompts)
        if lengths is None:
            lengths = (audio.lens[:n_real] if is_store
                       else np.full(n_real, audio.shape[1], np.int64))
        window_s = np.minimum(np.asarray(lengths) / 16000.0, 30.0)
        rows = self._rows(n_real)
        if rows > n_real:
            audio = (audio.pad_rows(rows - n_real) if is_store else
                     np.pad(audio, ((0, rows - n_real), (0, 0))))
            prompts = list(prompts) + [""] * (rows - n_real)
        if not is_store:
            audio = self._put(audio)
        languages = self._detect_languages(audio, model, dims, tok, 30 * 16000)
        toks, plens, max_p, sot_off = self._prompt_batch(prompts, tok, dims,
                                                         timestamps=True,
                                                         languages=languages)
        decode_rows = self._decode_rows(True, sot_off, max_p, 30 * 16000)

        def win_text(tk: np.ndarray, n: int) -> str:
            # The quality gate judges the window's text without timestamps.
            return tok.decode([t for t in tk[:n].tolist() if t < sp.eot])

        (final_tokens, final_lens, _sum_lp, nsp, final_avg,
         _texts, final_temp) = self._decode_with_fallback(
            decode_rows, audio, toks, plens, temperature, n_real,
            text_of=win_text, eot=sp.eot)

        precision = 0.02
        tsb = sp.timestamp_begin
        cond_prev = bool(self.config.condition_on_previous_text)
        results = []
        for i in range(n_real):
            reset = (not cond_prev) or float(final_temp[i]) > 0.5
            seq = final_tokens[i, : final_lens[i]].tolist()
            win = float(window_s[i])
            if nsp[i] > cfg.no_speech_threshold and \
                    final_avg[i] <= cfg.logprob_threshold:
                # Silent window: whisper's seek loop skips it before its
                # prompt-reset statement, so it neither resets the rolling
                # prompt nor adds tokens to it.
                results.append(("", win, False, []))
                continue
            is_ts = [t >= tsb for t in seq]
            single_ending = len(seq) >= 2 and not is_ts[-2] and is_ts[-1] \
                or len(seq) == 1 and is_ts[-1]
            pairs = [j + 1 for j in range(len(seq) - 1)
                     if is_ts[j] and is_ts[j + 1]]
            if pairs and not single_ending:
                last_slice = pairs[-1]
                kept = seq[:last_slice]
                advance = (seq[last_slice - 1] - tsb) * precision
                if advance < 1.0:
                    # A sub-second seek would re-decode the same window
                    # forever: keep everything and advance the whole window.
                    kept = seq
                    advance = win
            else:
                kept = seq
                advance = win
            text = tok.decode([t for t in kept if t < sp.eot])
            results.append((text, float(min(advance, win)), reset,
                            [int(t) for t in kept]))
        return results

    # ------------------------------------------------------- speaker half
    def _ecapa_model(self):
        from clearconverse_tpu_torch.models.ecapa import EcapaDims
        return self._ecapa, self._ecapa_dims or EcapaDims()

    @_batched
    @torch.no_grad()
    def embed_batch(self, audio, lengths: Optional[np.ndarray] = None
                    ) -> np.ndarray:
        """[B, T] (padded) → [B, D] speaker embeddings."""
        self._ensure()
        from clearconverse_tpu_torch.models.ecapa import ecapa_embed
        audio = np.asarray(audio, np.float32)
        if lengths is None:
            lengths = np.full(audio.shape[0], audio.shape[1], np.int64)
        (audio, lengths), n_real = self._pad([audio, lengths], [0, 1])
        params, dims = self._ecapa_model()
        with self._stage_timer.stage("embed_dev"):
            return self._by_rows(lambda a, n: ecapa_embed(params, a, n, dims),
                                 audio, lengths)[:n_real]

    @_batched
    @torch.no_grad()
    def embed_denoised_batch(self, audio, lengths: np.ndarray,
                             prop_decrease: float, sr: int = 16000
                             ) -> np.ndarray:
        """[B, T] raw padded clips → [B, D] embeddings of their
        spectral-gated, peak-normalized versions, gate and embed on the
        device in one call."""
        self._ensure()
        (audio, lengths), n_real = self._pad(
            [np.asarray(audio, np.float32), lengths], [0, 1])
        with self._stage_timer.stage("embed_dev"):
            return self._by_rows(lambda a, n: self._gate_embed(
                a, n, prop_decrease, sr, with_var=False)[0],
                audio, lengths)[:n_real]

    def _gate_embed(self, audio: torch.Tensor, lens: torch.Tensor,
                    prop_decrease: float, sr: int, with_var: bool):
        """Gate + peak-normalize + embed of [B, T] rows with ``lens`` valid
        samples; with ``with_var`` also the population variance of each raw
        row's valid part."""
        from clearconverse_tpu_torch.audio.denoise import (
            peak_normalize, spectral_gate, valid_mask)
        from clearconverse_tpu_torch.models.ecapa import ecapa_embed
        params, dims = self._ecapa_model()
        mask = valid_mask(audio.shape[1], lens)
        clean = peak_normalize(spectral_gate(audio, sr, prop_decrease, mask))
        emb = ecapa_embed(params, clean, lens, dims)
        if not with_var:
            return emb, None
        lf = lens.to(torch.float32)
        mean = (audio * mask).sum(dim=-1) / lf
        var = (((audio - mean[:, None]) * mask) ** 2).sum(dim=-1) / lf
        return emb, var

    @_batched
    @torch.no_grad()
    def segment_frames(self, audio) -> np.ndarray:
        """[B, T] window chunks → [B, F, 3] per-frame speaker activities."""
        self._ensure()
        (audio,), n_real = self._pad([np.asarray(audio, np.float32)], [0])
        with self._stage_timer.stage("segment_dev"):
            return self._by_rows(self._segment, audio)[:n_real]

    def _segment(self, audio: torch.Tensor) -> torch.Tensor:
        from clearconverse_tpu_torch.models.pyannet import (
            PyannetDims, powerset_to_multilabel, pyannet_forward)
        dims = self._pyannet_dims or PyannetDims()
        return powerset_to_multilabel(pyannet_forward(self._pyannet, audio,
                                                      dims))

    def _store_args(self, rows, starts, lens):
        return self._pad([np.asarray(rows, np.int32),
                          np.asarray(starts, np.int32),
                          np.asarray(lens, np.int32)], [0, 0, 1])

    @_batched
    @torch.no_grad()
    def embed_store(self, store: AudioStore, rows, starts, lens,
                    bucket: int) -> np.ndarray:
        """embed_batch over windows gathered on the device from the store."""
        self._ensure()
        from clearconverse_tpu_torch.models.decoding import gather_windows
        from clearconverse_tpu_torch.models.ecapa import ecapa_embed
        args, n_real = self._store_args(rows, starts, lens)
        params, dims = self._ecapa_model()

        def embed(r, s, ln):
            audio = gather_windows(store.dev, r, s, ln, bucket)
            return ecapa_embed(params, audio, ln, dims)

        with self._stage_timer.stage("embed_dev"):
            return self._by_rows(embed, *args)[:n_real]

    @_batched
    @torch.no_grad()
    def embed_frames_store(self, store: AudioStore, rows, fstarts, totals,
                           frame: int, pad: int) -> np.ndarray:
        """embed_batch over non-contiguous clips assembled on the device:
        clip i concatenates ``frame``-sample windows of store row rows[i] at
        offsets fstarts[i, :] (diarization's exclusive-frame clips,
        pipeline/diarize._carve_subsegments), cut to ``pad`` samples with
        ``totals[i]`` valid."""
        self._ensure()
        from clearconverse_tpu_torch.models.ecapa import ecapa_embed
        args, n_real = self._pad(
            [np.asarray(rows, np.int32), np.asarray(fstarts, np.int32),
             np.asarray(totals, np.int32)], [0, 0, 1])
        params, dims = self._ecapa_model()
        frame, pad = int(frame), int(pad)
        dev = store.dev

        def embed(r, s, tot):
            r = r.long().clamp(0, dev.shape[0] - 1)
            s = s.long().clamp(0, dev.shape[1] - frame)
            idx = s[:, :, None] + torch.arange(frame, device=dev.device)
            clips = dev[r[:, None, None], idx].reshape(len(r), -1)[:, :pad]
            if clips.shape[1] < pad:       # fstarts under-provisioned
                clips = F.pad(clips, (0, pad - clips.shape[1]))
            mask = (torch.arange(pad, device=dev.device)[None, :]
                    < tot[:, None]).to(clips.dtype)
            return ecapa_embed(params, clips * mask, tot, dims)

        with self._stage_timer.stage("embed_dev"):
            return self._by_rows(embed, *args)[:n_real]

    @_batched
    @torch.no_grad()
    def embed_denoised_store(self, store: AudioStore, rows, starts, lens,
                             prop_decrease: float, bucket: int,
                             with_var: bool = False):
        """gather + spectral gate + peak-norm + embed over store windows
        (profile building). ``with_var`` also returns each raw window's
        population variance, the profile weight, so the host never reads
        the (possibly still downloading) audio."""
        self._ensure()
        from clearconverse_tpu_torch.models.decoding import gather_windows
        args, n_real = self._store_args(rows, starts, lens)

        def embed(r, s, ln):
            audio = gather_windows(store.dev, r, s, ln, bucket)
            emb, var = self._gate_embed(audio, ln, prop_decrease, store.sr,
                                        with_var)
            return (emb, var) if with_var else emb

        with self._stage_timer.stage("embed_dev"):
            out = self._by_rows(embed, *args)
            if with_var:
                return out[0][:n_real], out[1][:n_real]
            return out[:n_real]

    @_batched
    @torch.no_grad()
    def segment_frames_store(self, store: AudioStore, rows, starts,
                             window: int) -> np.ndarray:
        """segment_frames over windows gathered on the device: [(row,
        start)] × a fixed window → [B, F, 3]. The store's zero tail gives
        the host version's zero-padded final windows."""
        self._ensure()
        from clearconverse_tpu_torch.models.decoding import gather_windows
        args, n_real = self._store_args(rows, starts,
                                        np.full(len(rows), window))

        def segment(r, s, ln):
            return self._segment(gather_windows(store.dev, r, s, ln, window))

        with self._stage_timer.stage("segment_dev"):
            return self._by_rows(segment, *args)[:n_real]

    @property
    def frame_hop_seconds(self) -> float:
        from clearconverse_tpu_torch.models.pyannet import PyannetDims
        return (self._pyannet_dims or PyannetDims()).frame_hop_seconds

    @_batched
    @torch.no_grad()
    def separate_batch(self, audio, lengths=None) -> np.ndarray:
        """[B, T] mixtures → [B, T, 2] separated sources (host f32), rows
        padded to the row bucket on the device. The published layout reads
        ``lengths`` ([B] valid samples of each row, all ``T`` when None;
        padded rows have length 0); the sketch separates the padded rows
        whole."""
        self._ensure()
        from clearconverse_tpu_torch.models import resepformer as rsf
        from clearconverse_tpu_torch.ops import sb_attention, sb_ffn
        audio = np.asarray(audio, np.float32)
        sep, timer = self._sepformer, self.sep_timer
        segments = 0
        if isinstance(sep, rsf.Resepformer):
            if lengths is None:
                lengths = np.full(len(audio), audio.shape[-1])
            arrays, n_real = self._pad(
                [audio, np.asarray(lengths, np.int64)], [0, 0])
            segments = rsf.resepformer_segments(arrays[1], sep.dims)

            def run(a, n):
                return rsf.sepformer_separate(sep, a, n, timer)
        else:
            arrays, n_real = self._pad([audio], [0])

            def run(a):
                return rsf.sepformer_separate(sep, a)
        rows, T = arrays[0].shape
        attn0, ffn0 = sb_attention.seg_attention.launches, sb_ffn.sb_ffn.launches
        with self._stage_timer.stage("separate_dev"):
            out = self._by_rows(run, *arrays)[:n_real]
        self.last_separation = {
            "rows": rows, "samples": rows * T, "segments": segments,
            "fused_attn_layers": sb_attention.seg_attention.launches - attn0,
            "fused_ffn_layers": sb_ffn.sb_ffn.launches - ffn0}
        return out

    # ---------------------------------------------------------- checkpoints
    @_batched
    def save_native(self, path: str) -> None:
        """All four model families in one ``torch.save`` file, each in its
        reference checkpoint's names (openai Whisper, speechbrain ECAPA,
        pyannote PyanNet, the speechbrain RE-SepFormer triplet) as f32 CPU
        tensors, with every family's dims in a ``meta`` block so the file
        describes itself: a tiny or custom model round-trips exactly. On a
        mesh a sharded Whisper is gathered whole over the model axis (every
        rank takes part) and the mesh's rank 0 writes."""
        self._ensure()
        import dataclasses
        import os
        from clearconverse_tpu_torch.models import resepformer as rsf
        from clearconverse_tpu_torch.models.ecapa import (
            EcapaDims, ecapa_to_state_dict)
        from clearconverse_tpu_torch.models.pyannet import (
            PyannetDims, pyannet_to_state_dict)
        from clearconverse_tpu_torch.train.checkpoint import (
            whisper_to_openai_state_dict)

        def tensors(sd):
            return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                    for k, v in sd.items()}

        model, w_dims, _ = self._whisper
        mesh = self.mesh
        if tensor_parallel(model) is not None:
            from clearconverse_tpu_torch.parallel.sharding import (
                unshard_whisper)
            model = unshard_whisper(model, mesh)
        if mesh is not None and mesh.rank != 0:
            return
        sep = self._sepformer
        payload = {
            "whisper": tensors(whisper_to_openai_state_dict(model)),
            "ecapa": tensors(ecapa_to_state_dict(self._ecapa)),
            "pyannet": tensors(pyannet_to_state_dict(self._pyannet)),
            "sepformer": {part: {k: v.detach().float().cpu()
                                 for k, v in getattr(sep, part)
                                 .state_dict().items()}
                          for part in ("encoder", "masknet", "decoder")},
            "meta": {
                "whisper_dims": dataclasses.asdict(w_dims),
                "ecapa_dims": dataclasses.asdict(self._ecapa_dims
                                                 or EcapaDims()),
                "pyannet_dims": dataclasses.asdict(self._pyannet_dims
                                                   or PyannetDims()),
                "sepformer_dims": rsf.dims_to_meta(sep.dims),
            },
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save(payload, path)

    @_batched
    def load_native(self, path: str) -> None:
        """Restore a ``save_native`` file onto the bundle's device. Dims
        come from its ``meta`` block; a file without one falls back to the
        config's name table and the weights' shapes."""
        import dataclasses
        from clearconverse_tpu_torch.models import ecapa, pyannet
        from clearconverse_tpu_torch.models import resepformer as rsf
        from clearconverse_tpu_torch.models.convert import (
            convert_whisper_state_dict, infer_whisper_dims,
            whisper_from_jax_params)
        from clearconverse_tpu_torch.models.tokenizer import load_tokenizer
        from clearconverse_tpu_torch.models.whisper import (
            WhisperDims, model_dims)

        payload = torch.load(path, map_location="cpu", weights_only=True)
        whisper_tree = convert_whisper_state_dict(payload["whisper"])
        ecapa_tree = ecapa.convert_speechbrain_ecapa(payload["ecapa"])
        pyannet_tree = pyannet.convert_pyannote_pyannet(payload["pyannet"])
        sep_sds = [payload["sepformer"][part]
                   for part in ("encoder", "masknet", "decoder")]
        meta = payload.get("meta")

        def undims(cls, d):
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                          for k, v in d.items() if k in names})

        if meta:
            dims = undims(WhisperDims, meta["whisper_dims"])
            e_dims = undims(ecapa.EcapaDims, meta["ecapa_dims"])
            p_dims = undims(pyannet.PyannetDims, meta["pyannet_dims"])
            s_dims = rsf.dims_from_meta(meta["sepformer_dims"])
            sep_tree = rsf.convert_speechbrain_sepformer(*sep_sds, s_dims)
        else:
            dims = infer_whisper_dims(
                whisper_tree, model_dims(self.config.whisper_model_size))
            e_dims = ecapa.infer_ecapa_dims(ecapa_tree)
            p_dims = pyannet.infer_pyannet_dims(pyannet_tree)
            sep_tree = rsf.convert_speechbrain_sepformer(*sep_sds)
            s_dims = rsf.infer_sepformer_dims(sep_tree)
        english = self.config.whisper_model_size.endswith(".en")
        tok = load_tokenizer(self.model_dir, english=english)
        self._whisper = (whisper_from_jax_params(whisper_tree, dims,
                                                 self.device, self._cdt),
                         dims, tok)
        self._ecapa_dims, self._pyannet_dims = e_dims, p_dims
        self._ecapa = ecapa.ecapa_from_jax_params(ecapa_tree, self.device)
        self._pyannet = pyannet.pyannet_from_jax_params(pyannet_tree, p_dims,
                                                        self.device)
        self._sepformer = rsf.sepformer_from_jax_params(sep_tree, s_dims,
                                                        self.device)
        rsf.prepare_kernels(self._sepformer)
        self.load_source = {f: "payload" for f in
                            ("whisper", "ecapa", "pyannet", "sepformer")}
        self.load_source["tokenizer"] = type(tok).__name__
        self._loaded = True
