"""The benchmark's own records of the program's calls, taken at the
boundaries it crosses: every decode call (rows, prompts, steps, and a
sample kept whole for the check), a sample of the speaker models' calls
(PyanNet's scores and ECAPA's embeddings, with the audio they took) and,
in a traced run, the shapes of each K1 and K2 launch. Each wrapper replaces a module attribute that the
program looks up at call time and restores it on ``remove``.
"""

from __future__ import annotations

import inspect
from typing import Callable, List, Optional

import numpy as np


class _Patch:
    def __init__(self, module, name: str, make: Callable):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        wrapped = make(self.orig)
        # The kernels count their launches on the name they are called by.
        if hasattr(self.orig, "launches"):
            wrapped.launches = self.orig.launches
        setattr(module, name, wrapped)

    def remove(self) -> None:
        setattr(self.module, self.name, self.orig)


class Keeper:
    """Keeps the record with the most rows, and ``sample`` others by
    reservoir sampling from ``rng``."""

    def __init__(self, rng: np.random.Generator, sample: int):
        self.rng, self.sample = rng, sample
        self.largest: Optional[dict] = None
        self.largest_rows = -1
        self.reservoir: List[dict] = []
        self.seen = 0

    def offer(self, rec: dict, rows: int) -> None:
        if rows > self.largest_rows:
            if self.largest is not None:
                self._sample(self.largest)
            self.largest, self.largest_rows = rec, rows
        else:
            self._sample(rec)

    def _sample(self, rec: dict) -> None:
        self.seen += 1
        if len(self.reservoir) < self.sample:
            self.reservoir.append(rec)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.sample:
            self.reservoir[j] = rec

    def kept(self) -> List[dict]:
        return ([self.largest] if self.largest else []) + list(self.reservoir)


class DecodeRecorder:
    """Wraps ``models.decoding.greedy_decode_from_audio`` (which the store
    path calls too). While ``active``, each call leaves a light record
    (unique rows, prompt lengths, the packed result) and may be kept whole
    for the check: the call with the most prompt rows, and ``sample``
    others by reservoir sampling from ``rng``."""

    def __init__(self, rng: np.random.Generator, sample: int = 2):
        self.keep = Keeper(rng, sample)
        self.active = False
        self.light: List[dict] = []
        self.fault: Optional[Callable] = None
        from clearconverse_tpu_torch.models import decoding
        sig = inspect.signature(decoding.greedy_decode_from_audio)

        def make(orig):
            def wrapped(*args, **kwargs):
                out = orig(*args, **kwargs)
                if self.fault is not None:
                    out = self.fault(out)
                if self.active:
                    a = sig.bind(*args, **kwargs)
                    a.apply_defaults()
                    self._record(a.arguments, out)
                return out
            return wrapped

        self._patch = _Patch(decoding, "greedy_decode_from_audio", make)

    def _record(self, a: dict, out: dict) -> None:
        opts = a["opts"]
        rec = {"audio": a["audio"], "prompts": a["prompt_tokens"],
               "prompt_lens": a["prompt_lens"], "packed": out["packed"],
               "target_len": a["target_len"], "replicas": opts.replicas,
               "max_tokens": opts.max_tokens, "eot": opts.eot,
               "blank": opts.blank_token, "suppress_blank": opts.suppress_blank,
               "suppress": tuple(opts.suppress_tokens),
               "timestamp_begin": (opts.timestamp_begin if opts.timestamps
                                   else -1),
               "beam": bool(opts.beam and opts.replicas > 1)}
        self.light.append({k: rec[k] for k in
                           ("audio", "prompt_lens", "packed", "max_tokens")})
        self.light[-1]["audio"] = tuple(rec["audio"].shape)
        self.keep.offer(rec, rec["prompts"].shape[0])

    def kept(self) -> List[dict]:
        return self.keep.kept()

    def rows_and_steps(self):
        """[(unique rows, prompt lengths, loop steps)] per recorded call;
        the loop ran until every row's EOT or max_tokens - 1 steps."""
        out = []
        for r in self.light:
            pk = r["packed"].cpu().numpy()
            mt = r["max_tokens"]
            steps = int(min(int(pk[:, mt].max()), mt - 1))
            out.append((r["audio"][0], r["prompt_lens"].cpu().numpy(), steps))
        return out

    def remove(self) -> None:
        self._patch.remove()


class SpeakerRecorder:
    """Wraps ``models.pyannet.pyannet_forward`` and
    ``models.ecapa.ecapa_embed``, which the program's bundle looks up at
    each call. While ``active``, keeps a sample of each model's calls
    whole: the audio rows (and valid samples) it took and what it
    returned. ``fault`` (a dict of model name to a function of the
    output) breaks the output where it is produced."""

    def __init__(self, rng: np.random.Generator, sample: int = 2):
        from clearconverse_tpu_torch.models import ecapa, pyannet
        self.active = False
        self.fault: dict = {}
        self.keep = {"pyannet": Keeper(rng, sample),
                     "ecapa": Keeper(rng, sample)}

        def make(model, arg_names):
            def wrap(orig):
                sig = inspect.signature(orig)

                def wrapped(*args, **kwargs):
                    out = orig(*args, **kwargs)
                    if model in self.fault:
                        out = self.fault[model](out)
                    if self.active:
                        a = sig.bind(*args, **kwargs).arguments
                        rec = {k: a.get(k) for k in arg_names}
                        rec["out"] = out
                        self.keep[model].offer(rec, out.shape[0])
                    return out
                return wrapped
            return wrap

        self._patches = [
            _Patch(pyannet, "pyannet_forward", make("pyannet", ("audio",))),
            _Patch(ecapa, "ecapa_embed", make("ecapa", ("audio", "lengths")))]

    def kept(self, model: str) -> List[dict]:
        return self.keep[model].kept()

    def remove(self) -> None:
        for p in self._patches:
            p.remove()


class KernelRecorder:
    """Records the shapes of every K1 (``ops.logmel.mel_power``) and K2
    (``ops.encoder_attention.encoder_attention``) call while ``active``."""

    def __init__(self):
        from clearconverse_tpu_torch.ops import encoder_attention, logmel
        self.active = False
        self.k1: List[tuple] = []
        self.k2: List[tuple] = []

        def make_k1(orig):
            def wrapped(audio, n_mels=80):
                if self.active:
                    self.k1.append((audio.shape[0], audio.shape[-1], n_mels))
                return orig(audio, n_mels)
            return wrapped

        def make_k2(orig):
            def wrapped(q, k, v, n_head):
                if self.active:
                    self.k2.append((q.shape[0], q.shape[1], n_head,
                                    q.shape[2] // n_head))
                return orig(q, k, v, n_head)
            return wrapped

        self._patches = [_Patch(logmel, "mel_power", make_k1),
                         _Patch(encoder_attention, "encoder_attention", make_k2)]

    def reset(self) -> None:
        self.k1, self.k2 = [], []

    def remove(self) -> None:
        for p in self._patches:
            p.remove()
