"""The port's transcribe() control flow against the sequential
mini-reference of tests/test_transcribe_miniref.py.

The same scripted decoder, the same oracle (``MiniTranscribe``) and the same
inputs as the JAX file drive the port's
``TranscriptionEngine._transcribe_wavefront`` → ``transcribe_long_batch``
→ ``_decode_with_fallback``: every decode call (window start, rung
temperature, replica, exact prompt token ids) and the final transcript must
be identical to the oracle's. The stand-in is installed under the port's
``models.decoding.greedy_decode_from_audio``, whose signature takes a
generator and a timer.
"""

import pytest
import torch

import test_transcribe_miniref as ref
from clearconverse_tpu.config import TPUConfig

from clearconverse_tpu_torch.config import Config, TorchConfig
from clearconverse_tpu_torch.models import decoding
from clearconverse_tpu_torch.models.convert import init_whisper
from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
from clearconverse_tpu_torch.models.whisper import WhisperDims
from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

DIMS = WhisperDims(**{f: getattr(ref.DIMS, f)
                      for f in ref.DIMS.__dataclass_fields__})
KNOBS = dict(max_decode_tokens=48, max_fallback_attempts=4, best_of=2,
             beam_size=0)
CTX_KEEP = DIMS.n_text_ctx // 2 - 1


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _port_decode(log):
    """The JAX file's scripted decoder behind the port's signature."""
    fake = ref.make_fake_decode(log)

    def decode(model, audio, toks, lens, dims, opts, max_p, generator=None,
               target_len=None, timer=None):
        return fake(model, audio, toks, lens, dims, opts, max_p,
                    target_len=target_len)
    return decode


def _run_production(items, monkeypatch, cond_prev=True):
    log = []
    tc = TorchConfig(compute_dtype="float32", **KNOBS)
    cfg = Config(temperature=ref.LADDER, condition_on_previous_text=cond_prev)
    b = ModelBundle(cfg, tc, device="cpu")
    b._whisper = (init_whisper(DIMS, 0, "cpu"), DIMS,
                  ByteFallbackTokenizer(english=True))
    b._loaded = True
    eng = TranscriptionEngine(cfg, tc, models=b)
    monkeypatch.setattr(decoding, "greedy_decode_from_audio",
                        _port_decode(log))
    eng._transcribe_wavefront(items, ref.SR)
    return log, [it["text"] for it in items]


def _item(offset=0):
    return dict(audio=ref.ramp_audio(ref.TOTAL_S, offset), prompt="",
                depends_on=None, store_ref=None)


def _oracle(cond_prev=True, offset=0):
    log = []
    mini = ref.MiniTranscribe(TPUConfig(**KNOBS), ref.LADDER,
                              cond_prev=cond_prev, log=log,
                              ctx_keep=CTX_KEEP, start_offset=offset)
    return log, mini.run(ref.TOTAL_S * ref.SR)


def test_control_flow_matches_mini_reference(monkeypatch):
    prod_log, prod_texts = _run_production([_item()], monkeypatch)
    mini_log, mini_text = _oracle()
    assert prod_log == mini_log
    assert prod_texts == [mini_text]
    starts = [e[0] for e in prod_log]
    assert starts[0] == 0 and 86 in starts and 92 in starts
    temps = {(e[0], e[1]) for e in prod_log}
    assert (86, 0.6) in temps                      # full ladder climbed
    assert (56, 0.2) not in temps                  # no-speech cleared retry
    w92 = [e for e in prod_log if e[0] == 92]
    assert w92 and w92[0][3] == [ref.SP.sot]       # post-reset fresh prompt
    w86 = [e for e in prod_log if e[0] == 86]
    assert len(w86[0][3]) == 1 + 15 + 1            # trimmed rolling prompt
    assert w86[0][3][0] == ref.SP.sot_prev


def test_two_files_batched_decisions_are_per_file(monkeypatch):
    """Two files (one time-shifted) in one wavefront: each file's decision
    trail is the one the oracle makes alone."""
    off = 1000
    for key in list(ref.SCRIPT):
        monkeypatch.setitem(ref.SCRIPT, (key[0] + off, key[1]),
                            ref.SCRIPT[key])
    prod_log, prod_texts = _run_production([_item(), _item(off)],
                                           monkeypatch)
    for fi, o in enumerate((0, off)):
        mini_log, text = _oracle(offset=o)
        assert [e for e in prod_log if o <= e[0] < o + ref.TOTAL_S] == mini_log
        assert prod_texts[fi] == text


def test_condition_on_previous_text_false_resets_every_window(monkeypatch):
    """condition_on_previous_text=False: every window's prompt is bare
    [sot], as the oracle's."""
    log, texts = _run_production([_item()], monkeypatch, cond_prev=False)
    assert all(e[3] == [ref.SP.sot] for e in log)
    mini_log, mini_text = _oracle(cond_prev=False)
    assert log == mini_log and texts == [mini_text]
