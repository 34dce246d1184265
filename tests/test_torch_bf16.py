"""The port's default bf16 decode held to the JAX package's own bf16 decode
(CPU, tiny Whisper, 16-bit caches, t=0).

Both packages default to ``compute_dtype="bfloat16"``, where neither is
identical to its f32 result. The contract is that the port departs from the
JAX f32 result no more than the JAX package's bf16 does, stage by stage:

- encoder output and cross-KV: mean |bf16 - JAX f32| under the JAX
  package's own bf16 bound (0.05, tests/test_whisper.py) and at most 1.25x
  the JAX package's drift;
- prefill logits from one shared f32 encoder output: drift at most 1.25x
  JAX's, and no argmax flip that JAX's bf16 does not also make;
- token rows (greedy on 128 rows, a best_of-style call of 32 rows x 5
  replicas, beam search of 16 rows x 5 beams): the rows whose tokens differ
  from JAX f32 number at most JAX bf16's count + 4.

The port keeps its decoder's residual stream in f32 and its attention and
vocabulary logits in f32 (``models/whisper.py``): the JAX package's XLA
program keeps the residual sums in f32 inside its fusions (excess
precision), and JAX asks for f32 logits. On the greedy call the port
differs on 3 rows where JAX bf16 differs on 9; rounding the residual
stream to bf16 alone makes it 21, the vocabulary logits alone 15 (ROADMAP
F3).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from clearconverse_tpu.models import decoding as jdec
from clearconverse_tpu.models import whisper as jw

from clearconverse_tpu_torch.audio.mel import log_mel_auto, pad_or_trim
from clearconverse_tpu_torch.models import decoding as tdec
from clearconverse_tpu_torch.models import whisper as tw
from clearconverse_tpu_torch.models.convert import whisper_from_jax_params

KW = dict(n_mels=80, n_vocab=51864, n_audio_ctx=1500, n_audio_state=64,
          n_audio_head=2, n_audio_layer=1, n_text_ctx=448, n_text_state=64,
          n_text_head=2, n_text_layer=2)
JDIMS, TDIMS = jw.WhisperDims(**KW), tw.WhisperDims(**KW)
EOT, SOT, NO_SPEECH = 50256, 50257, 50361
SUPPRESS = tuple(range(SOT, 51864))
TARGET = 2 * 16000
MT = 12
MAX_P = 16
ROWS = 128                  # greedy rows
REPLICA_ROWS, REPLICAS = 32, 5
BEAM_ROWS, BEAMS = 16, 5
JAX_CONTRACT = 0.05         # tests/test_whisper.py: bf16 encoder, mean |Δ|
DRIFT_RATIO = 1.25          # port drift over JAX drift
ROW_SLACK = 4               # token rows over JAX bf16's count
PROMPTS = [[50360, 11, 22, SOT, 50362], [SOT, 50362], [50360, 7, SOT, 50362]]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def setup():
    """JAX seed-0 weights with the token rows 256-50255 scaled by 0.01 (so
    text tokens compete with EOT), the port's bf16 model, 128 rows of 1.5 s
    noise and their log-mel (the port's, fed to both encoders)."""
    torch.set_num_threads(1)
    params = jax.tree.map(np.array,
                          jw.init_whisper_params(jax.random.PRNGKey(0), JDIMS))
    params["decoder"]["tok"][256:50256] *= 0.01
    model = whisper_from_jax_params(params, TDIMS, "cpu", torch.bfloat16)
    audio = (np.random.default_rng(0).standard_normal((ROWS, 24000))
             .astype(np.float32) * 0.1)
    mel = log_mel_auto(pad_or_trim(torch.from_numpy(audio), TARGET), 80)
    return params, model, audio, mel.numpy()


def _drift(x, ref) -> float:
    return float(np.mean(np.abs(np.asarray(x, np.float32)
                                - np.asarray(ref, np.float32))))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def encoded(setup):
    """Encoder outputs: JAX f32, JAX bf16 and the port's bf16."""
    params, model, _, mel = setup
    enc = jax.jit(jw.whisper_encode, static_argnums=(2, 3))
    out = {"jax_f32": enc(params, jnp.asarray(mel), JDIMS, jnp.float32),
           "jax_bf16": enc(params, jnp.asarray(mel), JDIMS, jnp.bfloat16)}
    with torch.inference_mode():
        out["port_bf16"] = tw.whisper_encode(
            model, torch.from_numpy(mel), TDIMS, torch.bfloat16)
    return out


def _held(name, port: float, ref: float, contract=None):
    assert port <= DRIFT_RATIO * ref, (
        f"{name}: port drift {port:.3g} over {DRIFT_RATIO} x JAX's {ref:.3g}")
    if contract is not None:
        assert port < contract, f"{name}: port drift {port:.3g}"


def test_encoder_output_drift_within_jax_contract(encoded):
    ref = _np(encoded["jax_f32"])
    _held("encoder", _drift(_np(encoded["port_bf16"]), ref),
          _drift(_np(encoded["jax_bf16"]), ref), JAX_CONTRACT)


def test_cross_kv_drift_within_jax_contract(setup, encoded):
    """Every layer's K and V, each side from its own bf16 encoder output,
    against JAX's f32 cross-KV."""
    params, model, _, _ = setup
    H = JDIMS.n_text_head
    ref = jw.precompute_cross_kv(params, encoded["jax_f32"], bits=16, n_head=H)
    jb = jw.precompute_cross_kv(params, encoded["jax_bf16"], bits=16, n_head=H)
    with torch.inference_mode():
        pb = tw.precompute_cross_kv(model, encoded["port_bf16"], H, bits=16)
    for layer, (r, j, p) in enumerate(zip(ref, jb, pb)):
        for name in ("kt", "vt"):
            _held(f"cross {name} layer {layer}",
                  _drift(_np(p[name]), _np(r[name])),
                  _drift(_np(j[name]), _np(r[name])), JAX_CONTRACT)


def _prefill_inputs(n):
    toks, lens = jdec.build_prompt_batch(
        [PROMPTS[i % 3] for i in range(n)], MAX_P, EOT)
    P = toks.shape[1]
    pad = (P - lens)[:, None]
    pos = np.clip(np.arange(P)[None] - pad, 0, JDIMS.n_text_ctx - 1)
    kslot = np.arange(MAX_P + MT)[None, None, None]
    qslot = np.arange(P)[None, None, :, None]
    see = (kslot <= qslot) & (kslot >= pad[:, None, None, :]) & (kslot < P)
    mask = np.where(see, 0.0, -1e9).astype(np.float32)
    return toks.astype(np.int32), pos.astype(np.int32), mask


def test_prefill_logits_from_a_shared_f32_encoder_output(setup, encoded):
    """The decoder alone: one f32 encoder output, cast to each side's
    compute dtype; the logits at the last prompt position."""
    params, model, _, _ = setup
    feats = _np(encoded["jax_f32"])
    toks, pos, mask = _prefill_inputs(ROWS)
    H = JDIMS.n_text_head

    def jax_prefill(cdt):
        a = jnp.asarray(feats).astype(cdt)
        ckv = jw.precompute_cross_kv(params, a, bits=16, n_head=H)
        kv = jw.init_kv_cache(JDIMS, ROWS, MAX_P + MT, cdt)
        logits, _ = jax.jit(jw.decoder_forward, static_argnums=(8, 9))(
            params, jnp.asarray(toks), jnp.asarray(pos), jnp.int32(0), kv,
            ckv, jnp.asarray(mask), None, JDIMS, cdt)
        return _np(logits)[:, -1]

    ref, jb = jax_prefill(jnp.float32), jax_prefill(jnp.bfloat16)
    with torch.inference_mode():
        a = torch.from_numpy(feats.copy()).to(torch.bfloat16)
        ckv = tw.precompute_cross_kv(model, a, H, bits=16)
        kv = tw.init_kv_cache(TDIMS, ROWS, MAX_P + MT, torch.bfloat16,
                              device="cpu")
        logits, _ = tw.decoder_forward(
            model, torch.from_numpy(toks).long(), torch.from_numpy(pos).long(),
            0, kv, ckv, torch.from_numpy(mask), None, TDIMS, torch.bfloat16)
    pb = _np(logits)[:, -1]
    _held("prefill logits", _drift(pb, ref), _drift(jb, ref))
    top = ref.argmax(-1)
    port_flips = set(np.flatnonzero(pb.argmax(-1) != top))
    jax_flips = set(np.flatnonzero(jb.argmax(-1) != top))
    assert port_flips <= jax_flips, sorted(port_flips - jax_flips)


def _opts(mod, cdt, **kw):
    base = dict(max_tokens=MT, eot=EOT, suppress_tokens=SUPPRESS,
                no_speech_token=NO_SPEECH, sot_from_end=2, compute_dtype=cdt)
    base.update(kw)
    return mod.DecodeOptions(**base)


# name -> (unique rows, replicas, extra options)
CALLS = {"greedy": (ROWS, 1, {}),
         "best_of_replicas": (REPLICA_ROWS, REPLICAS, {"replicas": REPLICAS}),
         "beam": (BEAM_ROWS, BEAMS, {"replicas": BEAMS, "beam": True})}


@pytest.fixture(scope="module")
def decodes(setup):
    """Each call's tokens per unique row, as [rows, replicas * MT]: JAX
    f32, JAX bf16 and the port's bf16."""
    params, model, audio, _ = setup
    out = {}
    for name, (n, reps, kw) in CALLS.items():
        toks, lens = jdec.build_prompt_batch(
            [PROMPTS[i % 3] for i in range(n) for _ in range(reps)], MAX_P,
            EOT)
        res = {}
        for label, cdt in (("jax_f32", jnp.float32),
                           ("jax_bf16", jnp.bfloat16)):
            r = jdec.greedy_decode_from_audio(
                params, jnp.asarray(audio[:n]), jnp.asarray(toks),
                jnp.asarray(lens), JDIMS, _opts(jdec, cdt, **kw), MAX_P,
                target_len=TARGET)
            res[label] = np.asarray(r["tokens"])
        with torch.inference_mode():
            r = tdec.greedy_decode_from_audio(
                model, torch.from_numpy(audio[:n]), torch.from_numpy(toks),
                torch.from_numpy(lens), TDIMS,
                _opts(tdec, torch.bfloat16, **kw), MAX_P, target_len=TARGET)
        res["port_bf16"] = r["tokens"].numpy()
        out[name] = {k: v.reshape(n, -1) for k, v in res.items()}
    return out


@pytest.mark.parametrize("call", list(CALLS))
def test_bf16_token_rows_no_worse_than_jax(decodes, call):
    res = decodes[call]
    ref = res["jax_f32"]
    jax_rows = int((res["jax_bf16"] != ref).any(1).sum())
    port_rows = int((res["port_bf16"] != ref).any(1).sum())
    assert port_rows <= jax_rows + ROW_SLACK, (
        f"{call}: port bf16 differs from JAX f32 on {port_rows} of "
        f"{ref.shape[0]} rows, JAX bf16 on {jax_rows}")


def test_matmul_f32_is_the_f32_sum_of_bf16_products():
    """On the CPU, ``matmul_f32`` of bf16 operands equals the f32 product
    of the same values widened (a bf16 product is exact in f32), is not
    rounded to bf16, and leaves f32 operands to ``torch.matmul``."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 2, 5, 64, generator=g).to(torch.bfloat16)
    b = torch.randn(3, 2, 64, 7, generator=g).to(torch.bfloat16)
    y = tw.matmul_f32(a, b)
    assert y.dtype == torch.float32
    assert torch.equal(y, torch.matmul(a.float(), b.float()))
    assert not torch.equal(y, y.to(torch.bfloat16).float())
    w = torch.randn(64, 11, generator=g).to(torch.bfloat16)
    assert torch.equal(tw.matmul_f32(a, w), torch.matmul(a.float(), w.float()))
    f = a.float()
    assert torch.equal(tw.matmul_f32(f, b.float()),
                       torch.matmul(f, b.float()))


@pytest.mark.parametrize("dh", [32, 64, 80, 128])
def test_attention_scale_rounded_like_jax(dh):
    """The attention scales, rounded to the compute dtype as the JAX
    package's ``jnp.asarray(s, x.dtype)`` does."""
    for value in (dh ** -0.5, dh ** -0.25):
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                         (torch.float32, jnp.float32)):
            assert tw._in_dtype(value, tdt) == float(jnp.asarray(value, jdt))


def full_width_reference(rows: int = 4, tokens: int = 96) -> dict:
    """bf16 against f32 at full small.en width on the CPU, for each package
    on its own (the JAX package's seed-0 weights, converted for the port):
    the measures of chip_smoke.py's phase 20 on the hot path's workload
    (30 s of seeded noise, [SOT], EOT off, int8 cross-KV, t=0). Run from
    the repository root as ``PYTHONPATH=. python tests/test_torch_bf16.py``
    (a few minutes on the CPU)."""
    import json

    dims = jw.model_dims("small.en")
    tdims = tw.model_dims("small.en")
    params = jax.tree.map(np.asarray,
                          jw.init_whisper_params(jax.random.PRNGKey(0), dims))
    audio = (np.random.default_rng(0).standard_normal((rows, 30 * 16000))
             .astype(np.float32) * 0.1)
    mel = log_mel_auto(torch.from_numpy(audio), 80).numpy()
    toks, lens = jdec.build_prompt_batch([[SOT]] * rows, 1, EOT)
    kv = dict(max_tokens=tokens, eot=-1, suppress_blank=False,
              cross_kv_bits=8)
    H = dims.n_text_head

    out = {}
    enc = jax.jit(jw.whisper_encode, static_argnums=(2, 3))
    jfeat = {c: enc(params, jnp.asarray(mel), dims, c)
             for c in (jnp.float32, jnp.bfloat16)}

    def jax_prefill(cdt):
        ckv = jw.precompute_cross_kv(params, jfeat[jnp.float32].astype(cdt),
                                     bits=8, n_head=H)
        cache = jw.init_kv_cache(dims, rows, 1, cdt)
        logits, _ = jw.decoder_forward(
            params, jnp.asarray(toks), jnp.zeros_like(jnp.asarray(toks)),
            jnp.int32(0), cache, ckv, jnp.zeros((rows, 1, 1, 1)), None,
            dims, cdt)
        return _np(logits)[:, -1]

    jtok = {c: np.asarray(jdec.greedy_decode_from_audio(
        params, jnp.asarray(audio), jnp.asarray(toks), jnp.asarray(lens),
        dims, jdec.DecodeOptions(compute_dtype=c, **kv), 1)["tokens"])
        for c in (jnp.float32, jnp.bfloat16)}
    out["jax"] = _agreement(_np(jfeat[jnp.bfloat16]), _np(jfeat[jnp.float32]),
                            jax_prefill(jnp.bfloat16),
                            jax_prefill(jnp.float32),
                            jtok[jnp.bfloat16], jtok[jnp.float32])

    models = {c: whisper_from_jax_params(params, tdims, "cpu", c)
              for c in (torch.float32, torch.bfloat16)}
    with torch.inference_mode():
        tmel = torch.from_numpy(mel)
        tfeat = {c: tw.whisper_encode(m, tmel, tdims, c)
                 for c, m in models.items()}

        def port_prefill(cdt):
            ckv = [tdec._widen_codes(c, cdt) for c in tw.precompute_cross_kv(
                models[cdt], tfeat[torch.float32].to(cdt), H, bits=8)]
            cache = tw.init_kv_cache(tdims, rows, 1, cdt, device="cpu")
            t = torch.from_numpy(toks).long()
            logits, _ = tw.decoder_forward(
                models[cdt], t, torch.zeros_like(t), 0, cache, ckv,
                torch.zeros((rows, 1, 1, 1)), None, tdims, cdt)
            return _np(logits)[:, -1]

        ttok = {c: tdec.greedy_decode_from_audio(
            m, torch.from_numpy(audio), torch.from_numpy(toks),
            torch.from_numpy(lens), tdims,
            tdec.DecodeOptions(compute_dtype=c, **kv), 1)["tokens"].numpy()
            for c, m in models.items()}
        out["port"] = _agreement(
            _np(tfeat[torch.bfloat16]), _np(tfeat[torch.float32]),
            port_prefill(torch.bfloat16), port_prefill(torch.float32),
            ttok[torch.bfloat16], ttok[torch.float32])
    out["workload"] = (f"small.en seed 0 (JAX init), {rows} rows x 30 s "
                       f"noise, [SOT], {tokens} tokens, EOT off, int8 "
                       f"cross-KV, t=0, CPU")
    print(json.dumps(out))
    return out


def _agreement(enc16, enc32, log16, log32, tok16, tok32) -> dict:
    d_enc = np.abs(enc16 - enc32)
    return {"encoder_mean_abs": float(d_enc.mean()),
            "encoder_max_abs": float(d_enc.max()),
            "prefill_logit_mean_abs": float(np.abs(log16 - log32).mean()),
            "prefill_argmax_flips": int((log16.argmax(-1)
                                         != log32.argmax(-1)).sum()),
            "token_rows_differ": int((tok16 != tok32).any(-1).sum())}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    full_width_reference()
