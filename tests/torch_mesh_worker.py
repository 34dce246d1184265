"""Rank functions for the port's mesh tests, run in spawned processes by
clearconverse_tpu_torch.parallel.launch.run_group.

This module imports neither JAX nor the JAX package (a spawned rank
imports it afresh): the weights arrive as numpy pytrees in the JAX
package's layout, and whatever a test holds against JAX is computed in the
test process. Its top level imports only the standard library, so
``isolated_rank`` can refuse JAX before anything else loads.
"""

from __future__ import annotations

import contextlib

WHISPER_KW = dict(n_mels=80, n_vocab=51864, n_audio_ctx=1500,
                  n_audio_state=64, n_audio_head=2, n_audio_layer=1,
                  n_text_ctx=448, n_text_state=64, n_text_head=2,
                  n_text_layer=1)
TRAIN_KW = dict(n_mels=16, n_vocab=64, n_audio_ctx=16, n_audio_state=32,
                n_audio_head=4, n_audio_layer=1, n_text_ctx=16,
                n_text_state=32, n_text_head=4, n_text_layer=1)
MESHES = ((4, 2), (8, 1), (2, 4), (1, 8))
# sot, the first language token and one past the last, of English Whisper's
# vocabulary: detect_language_from_audio's arguments at WHISPER_KW.
LANGUAGE_IDS = (50257, 50258, 50358)


@contextlib.contextmanager
def recorded_decodes(module):
    """Record every ``_unpack_decode`` result of a bundle ``module`` (the
    port's or the JAX package's): (tokens, lengths, sum_logprob,
    no_speech_prob) per decode call."""
    calls = []
    inner = module._unpack_decode

    def record(out, max_tokens):
        res = inner(out, max_tokens)
        calls.append(res)
        return res

    module._unpack_decode = record
    try:
        yield calls
    finally:
        module._unpack_decode = inner


def port_bundle(trees, data=1, model=1, device="cpu", **tc):
    """A port ModelBundle holding the JAX trees' weights."""
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.models import ecapa, pyannet
    from clearconverse_tpu_torch.models import resepformer as rsf
    from clearconverse_tpu_torch.models.convert import whisper_from_jax_params
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.models.whisper import WhisperDims
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle

    cfg = TorchConfig(**{"max_decode_tokens": 8, "compute_dtype": "float32",
                         **tc}, data_axis=data, model_axis=model)
    b = ModelBundle(Config(), cfg, device=device)
    dims = WhisperDims(**WHISPER_KW)
    b._whisper = (whisper_from_jax_params(trees["whisper"], dims, device),
                  dims, ByteFallbackTokenizer(english=True))
    if "ecapa" in trees:
        b._ecapa = ecapa.ecapa_from_jax_params(trees["ecapa"], device)
        b._ecapa_dims = ecapa.EcapaDims(**trees["ecapa_dims"])
        sdims = rsf.SepformerDims(**trees["sepformer_dims"])
        b._sepformer = rsf.sepformer_from_jax_params(trees["sepformer"],
                                                     sdims, device)
        b._pyannet_dims = pyannet.PyannetDims(**trees["pyannet_dims"])
        b._pyannet = pyannet.pyannet_from_jax_params(
            trees["pyannet"], b._pyannet_dims, device)
    b._loaded = True
    return b


def transcribe(b, inputs, temperature=0.0):
    """texts and the decode's (tokens, lengths) of the inputs' call."""
    import clearconverse_tpu_torch.pipeline.bundle as bundle_mod
    with recorded_decodes(bundle_mod) as calls:
        texts = b.transcribe_batch(inputs["audio"], inputs["prompts"],
                                   temperature=temperature)
    n = len(inputs["prompts"])
    return texts, calls[-1][0][:n], calls[-1][1][:n]


def wavefront(b, inputs):
    """The engine's context-chained wavefront over the inputs' two clips."""
    from clearconverse_tpu_torch.config import Config
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

    eng = TranscriptionEngine(Config(temperature=0.0), b.torch_config,
                              models=b, device=b.device)
    c0, c1 = inputs["clips"]
    items = [dict(audio=c0, prompt="", depends_on=None, start=0.0, end=0.75,
                  speaker="SPEAKER_A"),
             dict(audio=c1, prompt=None, depends_on=0, start=0.8, end=1.3,
                  speaker="SPEAKER_A")]
    eng._transcribe_wavefront(items, 16000)
    return [it["text"] for it in items]


def speaker_half(b, inputs):
    audio, lens = inputs["speaker_audio"], inputs["speaker_lens"]
    out = {"embed": b.embed_batch(audio, lens),
           "separate": b.separate_batch(audio),
           "segment": b.segment_frames(audio)}
    # The published separator layout at tiny widths, seeded alike on every
    # rank, with the rows' lengths.
    from clearconverse_tpu_torch.models import resepformer as rsf
    sketch = b._sepformer
    b._sepformer = rsf.init_resepformer(
        rsf.ResepformerDims(enc_channels=16, n_heads=2, d_ffn=32,
                            segment_size=6, n_layers=1), 5, b.device)
    try:
        out["separate_lengths"] = b.separate_batch(audio, lens)
    finally:
        b._sepformer = sketch
    return out


def native_whisper(b):
    """The Whisper tensors of ``b.save_native`` (every rank calls it; the
    mesh's rank 0 writes and returns them)."""
    import os
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "native.pt")
        b.save_native(path)
        if not os.path.exists(path):
            return None
        return {k: v.numpy() for k, v in
                torch.load(path, weights_only=True)["whisper"].items()}


def alignment(model, inputs):
    """A WHISPER_KW Whisper (or its shard)'s cross-attention weights and
    word timestamps of two byte rows ("ab cd" and two bytes) over the
    inputs' encoder features, and its languages of the inputs' audio."""
    import numpy as np
    import torch

    from clearconverse_tpu_torch.models.alignment import (
        align_batch, cross_attention_weights)
    from clearconverse_tpu_torch.models.decoding import (
        detect_language_from_audio)
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.models.whisper import WhisperDims

    dims = WhisperDims(**WHISPER_KW)
    feats = torch.from_numpy(inputs["features"])
    tokens = np.zeros((2, 8), np.int64)
    tokens[0, :5] = list(b"ab cd")
    tokens[1, :2] = [120, 121]
    teacher = torch.from_numpy(np.concatenate(
        [np.full((2, 1), LANGUAGE_IDS[0]), tokens], axis=1))
    return {
        "attn": cross_attention_weights(model, teacher, feats, dims).numpy(),
        "words": align_batch(model, ByteFallbackTokenizer(english=True),
                             tokens, np.asarray([5, 2]), feats, dims,
                             prefixes=[[LANGUAGE_IDS[0], 50362]] * 2,
                             eot=50256),
        "languages": detect_language_from_audio(
            model, torch.from_numpy(inputs["audio"]), dims,
            *LANGUAGE_IDS).numpy()}


def train_step(model, batch, mesh=None, dims_kw=TRAIN_KW):
    """One default AdamW step (lr 1e-3) of a trainable Whisper of
    ``dims_kw`` (or its shard) on a numpy batch: (loss, {name: whole
    gradient}, {name: whole parameter after the step})."""
    import torch

    from clearconverse_tpu_torch.models.whisper import WhisperDims
    from clearconverse_tpu_torch.parallel.sharding import gather_split
    from clearconverse_tpu_torch.train.finetune import (
        default_optimizer, init_train_state, make_train_step)

    dims = WhisperDims(**dims_kw)
    state = init_train_state(model, default_optimizer(model.parameters(),
                                                      lr=1e-3))
    grads = {}

    def keep_grads(closure=None, norm=None):
        for name, p in model.named_parameters():
            g = p.grad.detach().clone()
            grads[name] = g if mesh is None else gather_split(name, g, mesh)
        return step_inner(closure, norm)

    step_inner = state.optimizer.step
    state.optimizer.step = keep_grads
    step = make_train_step(dims, mesh=mesh, compute_dtype=torch.float32)
    loss = float(step(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()})["loss"])
    params = {n: (p if mesh is None else gather_split(n, p, mesh))
              for n, p in model.named_parameters()}
    return (loss, {n: g.numpy() for n, g in grads.items()},
            {n: p.detach().numpy() for n, p in params.items()})


# ------------------------------------------------------------ rank functions

def mesh_checks(devices, trees, inputs):
    """Every mesh check of tests/test_torch_parallel.py on one group of
    eight CPU ranks. Rank 0 returns the results."""
    import torch
    import torch.distributed as dist

    from clearconverse_tpu_torch.models.convert import whisper_from_jax_params
    from clearconverse_tpu_torch.models.whisper import (
        WhisperDims, precompute_cross_kv, tensor_parallel)
    from clearconverse_tpu_torch.ops.quantize import quantize_whisper_decoder
    from clearconverse_tpu_torch.parallel.mesh import MODEL_AXIS, build_mesh
    from clearconverse_tpu_torch.parallel.serve import follow, lead
    from clearconverse_tpu_torch.parallel.sharding import shard_whisper
    from clearconverse_tpu_torch.train.finetune import trainable_whisper

    rank = dist.get_rank()
    out = {"mesh": {}}
    for d, m in ((4, 2), (-1, 2), (8, 1)):
        mesh = build_mesh(d, m, devices)
        out["mesh"][(d, m)] = (mesh.shape, mesh.data_index, mesh.model_index)
    out["mesh_errors"] = []
    for d, m in ((3, 3), (-1, 3)):
        try:
            build_mesh(d, m, devices)
        except ValueError as exc:
            out["mesh_errors"].append(str(exc))

    out["transcribe"] = {}
    for d, m in MESHES:
        b = port_bundle(trees, d, m)
        out["transcribe"][(d, m)] = transcribe(b, inputs)
    # Word timestamps and language detection on the shard, its heads split
    # (4x2) and gathered (1x8); after the call the rank holds the shard in
    # place of the whole model.
    out["aligned"] = {}
    for d, m in ((4, 2), (1, 8)):
        b = port_bundle(trees, d, m)
        b.transcribe_batch(inputs["audio"], inputs["prompts"],
                           temperature=0.0, word_timestamps=True)
        held, dims, _ = b._whisper
        out["aligned"][(d, m)] = {
            "sharded": tensor_parallel(held) is not None,
            "q_width": int(held.encoder.blocks[0].attn.q.weight.shape[0]),
            **alignment(held, inputs)}
    # save_native of the sharded bundle: the whole Whisper, gathered.
    out["native"] = native_whisper(b)
    # t > 0 with best_of replicas on the data axis: the noise of the whole
    # batch is drawn on every rank and sliced.
    b = port_bundle(trees, 4, 2, best_of=2)
    out["sampled"] = transcribe(b, inputs, temperature=0.7)

    b = port_bundle(trees, 4, 2)
    out["speaker"] = speaker_half(b, inputs)
    # The engine's wavefront on rank 0; the other ranks follow its calls.
    b = port_bundle(trees, 4, 2)
    if rank == 0:
        ctl = lead(b)
        try:
            out["wavefront"] = wavefront(b, inputs)
        finally:
            ctl.close()
    else:
        follow(b)

    # int8 cross-KV codes of a head shard, gathered over the model axis.
    mesh = build_mesh(4, 2, devices)
    dims = WhisperDims(**WHISPER_KW)
    whole = whisper_from_jax_params(trees["whisper"], dims, "cpu")
    ckv = precompute_cross_kv(shard_whisper(whole, mesh),
                              torch.from_numpy(inputs["features"]),
                              dims.n_text_head, bits=8)
    out["cross_kv"] = [{name: {key: mesh.all_gather(t, MODEL_AXIS, dim=1)
                               .numpy() for key, t in entry.items()}
                        for name, entry in layer.items()} for layer in ckv]

    # An int8 decoder, sharded: the same texts as the whole one.
    b = port_bundle(trees, 1, 8)
    model, dims, tok = b._whisper
    b._whisper = (quantize_whisper_decoder(model), dims, tok)
    out["quantized"] = transcribe(b, inputs)

    # The train step at 4x2.
    tdims = WhisperDims(**TRAIN_KW)
    tmesh = build_mesh(4, 2, devices)
    shard = shard_whisper(trainable_whisper(whisper_from_jax_params(
        trees["train"], tdims, "cpu")), tmesh)
    out["train"] = train_step(shard, inputs["train_batch"], tmesh)
    # At 2x4 on two heads: q, k and v are gathered into whole heads
    # (their gradient through _Gather's backward).
    wdims = WhisperDims(**WHISPER_KW)
    wmesh = build_mesh(2, 4, devices)
    shard = shard_whisper(trainable_whisper(whisper_from_jax_params(
        trees["whisper"], wdims, "cpu")), wmesh)
    out["train_gathered"] = train_step(shard, inputs["whisper_train_batch"],
                                       wmesh, WHISPER_KW)
    return out if rank == 0 else None


def isolated_rank(devices):
    """Refuse JAX, the JAX package and safetensors, then transcribe at 1x2
    on a tiny seeded bundle; fails when any of them was loaded."""
    import importlib.abc
    import sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == r or name.startswith(r + ".")
                   for r in ("jax", "jaxlib", "clearconverse_tpu",
                             "safetensors")):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import torch.distributed as dist

    from clearconverse_tpu_torch.entry import _serving_transcribe

    texts = _serving_transcribe(devices[dist.get_rank()], 1, 2)
    leaked = [m for m in sys.modules
              if any(m == r or m.startswith(r + ".")
                     for r in ("jax", "jaxlib", "clearconverse_tpu",
                               "safetensors"))]
    if leaked:
        raise RuntimeError(f"loaded in a rank: {leaked}")
    return texts


def card_pair(devices):
    """Two ranks on one card: transcribe_batch at 1x2 and 2x1 on a 2-head,
    128-wide seeded model (64-wide heads, as the card's kernel takes),
    with each rank's K1 and K2 launches. Rank 0 returns them."""
    import torch.distributed as dist

    from clearconverse_tpu_torch.entry import _serving_transcribe
    from clearconverse_tpu_torch.ops import encoder_attention as k2
    from clearconverse_tpu_torch.ops import logmel as k1

    device = devices[dist.get_rank()]
    out = {}
    for data, model in ((1, 2), (2, 1)):
        k1.mel_power.launches = k2.encoder_attention.launches = 0
        texts = _serving_transcribe(device, data, model)
        counts = [None] * dist.get_world_size()
        dist.all_gather_object(counts, (k1.mel_power.launches,
                                        k2.encoder_attention.launches))
        out[(data, model)] = (texts, counts)
    return out


def follower_faults(devices):
    """Two CPU ranks serving a tiny bundle at 1x2, with the mesh's
    collectives limited to 5 s. A call that fails alike on both ranks is
    rank 0's own error and the mesh goes on; a call that fails on the
    follower alone, before its first collective, ends the follower and
    makes rank 0 raise and refuse later calls. Rank 0 returns
    ({call: (error or texts, seconds)}); the follower returns None once
    ``follow`` has raised."""
    import time

    import numpy as np
    import torch.distributed as dist

    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.entry import _tiny_whisper_bundle
    from clearconverse_tpu_torch.parallel import mesh as mesh_mod
    from clearconverse_tpu_torch.parallel.serve import follow, lead

    mesh_mod.COLLECTIVE_TIMEOUT_S = 5.0
    b = _tiny_whisper_bundle(Config(), TorchConfig(
        max_decode_tokens=4, compute_dtype="float32", data_axis=1,
        model_axis=2), devices[dist.get_rank()])
    inner = b._prompt_batch

    def faulty(prompts, *args, **kwargs):     # the call is named by its prompt
        if prompts[0] == "alike":
            raise ValueError("bad request")
        if prompts[0] == "alone" and dist.get_rank() == 1:
            raise RuntimeError("injected fault")
        return inner(prompts, *args, **kwargs)

    b._prompt_batch = faulty
    if dist.get_rank() == 1:
        try:
            follow(b)
        except RuntimeError as exc:
            if "injected fault" not in str(exc):
                raise
            return None
        raise AssertionError("follow returned after a call that failed "
                             "on this rank alone")
    ctl = lead(b)
    audio = np.random.default_rng(7).standard_normal(
        (2, 8000)).astype(np.float32) * 0.1
    out = {}
    try:
        for name in ("alike", "ok", "alone", "after"):
            t0 = time.monotonic()
            try:
                res = b.transcribe_batch(audio, [name, ""])
            except Exception as exc:  # noqa: BLE001 — the outcome is the check
                res = f"{type(exc).__name__}: {exc}"
            out[name] = (res, time.monotonic() - t0)
    finally:
        ctl.close()
    return out


def train_cli(devices, argv):
    """The train CLI on every rank of an existing process group."""
    from clearconverse_tpu_torch.train.__main__ import main
    return main(argv)


class _Rerun:
    """A stand-in for a captured decode graph on the CPU: its replay runs
    the captured chunk again, eagerly, on the key's fixed buffers."""

    def __init__(self, chunk):
        self.chunk = chunk

    def replay(self):
        self.chunk()


@contextlib.contextmanager
def cpu_graph_route():
    """The decode graph route on the CPU: ``decoding._graph_route`` true
    and each key's capture a ``_Rerun`` of its chunk. Everything else is
    the card's route: the key's arena views, its state and inputs refilled
    per call, chunks of ``decode_graph.K`` steps ending in the model
    axis's stop agreement, ``decode_graph.drive`` reading the stop flag a
    chunk late, overrun past the loop's end."""
    from clearconverse_tpu_torch.models import decode_graph, decoding

    def capture(self, e, chunk, timer):
        chunk()
        e.graph = _Rerun(chunk)
        self.stats["captures"] += 1
        decode_graph.COUNTS["captures"] += 1

    route, cap = decoding._graph_route, decode_graph.DecodeGraphs._capture
    decoding._graph_route = lambda model, device: True
    decode_graph.DecodeGraphs._capture = capture
    try:
        yield
    finally:
        decoding._graph_route = route
        decode_graph.DecodeGraphs._capture = cap


@contextlib.contextmanager
def recorded_loops():
    """Every greedy_decode / beam_decode result of the port: tokens,
    lengths, sum_logprob and steps (the token positions decoded)."""
    from clearconverse_tpu_torch.models import decoding

    calls = []
    inner = {name: getattr(decoding, name)
             for name in ("greedy_decode", "beam_decode")}

    def wrap(fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append({"tokens": out["tokens"].numpy(),
                          "lengths": out["lengths"].numpy(),
                          "sum_logprob": out["sum_logprob"].numpy(),
                          "steps": out["steps"]})
            return out
        return recorded

    for name, fn in inner.items():
        setattr(decoding, name, wrap(fn))
    try:
        yield calls
    finally:
        for name, fn in inner.items():
            setattr(decoding, name, fn)


# The sharded graph route's calls: (name, TorchConfig knobs, temperature).
GRAPH_CALLS = (("greedy", {}, 0.0),
               ("beam", {"beam_size": 3}, 0.0),
               ("best_of", {"best_of": 3}, 0.7))
GRAPH_TOKENS = 20       # three chunks of decode_graph.K, the last overrun


def graph_call(trees, inputs, data, model, knobs, temperature):
    """One transcribe_batch of the inputs on a port bundle at ``data`` x
    ``model`` (f32, GRAPH_TOKENS tokens, no fallback rung): its texts and
    the token loop's record."""
    b = port_bundle(trees, data, model, max_decode_tokens=GRAPH_TOKENS,
                    max_fallback_attempts=1, **knobs)
    with recorded_loops() as loops:
        texts = b.transcribe_batch(inputs["audio"], inputs["prompts"],
                                   temperature=temperature)
    return b, texts, loops[-1]


def sharded_graph_route(devices, trees, inputs):
    """One of two CPU ranks at 1x2 over gloo: each GRAPH_CALLS call on the
    graph route run on the CPU (``cpu_graph_route``) and on the eager step
    loop, with the decode graphs' counts and keys; then the stop agreement
    with the ranks' pairs made to differ, in ``_agree`` and through
    ``decode_graph.drive``. Rank 0 returns every rank's results."""
    import torch
    import torch.distributed as dist

    from clearconverse_tpu_torch.models import decode_graph, decoding

    out = {}
    for name, knobs, temp in GRAPH_CALLS:
        with cpu_graph_route():
            b, texts, loop = graph_call(trees, inputs, 1, 2, knobs, temp)
        shard = b._whisper[0]
        graphs = decode_graph.graphs_for(shard)
        _, e_texts, eager = graph_call(trees, inputs, 1, 2, knobs, temp)
        out[name] = {"texts": texts, "loop": loop, "eager_texts": e_texts,
                     "eager": eager, "stats": dict(graphs.stats),
                     "keys": [repr(k) for k in graphs.captured()],
                     "heads": graphs._arena.layout.heads}

    # Ranks whose control pairs differ: both read [-1, 1], and drive
    # raises on both at the same flag.
    shard = b._whisper[0]
    ctl = torch.tensor([5 + dist.get_rank(), 0])
    decoding._agree(ctl, shard)
    out["agreed"] = ctl.tolist()

    def launch(i):
        ctl.copy_(torch.tensor([decode_graph.K * (i + 1),
                                int(i == 1 and dist.get_rank() == 0)]))
        decoding._agree(ctl, shard)

    try:
        decode_graph.drive(launch, ctl, 4,
                           decode_graph.StopFlags(torch.device("cpu")))
        out["drive"] = "no error"
    except RuntimeError as exc:
        out["drive"] = str(exc)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, out)
    return ranks


def nccl_sharded_graphs(devices):
    """Two ranks, one card each, over NCCL at 1x2: a 2-layer Whisper with
    two 64-wide heads (one a rank) decodes 3 rows of seeded noise, 20
    tokens with EOT off, whole (1x1, graph route) and as this rank's shard
    on the graph route and on the eager step loop: greedy t=0 in f32 and
    bf16, beam search 3 rows x 5 in f32, best_of 5 at t=0.1. Rank 0
    returns every rank's packed results, steps and graph counts."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from clearconverse_tpu_torch.models import decode_graph, decoding
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.whisper import (
        WhisperDims, tensor_parallel)
    from clearconverse_tpu_torch.parallel.mesh import build_mesh
    from clearconverse_tpu_torch.parallel.sharding import shard_whisper

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dims = WhisperDims(n_audio_state=128, n_audio_head=2, n_audio_layer=1,
                       n_text_state=128, n_text_head=2, n_text_layer=2)
    mesh = build_mesh(1, 2, devices)
    audio = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 24000)).astype(np.float32) * 0.1).cuda()
    calls = {"greedy_f32": (torch.float32, {}),
             "greedy_bf16": (torch.bfloat16, {}),
             "beam_f32": (torch.float32, dict(replicas=5, beam=True)),
             "best_of": (torch.float32, dict(replicas=5, temperature=0.1))}

    def decode(model, cdt, kw, eager=False):
        R = kw.get("replicas", 1)
        toks, lens = decoding.build_prompt_batch([[50257, 50362]] * (3 * R),
                                                 8, 50256)
        opts = decoding.DecodeOptions(
            max_tokens=20, eot=-1 if not kw.get("beam") else 50256,
            suppress_tokens=tuple(range(50257, 51864)), compute_dtype=cdt,
            **kw)
        gen = torch.Generator(device="cuda").manual_seed(5)
        route = decoding._graph_route
        if eager:
            decoding._graph_route = lambda model, device: False
        try:
            out = decoding.greedy_decode_from_audio(
                model, audio, torch.from_numpy(toks).cuda(),
                torch.from_numpy(lens).cuda(), dims, opts, 8, gen,
                target_len=32000)
        finally:
            decoding._graph_route = route
        return out["packed"].cpu().numpy(), out["steps"]

    out = {"backend": mesh.backend, "route": None, "calls": {}}
    for name, (cdt, kw) in calls.items():
        whole = init_whisper(dims, seed=6, device="cuda", dtype=cdt)
        shard = shard_whisper(whole, mesh)
        out["route"] = decoding._graph_route(shard, torch.device("cuda"))
        out["heads"] = tensor_parallel(shard).heads(dims.n_text_head)
        graphs = decode_graph.graphs_for(shard)
        single = decode(whole, cdt, kw)
        graph = decode(shard, cdt, kw)
        again = decode(shard, cdt, kw)
        eager = decode(shard, cdt, kw, eager=True)
        out["calls"][name] = {"single": single, "graph": graph,
                              "again": again, "eager": eager,
                              "stats": dict(graphs.stats)}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, out)
    return ranks
