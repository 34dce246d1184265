"""The model-sharded decode on its graph route, checked on the CPU.

On an NCCL mesh (one card a rank) a model-sharded rank runs its token loop
as CUDA graphs: the arena holds the shard's heads, each chunk of
``decode_graph.K`` steps ends in one all-reduce of the stop pair over the
model axis, and ``decode_graph.drive`` reads the flag a chunk late. No
card is needed for any of that but the capture itself, so here:

- the arena's views have the shapes of the shard's own caches
  (``precompute_cross_kv``, ``init_kv_cache(tp=)``), heads split and
  gathered, on a one-process stand-in mesh;
- ``_graph_route`` takes a shard on a CUDA device over NCCL and refuses
  one over gloo;
- two gloo CPU ranks at 1x2 run the bundle's greedy, beam and best_of
  calls through the graph route with each "graph" a rerun of its chunk
  (tests/torch_mesh_worker.cpu_graph_route): tokens, lengths, sum_logprob
  and steps bitwise equal to the same shard's step-by-step loop and, but
  for sum_logprob's last bits, to the 1x1 port; equal on both ranks; and
  the t=0 tokens equal to the JAX package's meshed bundle on the same
  seeded weights (f32);
- ranks whose stop pairs differ both read steps -1 and both raise.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import torch_mesh_worker as W

from clearconverse_tpu.config import Config as JConfig
from clearconverse_tpu.config import TPUConfig
from clearconverse_tpu.models.tokenizer import ByteFallbackTokenizer as JTok
from clearconverse_tpu.models.whisper import WhisperDims as JDims
from clearconverse_tpu.models.whisper import init_whisper_params
import clearconverse_tpu.pipeline.bundle as jbundle_mod
from clearconverse_tpu.pipeline.bundle import ModelBundle as JBundle

from clearconverse_tpu_torch.models import decode_graph, decoding
from clearconverse_tpu_torch.models.convert import init_whisper
from clearconverse_tpu_torch.models.whisper import (
    WhisperDims, init_kv_cache, precompute_cross_kv, tensor_parallel)
from clearconverse_tpu_torch.parallel.launch import run_group
from clearconverse_tpu_torch.parallel.mesh import Mesh
from clearconverse_tpu_torch.parallel.sharding import (
    TensorParallel, shard_whisper)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class _LoneMesh(Mesh):
    """A 1 x ``model`` mesh in one process, for shapes only: a gather
    repeats this rank's block, a reduce leaves it."""

    def __init__(self, model: int, backend: str = "gloo"):
        super().__init__(1, model, 0, torch.device("cpu"), backend, {})

    def all_reduce(self, t, axis, op="sum"):
        return t

    def all_gather(self, t, axis, dim=0):
        return torch.cat([t] * self.model, dim=dim)


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


# ------------------------------------------------------ the arena's shapes

@pytest.mark.parametrize("heads", [2, 1], ids=["split", "gathered"])
@pytest.mark.parametrize("cross_bits,self_bits,replicas",
                         [(16, 16, 1), (8, 8, 2), (4, 16, 1)])
def test_arena_views_have_the_shard_cache_shapes(heads, cross_bits,
                                                 self_bits, replicas):
    """A 1x2 shard's decode graph buffers hold its heads: 2 heads split one
    a rank, 1 head gathered whole on each. Every cross-KV and self-KV view
    has the shape and dtype of what ``precompute_cross_kv`` (widened) and
    ``init_kv_cache(tp=)`` give that shard, and the cross-KV written into
    the views equals them."""
    dims = WhisperDims(**dict(W.WHISPER_KW, n_text_head=heads,
                              n_text_layer=2))
    shard = shard_whisper(init_whisper(dims, 3, "cpu"), _LoneMesh(2))
    tp = tensor_parallel(shard)
    assert tp.heads(heads) == 1      # 2 heads split, or 1 gathered whole
    B_kv, T, P, max_p, mt = 3, 10, 3, 4, 6
    B = B_kv * replicas
    opts = decoding.DecodeOptions(max_tokens=mt, cross_kv_bits=cross_bits,
                                  self_kv_bits=self_bits, replicas=replicas)
    graphs = decode_graph.DecodeGraphs(torch.device("cpu"))
    bufs = decoding._graph_buffers(graphs, shard, torch.zeros(B_kv, 80, 2 * T),
                                   B, P, max_p + mt, dims, opts, False)
    feats = torch.randn(B_kv, T, dims.n_audio_state,
                        generator=torch.Generator().manual_seed(0))
    want_cross = [decoding._widen_codes(c, torch.float32) for c in
                  precompute_cross_kv(shard, feats, dims.n_text_head,
                                      bits=cross_bits)]
    want_self = init_kv_cache(dims, B, max_p + mt + decode_graph.K,
                              torch.float32, bits=self_bits, device="cpu",
                              tp=tp)
    for got, want in ((bufs.cross_kv, want_cross), (bufs.self_kv, want_self)):
        got, want = _leaves(got), _leaves(want)
        assert got.keys() == want.keys()
        for name, t in want.items():
            assert got[name].shape == t.shape, name
            assert got[name].dtype == t.dtype, name
    written = precompute_cross_kv(shard, feats, dims.n_text_head,
                                  bits=cross_bits, out=bufs.cross_kv)
    for name, t in _leaves(want_cross).items():
        assert torch.equal(_leaves(written)[name], t), name
    # A shard's graphs are its own: apart from the whole model's, keyed on
    # the shard's tensors.
    whole = init_whisper(dims, 3, "cpu")
    assert decode_graph.graphs_for(shard) is not \
        decode_graph.graphs_for(whole)
    assert decode_graph.weights_key(shard) != \
        decode_graph.weights_key(whole)


# ------------------------------------------------------- the route decision

@pytest.mark.parametrize("backend,device,want", [
    ("nccl", "cuda", True), ("gloo", "cuda", False), ("nccl", "cpu", False),
    (None, "cuda", True), (None, "cpu", False)])
def test_graph_route_takes_a_shard_over_nccl(backend, device, want, caplog):
    """A model-sharded rank takes the graph route on a CUDA device whose
    mesh runs over NCCL; over gloo it keeps the eager step and says why;
    a whole model (no ``tp``) takes it on any CUDA device; the CPU never."""
    model = types.SimpleNamespace(
        tp=None if backend is None else TensorParallel(_LoneMesh(2, backend)))
    decoding._log_eager_route.cache_clear()
    with caplog.at_level("INFO", logger=decoding.logger.name):
        assert decoding._graph_route(model, torch.device(device)) is want
    logged = "over gloo runs the token loop eagerly" in caplog.text
    assert logged == (backend == "gloo" and device == "cuda")


# -------------------------------------- two gloo ranks on the graph route

@pytest.fixture(scope="module")
def trees():
    return {"whisper": jax.tree.map(np.asarray, init_whisper_params(
        jax.random.PRNGKey(0), JDims(**W.WHISPER_KW)))}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {"audio": rng.standard_normal((3, 8000)).astype(np.float32) * 0.1,
            "prompts": ["", "ctx", ""]}


@pytest.fixture(scope="module")
def ranks(trees, inputs):
    """Both ranks' results of tests/torch_mesh_worker.sharded_graph_route."""
    return run_group(W.sharded_graph_route, ["cpu", "cpu"],
                     args=(trees, inputs), timeout_s=300)


@pytest.fixture(scope="module")
def single(trees, inputs):
    """Each call at 1x1 in this process: the port's step-by-step loop."""
    torch.set_num_threads(1)
    return {name: W.graph_call(trees, inputs, 1, 1, knobs, temp)[1:]
            for name, knobs, temp in W.GRAPH_CALLS}


def _jax_tokens(trees, inputs, knobs):
    b = JBundle(JConfig(), TPUConfig(
        max_decode_tokens=W.GRAPH_TOKENS, max_fallback_attempts=1,
        compute_dtype="float32", data_axis=1, model_axis=2, **knobs))
    b._whisper = (jax.tree.map(jnp.asarray, trees["whisper"]),
                  JDims(**W.WHISPER_KW), JTok(english=True))
    b._loaded = True
    assert b.mesh.shape == {"data": 1, "model": 2}
    with W.recorded_decodes(jbundle_mod) as calls:
        texts = b.transcribe_batch(inputs["audio"], inputs["prompts"],
                                   temperature=0.0)
    return texts, np.asarray(calls[-1][0])


CALL_IDS = [name for name, _, _ in W.GRAPH_CALLS]


@pytest.mark.parametrize("call", CALL_IDS)
def test_sharded_chunks_equal_the_step_loop_and_1x1(ranks, single, call):
    """On each rank the chunked loop (captured chunks rerun, overrun past
    the end included) gives the shard's step-by-step loop bit for bit:
    tokens, lengths, sum_logprob and steps; tokens, lengths and steps equal
    the 1x1 loop's, and sum_logprob lies within 1e-6 of it (relative). The
    route allocated one arena of one head a rank, captured and replayed."""
    s_texts, s_loop = single[call]
    for res in ranks:
        got = res[call]
        for key in ("tokens", "lengths", "sum_logprob"):
            np.testing.assert_array_equal(got["loop"][key],
                                          got["eager"][key], err_msg=key)
        for key in ("tokens", "lengths"):
            np.testing.assert_array_equal(got["loop"][key], s_loop[key],
                                          err_msg=key)
        # A shard sums each row-parallel product in two halves and the
        # all-reduce adds them: another order than 1x1's one product.
        np.testing.assert_allclose(got["loop"]["sum_logprob"],
                                   s_loop["sum_logprob"], rtol=1e-6, atol=0)
        assert got["loop"]["steps"] == got["eager"]["steps"] \
            == s_loop["steps"]
        assert got["texts"] == got["eager_texts"] == s_texts
        stats = got["stats"]
        assert stats["arena_allocs"] == 1 and got["heads"] == 1
        assert stats["captures"] >= 1
        if got["loop"]["steps"] > 2 * decode_graph.K:
            assert stats["replays"] >= 1


@pytest.mark.parametrize("call", CALL_IDS)
def test_sharded_ranks_agree_bit_for_bit(ranks, call):
    """Both ranks of the model axis decode the same tokens, sum_logprob
    and steps (t > 0 included: each draws the caller's seeded noise) and
    capture the same keys in the same order."""
    a, b = (res[call] for res in ranks)
    for key in ("tokens", "lengths", "sum_logprob"):
        np.testing.assert_array_equal(a["loop"][key], b["loop"][key],
                                      err_msg=key)
    assert a["loop"]["steps"] == b["loop"]["steps"]
    assert a["keys"] == b["keys"] and a["keys"]
    assert a["stats"]["replays"] == b["stats"]["replays"]


@pytest.mark.parametrize("call", ["greedy", "beam"])
def test_sharded_graph_tokens_match_jax_meshed_bundle(ranks, trees, inputs,
                                                      call):
    """At t=0 f32 the sharded graph route's tokens (every beam's, for
    beam search) and texts are the JAX package's 1x2 meshed bundle's on
    the same seeded weights."""
    knobs = dict(W.GRAPH_CALLS[CALL_IDS.index(call)][1])
    j_texts, j_tokens = _jax_tokens(trees, inputs, knobs)
    got = ranks[0][call]
    assert got["texts"] == j_texts
    np.testing.assert_array_equal(got["loop"]["tokens"], j_tokens)


def test_disagreeing_ranks_raise_on_every_rank(ranks):
    """Stop pairs that differ across the model axis come back as [-1, 1]
    on both ranks, and ``decode_graph.drive`` raises on both at the same
    flag read (never one rank replaying a chunk alone)."""
    for res in ranks:
        assert res["agreed"] == [-1, 1]
        assert "disagree" in res["drive"], res["drive"]

