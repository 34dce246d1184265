"""The decode token loop as CUDA graphs: the port's counterpart of the JAX
package's jitted ``lax.while_loop`` decode.

JAX compiles encode, cross-KV, prefill and the whole token loop into one
XLA program per (row bucket, window bucket, prompt bucket, options), so the
device never waits for the host between tokens; its ``beam_decode`` is one
such program too. Here the loop's step (``decoding._greedy_step``, or
``decoding._beam_step`` for beam search) is captured as a
``torch.cuda.CUDAGraph`` of ``K`` consecutive steps, one graph per static
key, and replayed until a stop flag says the loop has ended:

* **Stop flag.** After each replay the loop's control pair (steps taken,
  stop) is copied without blocking into pinned host memory and a CUDA
  event is recorded; the host reads replay *n*'s pair while replay *n + 1*
  runs, so it reads at most ceil(steps / K) + 1 flags a call and the card
  never idles on the read.
* **Overrun.** Steps past the loop's end write EOT and add nothing to a
  row's log-probability, as the JAX ``body`` does for finished rows (a
  beam step past the end freezes every beam and stores nothing), so a
  replay that runs past the end changes no output. The token buffer and
  the self-KV cache carry ``K`` spare columns and slots for them.
* **Static buffers.** A graph replays fixed addresses, so prefill writes
  the widened cross-KV and the self-KV cache into one arena that this
  module owns, sized for the largest rows, encoder context and cache
  length seen so far; a smaller bucket takes views into it (a leading-dim
  prefix for rows, strided views for T and the cache slots). A call that
  needs more than the arena holds replaces it and drops every graph, so
  warm-up drives the largest bucket first. All graphs share one memory
  pool (``graph_pool_handle``); nothing a graph allocates outlives its
  replay, so the graphs may replay in any order.
* **Sampling.** At t > 0 each graph owns a CUDA generator registered with
  it (``CUDAGraph.register_generator_state``), reseeded on every call from
  the caller's generator's seed, so one seed gives the same tokens.

* **Model-sharded ranks.** Over NCCL (one card a rank) a shard's step
  holds its all-reduces and all-gathers, and the graph captures them; each
  chunk ends with one all-reduce of the stop pair over the model axis
  (``decoding._agree``), so every rank of the axis replays the same chunks
  and a disagreement raises on all of them (steps -1). Gloo's collectives
  cannot be captured: such a rank keeps the eager step.

A capture or a replay that fails raises: nothing falls back to the eager
loop. The first call of a key runs its first ``K`` steps eagerly on the
capture stream (which also warms cuBLAS and the allocator for that stream,
and runs every collective of the chunk before the capture, so each NCCL
communicator it uses exists first) and then captures. The capture is
``thread_local``: ProcessGroupNCCL's watchdog thread queries events while
the main thread captures, which the global mode refuses.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# Steps per captured graph: a replay launches K steps' kernels at once and
# the host reads the stop flag once per replay.
K = 8

# Process-wide counts beside each model's ``DecodeGraphs.stats``, as the
# kernel wrappers count their launches: a run sets them to 0 before a path
# and reads them after it, to show that the path replayed graphs.
COUNTS = {"replays": 0, "captures": 0, "flag_reads": 0}


@dataclasses.dataclass(frozen=True)
class Layout:
    """What the arena's buffers hold: the decoder's layers, (local) heads
    and head width, the compute dtype, whether the cross-KV is quantized
    (widened codes plus f32 scales) and the self-KV cache's bits."""

    n_layer: int
    heads: int
    head_dim: int
    dtype: torch.dtype
    cross_quantized: bool
    self_kv_bits: int


class _Arena:
    """Cross-KV and self-KV buffers for up to ``rows_kv`` encoder rows,
    ``rows`` decode rows, ``T`` encoder frames and ``M`` cache slots."""

    def __init__(self, layout: Layout, rows_kv: int, rows: int, T: int,
                 M: int, device: torch.device):
        self.layout = layout
        self.dims = (rows_kv, rows, T, M)
        H, dh, cdt = layout.heads, layout.head_dim, layout.dtype
        f32 = torch.float32

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        self.cross: List[Dict[str, Any]] = []
        self.self: List[Dict[str, torch.Tensor]] = []
        for _ in range(layout.n_layer):
            if layout.cross_quantized:
                self.cross.append({
                    "k8t": {"q": z((rows_kv, H, dh, T), cdt),
                            "scale": z((rows_kv, H, dh, 1), f32)},
                    "v8t": {"q": z((rows_kv, H, T, dh), cdt),
                            "scale": z((rows_kv, H, 1, dh), f32)}})
            else:
                self.cross.append({"kt": z((rows_kv, H, dh, T), cdt),
                                   "vt": z((rows_kv, H, T, dh), cdt)})
            if layout.self_kv_bits == 8:
                self.self.append({"kq": z((rows, H, dh, M), torch.int8),
                                  "ks": z((rows, H, 1, M), f32),
                                  "vq": z((rows, H, M, dh), torch.int8),
                                  "vs": z((rows, H, M, 1), f32)})
            else:
                self.self.append({"kt": z((rows, H, dh, M), cdt),
                                  "vt": z((rows, H, M, dh), cdt)})

    @property
    def nbytes(self) -> int:
        def size(tree):
            if isinstance(tree, torch.Tensor):
                return tree.numel() * tree.element_size()
            vals = tree.values() if isinstance(tree, dict) else tree
            return sum(size(v) for v in vals)
        return size(self.cross) + size(self.self)

    def fits(self, layout: Layout, dims: Tuple[int, int, int, int]) -> bool:
        return layout == self.layout and all(
            n <= have for n, have in zip(dims, self.dims))

    def cross_views(self, rows_kv: int, T: int) -> List[Dict[str, Any]]:
        """Per layer, the first ``rows_kv`` rows and ``T`` frames: K
        [B, H, dh, T] and V [B, H, T, dh] (codes and scales when
        quantized)."""
        out = []
        for layer in self.cross:
            if "k8t" in layer:
                k, v = layer["k8t"], layer["v8t"]
                out.append({
                    "k8t": {"q": k["q"][:rows_kv, :, :, :T],
                            "scale": k["scale"][:rows_kv]},
                    "v8t": {"q": v["q"][:rows_kv, :, :T],
                            "scale": v["scale"][:rows_kv]}})
            else:
                out.append({"kt": layer["kt"][:rows_kv, :, :, :T],
                            "vt": layer["vt"][:rows_kv, :, :T]})
        return out

    def self_views(self, rows: int, M: int) -> List[Dict[str, torch.Tensor]]:
        """Per layer, the first ``rows`` rows and ``M`` slots of the cache:
        K-like buffers [B, H, ·, M], V-like [B, H, M, ·]."""
        slot_last = ("kt", "kq", "ks")
        return [{name: (t[:rows, :, :, :M] if name in slot_last
                        else t[:rows, :, :M])
                 for name, t in layer.items()} for layer in self.self]


@dataclasses.dataclass
class GraphBuffers:
    """One graph key's fixed buffers: its views of the arena, the loop's
    state and inputs (made by the decode on the key's first call, refilled
    on every call), its generator at t > 0, and its graph once captured."""

    cross_kv: List[Dict[str, Any]]
    self_kv: List[Dict[str, torch.Tensor]]
    generator: Optional[torch.Generator]
    state: Any = None         # decoding._LoopState or _BeamState
    inputs: Any = None
    graph: Optional[torch.cuda.CUDAGraph] = None


class StopFlags:
    """Double-buffered host copies of the loop's [steps, stop] pair: on a
    card, pinned memory written by a non-blocking copy and an event per
    slot; on the CPU the copy is the read."""

    def __init__(self, device: torch.device):
        cuda = device.type == "cuda"
        self._host = torch.zeros((2, 2), dtype=torch.long, pin_memory=cuda)
        self._events = ([torch.cuda.Event() for _ in range(2)]
                        if cuda else None)

    def post(self, slot: int, ctl: torch.Tensor) -> None:
        self._host[slot].copy_(ctl, non_blocking=True)
        if self._events is not None:
            self._events[slot].record()

    def read(self, slot: int) -> Tuple[int, bool]:
        if self._events is not None:
            self._events[slot].synchronize()
        return int(self._host[slot, 0]), bool(self._host[slot, 1])


def drive(launch: Callable[[int], None], ctl: torch.Tensor, n_chunks: int,
          flags: StopFlags) -> Tuple[int, int, int]:
    """Launch chunk 0, 1, ... (at most ``n_chunks``), keeping two in flight:
    chunk i's stop flag is read while chunk i + 1 runs. Returns (loop steps
    taken, chunks launched, flags read). ``ctl`` is the loop's [steps,
    stop] pair; a chunk past the stop runs as overrun and changes nothing.
    Steps -1 say that the ranks of a model axis disagree (``decoding._agree``):
    every rank reads it at the same flag and raises."""
    pending: collections.deque = collections.deque()
    launched = reads = 0
    while True:
        while launched < n_chunks and len(pending) < 2:
            launch(launched)
            flags.post(launched % 2, ctl)
            pending.append(launched % 2)
            launched += 1
        if not pending:
            raise RuntimeError(f"decode loop: no stop after {n_chunks} "
                               f"chunks of {K} steps")
        steps, stop = flags.read(pending.popleft())
        reads += 1
        if steps < 0:
            raise RuntimeError(
                "decode loop: the model axis's ranks disagree on the stop "
                "flag (their tokens differ)")
        if stop:
            return steps, launched, reads


class DecodeGraphs:
    """One model's decode graphs, their arena and their counts. ``lock``
    serialises decode calls on the model: they share the arena."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._flags: Optional[StopFlags] = None
        self._arena: Optional[_Arena] = None
        self._entries: Dict[Any, GraphBuffers] = {}
        self._weights: Optional[Tuple[int, ...]] = None
        self.stats = {"captures": 0, "capture_s": 0.0, "replays": 0,
                      "flag_reads": 0, "arena_allocs": 0}

    @property
    def arena_bytes(self) -> int:
        return 0 if self._arena is None else self._arena.nbytes

    @property
    def graphs(self) -> int:
        return len(self.captured())

    def captured(self) -> List[Any]:
        """The keys whose graph is captured."""
        return [k for k, e in self._entries.items() if e.graph is not None]

    def pool_bytes(self) -> int:
        """Bytes reserved by the graphs' shared memory pool."""
        if self._pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self._pool))

    def release(self) -> None:
        """Drop every graph and the arena."""
        self._entries.clear()
        self._arena = None

    def buffers(self, key, layout: Layout, rows_kv: int, rows: int, T: int,
                M: int, weights: Tuple[int, ...],
                sampling: bool) -> GraphBuffers:
        """The buffers of graph ``key`` (encoder rows, decode rows, encoder
        frames and cache slots as given), its self-KV cache zeroed.
        ``weights`` (the decoder's storage addresses) drops every graph when
        the model's tensors moved; a call the arena cannot hold replaces it
        by one at the larger size (and drops every graph)."""
        if weights != self._weights:
            self.release()
            self._weights = weights
        need = (rows_kv, rows, T, M)
        arena = self._arena
        if arena is None or not arena.fits(layout, need):
            if arena is not None and arena.layout == layout:
                need = tuple(max(a, b) for a, b in zip(need, arena.dims))
            self.release()
            self._arena = _Arena(layout, *need, self.device)
            self.stats["arena_allocs"] += 1
        e = self._entries.get(key)
        if e is None:
            gen = torch.Generator(device=self.device) if sampling else None
            e = GraphBuffers(self._arena.cross_views(rows_kv, T),
                             self._arena.self_views(rows, M), gen)
            self._entries[key] = e
        for layer in e.self_kv:
            for t in layer.values():
                t.zero_()
        return e

    def run(self, e: GraphBuffers, chunk: Callable[[], None],
            ctl: torch.Tensor, n_chunks: int, timer=None) -> int:
        """The token loop of ``e``: ``chunk`` (K steps on ``e``'s state) as
        replays of its graph, captured first when ``e`` has none. Returns
        the loop steps taken."""
        if self._flags is None:
            self._flags = StopFlags(self.device)
        replays = [0]

        def launch(i: int) -> None:
            if e.graph is None:
                self._capture(e, chunk, timer)
            else:
                e.graph.replay()
                replays[0] += 1

        steps, _, reads = drive(launch, ctl, n_chunks, self._flags)
        for counts in (self.stats, COUNTS):
            counts["replays"] += replays[0]
            counts["flag_reads"] += reads
        if timer is not None:
            timer.count("graph_replays", replays[0])
            timer.count("stop_flag_reads", reads)
        return steps

    def _capture(self, e: GraphBuffers, chunk: Callable[[], None],
                 timer) -> None:
        """Run ``chunk`` once eagerly on the capture stream (the call's
        first K steps), then capture it into ``e.graph``."""
        span = (timer.stage("graph_capture", scope="decode")
                if timer is not None else contextlib.nullcontext())
        with span:
            t0 = time.perf_counter()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            cur = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                chunk()
            cur.wait_stream(self._stream)
            g = torch.cuda.CUDAGraph()
            if e.generator is not None:
                g.register_generator_state(e.generator)
            try:
                with torch.cuda.graph(g, pool=self._pool, stream=self._stream,
                                      capture_error_mode="thread_local"):
                    chunk()
            except RuntimeError as exc:
                raise RuntimeError(
                    f"decode graph capture failed: {exc}") from exc
            e.graph = g
            self.stats["captures"] += 1
            COUNTS["captures"] += 1
            self.stats["capture_s"] += time.perf_counter() - t0
        if timer is not None:
            timer.count("graph_captures")


# Each model's DecodeGraphs, dropped with the model. The model is held
# weakly and gets no attribute, so copying or saving it never meets a graph.
_GRAPHS: "weakref.WeakKeyDictionary[torch.nn.Module, DecodeGraphs]" = \
    weakref.WeakKeyDictionary()


def graphs_for(model: torch.nn.Module) -> DecodeGraphs:
    """``model``'s decode graphs, made on first use on its device."""
    g = _GRAPHS.get(model)
    if g is None:
        g = DecodeGraphs(next(model.parameters()).device)
        _GRAPHS[model] = g
    return g


def weights_key(model: torch.nn.Module) -> Tuple[int, ...]:
    """The storage addresses of the decoder's tensors, which a captured
    graph reads."""
    dec = model.decoder
    return tuple(t.data_ptr() for t in
                 list(dec.parameters()) + list(dec.buffers()))
