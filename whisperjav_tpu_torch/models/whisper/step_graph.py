"""The decode loops' single-token forward, replayed from captured CUDA
graphs.

A decode step's forward (:func:`model.decode_step` at q_len == 1: every
decoder layer, the unfused bf16 layers or the fused int8 blocks, and the
lm head) is ~40 kernel launches at turbo's 4 layers and ~260 at
large-v2's 32, each enqueued from Python; that enqueue, not the card,
set the beam loop's pace. On CUDA the forward is captured once into a
CUDA graph over buffers at fixed addresses, and each step replays it:
one launch. Prefill, the logit rules and the selection stay eager. On
the CPU every step runs the same forward eagerly, its position a tensor
there too, so the CPU tests run the code a graph captures.

What a graph reads or writes, besides the weights and its own
intermediates:

- the cross-K/V, which ``precompute_cross_kv`` writes straight into,
  once a batch, and its scales;
- the self cache, and for beams a second one: the beam reorder gathers
  the rows of one into the other (``index_select(out=)``, no copy back)
  and the pair swaps, each buffer with its own graph; greedy and sampled
  decoding keep to the first;
- the step's token input (rows, 1) and position (one int32, set by a
  fill each step).

The cross-K/V and the caches, a batch's decode state, are allocated by
each loop and freed after it, as an eager loop's are: the encoder runs
beside none of it, and the blocks the allocator keeps between loops
serve the set-up's and the other requests as before. The next loop's
requests, the same sizes in the same order, find the same blocks (the
allocator takes the smallest free block that fits; the encoder
allocates on its own stream); blocks of one size are interchangeable
while unwritten, so each takes the role whose address it has. Where the
addresses are others (the cache was emptied, or a block was taken
since), the plan captures anew. The token, the position and the scales,
a few KiB, which the allocator's small blocks would move every loop,
are the plan's own. Holding the decode state between loops instead
would put it under every encode (turbo +0.8 GiB, large-v2 +1.8 GiB of
peak at B=32 beam 2); allocating it from a pool of its own would keep
it from the blocks the set-up freed (large-v2 +3.5 GiB reserved).

A model keeps a :class:`_Slot` per CUDA device: the graphs' memory pool
(the intermediates and logits of every capture, and of the one eager
forward before the first, which sets up the side stream; replays of one
slot never overlap) and up to ``_PLANS`` :class:`_Plan`, each a loop
shape's graphs (cross-K/V shape and dtype, rows, total length, one
buffer or two, fused or not: the beam loop, the ladder's greedy rungs,
each bucket, a warm-up's short budgets), the least recently used going
past that. The decoder's weights (names, addresses, shapes, dtypes) are
the slot's key too: a model changed in place drops every plan. Nothing
a loop returns aliases a static buffer or a graph's output. Graphs are
captured on a side stream with ``capture_error_mode="thread_local"``
(``--devices N`` decodes each shard from a thread of its own) and
replayed on the decoding stream; a loop on another stream than the
slot's last waits for that stream first. A slot serves one loop at a
time: a model is decoded from one thread at a time (each shard of a mesh
holds its own copy).

The kernels' launch counters (``_build.count``) take a capture's
launches as the graph's, and add them at each replay.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

from whisperjav_tpu_torch.models.whisper.model import (
    CrossKV, KVCache, Whisper, cross_kv_layout, fused_step,
)
from whisperjav_tpu_torch.ops.cuda import _build

# plans a slot keeps: beam loop and greedy rung, at two buckets, and a
# warm-up's short budget of each loop
_PLANS = 6


def _weights_key(model: Whisper) -> tuple:
    """What a captured forward bakes in of the model: its config and each
    decoder parameter's name, address, shape and dtype."""
    return (model.config,) + tuple(
        (name, p.data_ptr(), tuple(p.shape), p.dtype)
        for name, p in model.decoder.named_parameters())


def _in_place_of(bufs: List[torch.Tensor], address: Optional[tuple]
                 ) -> Tuple[List[torch.Tensor], tuple]:
    """Fresh, unwritten buffers of one shape and dtype in the order of
    ``address`` (the addresses a plan's graphs read) where they are the
    same set, else as they come; and their addresses in that order."""
    by_address = {t.data_ptr(): t for t in bufs}
    if address is not None and sorted(by_address) == sorted(address):
        bufs = [by_address[a] for a in address]
    return bufs, tuple(t.data_ptr() for t in bufs)


class _Plan:
    """One loop shape's graphs, one a cache buffer, with their logits and
    the launches each holds; the addresses of the cross-K/V and caches
    they read (None until the first loop); and its token input, position
    and cross-K/V scales."""

    def __init__(self, token: torch.Tensor, pos: torch.Tensor,
                 scales: List[torch.Tensor]):
        self.token, self.pos, self.scales = token, pos, scales
        self.cross_at: Optional[tuple] = None
        self.caches_at: Optional[tuple] = None
        self.graphs: List[Optional[torch.cuda.CUDAGraph]] = [None, None]
        self.logits: List[Optional[torch.Tensor]] = [None, None]
        self.launches: List[dict] = [{}, {}]

    def read_at(self, cross: tuple, caches: tuple) -> None:
        """The buffers' addresses of this loop: other than the graphs'
        drops the graphs."""
        if (cross, caches) != (self.cross_at, self.caches_at):
            self.cross_at, self.caches_at = cross, caches
            self.graphs = [None, None]
            self.logits = [None, None]
            self.launches = [{}, {}]


class _Slot:
    """A model's graph cache on one CUDA device: the graphs' pool, the
    decoder weights' key, the plans (the most recently used last), the
    stream of the last loop, the capture stream and the pool's anchor
    (:meth:`StepForward._capture`)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph_pool = None
        self.weights = None
        self.plans: Dict[tuple, _Plan] = {}
        self.stream = None
        self.side = None
        self.anchor = None

    def plan(self, weights: tuple, key: tuple, make: Callable) -> _Plan:
        """The plan of ``key`` (``make()`` where there is none), made the
        most recently used; past ``_PLANS`` the least recently used goes.
        Other ``weights`` drop every plan first."""
        if weights != self.weights:
            self.plans.clear()
            self.weights = weights
        plan = self.plans.pop(key, None)
        if plan is None:
            plan = make()
        while len(self.plans) >= _PLANS:
            del self.plans[next(iter(self.plans))]
        self.plans[key] = plan
        return plan


_SLOTS: "weakref.WeakKeyDictionary[Whisper, Dict[torch.device, _Slot]]" = \
    weakref.WeakKeyDictionary()
_SLOTS_LOCK = threading.Lock()


def _claim(model: Whisper, device: torch.device) -> Optional[_Slot]:
    """The model's slot on ``device`` for a loop on the current stream;
    None on the CPU."""
    if device.type != "cuda":
        return None
    with _SLOTS_LOCK:
        slots = _SLOTS.setdefault(model, {})
        slot = slots.get(device)
        if slot is None:
            slot = slots[device] = _Slot(device)
    stream = torch.cuda.current_stream(device)
    if slot.stream is not None and slot.stream != stream:
        stream.wait_stream(slot.stream)
    slot.stream = stream
    return slot


class StepForward:
    """One decode loop's cross-K/V (``cross``), self cache (``cache``;
    ``pair`` for beams, which :meth:`reorder`) and single-token forward
    (a call).

    ``forward`` and ``precompute`` are ``decode_step`` and
    ``precompute_cross_kv`` as the caller names them. ``graph_steps``
    counts the steps whose forward was a replay, ``captures`` the graphs
    captured for this loop. On the CPU every step runs ``forward``."""

    def __init__(self, model: Whisper, xa: torch.Tensor, rows: int,
                 total_len: int, int8: bool, int4: bool, pair: bool,
                 forward: Callable, precompute: Callable):
        self.model = model
        self.forward = forward
        self.graph_steps = 0
        self.captures = 0
        self._cur = 0
        dev = xa.device
        cache = ((model.config.n_text_layer, rows, total_len,
                  model.config.n_text_state), model.decoder.tok_emb.dtype)
        self.slot = slot = _claim(model, dev)
        if slot is None:
            self.plan = None
            self.cross = precompute(model, xa, int8=int8, int4=int4)
            self.caches = [KVCache(*(torch.zeros(cache[0], dtype=cache[1],
                                                 device=dev)
                                     for _ in range(2))), None]
            self.pos = torch.zeros((1,), dtype=torch.int32, device=dev)
            return
        (kv, kv_dtype), (scale, scale_dtype) = cross_kv_layout(
            model, xa, int8, int4)

        def make() -> _Plan:
            with torch.inference_mode(False):
                return _Plan(
                    torch.zeros((rows, 1), dtype=torch.long, device=dev),
                    torch.zeros((1,), dtype=torch.int32, device=dev),
                    [torch.ones(scale, dtype=scale_dtype, device=dev)
                     for _ in range(2)])

        self.plan = plan = slot.plan(
            _weights_key(model),
            (kv, kv_dtype, rows, total_len, pair, fused_step(model, kv_dtype)),
            make)
        cross, cross_at = _in_place_of(
            [torch.empty(kv, dtype=kv_dtype, device=dev) for _ in range(2)],
            plan.cross_at)
        self.cross = precompute(model, xa, int8=int8, int4=int4,
                                out=CrossKV(*cross, *plan.scales))
        # after the projection's temporaries are gone, as an eager loop
        bufs, caches_at = _in_place_of(
            [torch.empty(cache[0], dtype=cache[1], device=dev)
             for _ in range(4 if pair else 2)], plan.caches_at)
        plan.read_at(cross_at, caches_at)
        self.caches = [KVCache(*bufs[:2]),
                       KVCache(*bufs[2:4]) if pair else None]
        self.token, self.pos = plan.token, plan.pos
        # zeros beyond the filled slots, as a new cache has
        self.caches[0].k.zero_()
        self.caches[0].v.zero_()

    @property
    def cache(self) -> KVCache:
        return self.caches[self._cur]

    def reorder(self, index: torch.Tensor) -> None:
        """The beam reorder: row r of the cache becomes row ``index[r]``,
        gathered into the other buffer of the pair, which takes over."""
        src = self.caches[self._cur]
        nxt = 1 - self._cur
        if self.caches[nxt] is None:
            self.caches[nxt] = KVCache(torch.empty_like(src.k),
                                       torch.empty_like(src.v))
        dst = self.caches[nxt]
        torch.index_select(src.k, 1, index, out=dst.k)
        torch.index_select(src.v, 1, index, out=dst.v)
        self._cur = nxt

    def __call__(self, token: torch.Tensor, pos: int) -> torch.Tensor:
        """Logits (rows, vocab) f32 of ``token`` (rows,) at ``pos``; the
        K/V column goes into the cache."""
        cache = self.cache
        if not 0 <= pos < cache.k.shape[2]:
            raise ValueError(f"decode step at {pos} outside the cache's "
                             f"{cache.k.shape[2]} positions")
        self.pos.fill_(pos)
        plan = self.plan
        if plan is None:
            logits, _ = self.forward(self.model, token[:, None], self.pos,
                                     cache, self.cross)
            return logits[:, 0]
        self.token.copy_(token[:, None])
        i = self._cur
        if plan.graphs[i] is None:
            self._capture(i)
        plan.graphs[i].replay()
        _build.count_replay(plan.launches[i])
        self.graph_steps += 1
        return plan.logits[i][:, 0]

    def _capture(self, i: int) -> None:
        """Capture the forward over cache buffer ``i`` on the slot's side
        stream. The slot's first capture follows one eager forward there,
        its memory from the graphs' pool (lazy set-up, such as cuBLAS's
        workspace for the stream, must not happen inside a capture; the
        forward writes the same K/V column the replay writes), and a
        one-op graph that keeps the pool's count of captures above zero
        while the slot lives: a graph dropped then gives its memory to
        the next capture, where a pool whose captures were all gone would
        take none."""
        slot, plan = self.slot, self.plan
        dev = slot.device
        with torch.cuda.device(dev):
            first = slot.side is None
            if first:
                slot.side = torch.cuda.Stream(device=dev)
                slot.graph_pool = torch.cuda.MemPool()
            stream = torch.cuda.current_stream(dev)
            slot.side.wait_stream(stream)
            args = (self.model, self.token, self.pos, self.caches[i],
                    self.cross)
            with torch.cuda.stream(slot.side):
                if first:
                    with torch.cuda.use_mem_pool(slot.graph_pool, dev):
                        self.forward(*args)
                    slot.anchor = torch.cuda.CUDAGraph()
                    slot.anchor.capture_begin(
                        pool=slot.graph_pool.id,
                        capture_error_mode="thread_local")
                    self.pos.add_(0)
                    slot.anchor.capture_end()
                graph = torch.cuda.CUDAGraph()
                with _build.capturing() as held:
                    graph.capture_begin(pool=slot.graph_pool.id,
                                        capture_error_mode="thread_local")
                    try:
                        logits, _ = self.forward(*args)
                    finally:
                        graph.capture_end()
            stream.wait_stream(slot.side)
        plan.graphs[i], plan.logits[i], plan.launches[i] = graph, logits, held
        self.captures += 1
