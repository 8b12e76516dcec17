"""The LM decode loop's single-token forward, replayed from a captured
CUDA graph: Qwen3's (``models/qwen/model.py``) and DeepSeek-V3's
(``models/deepseek_v3/model.py``), one loop (``model._decode``) over
either model's step forward and cache.

A decode step's forward (Qwen3's ``model.step_forward``: the embedding gather,
every LM layer with the column attention kernel in each, ``ln_f`` and
the head) is ~1,800 kernels at Qwen3-ASR-1.7B's 28 layers, each
enqueued from Python: at B=32 20-40 ms of host against ~15 ms of
device work a step, so the host set the loop's pace. On CUDA the forward is
captured once into a CUDA graph and each step replays it: one launch.
The token selection (penalty, argmax or sampling, log-softmax, the stop
check), the prefill and the tower stay eager. On the CPU every step runs
the same forward eagerly, its position an int32 tensor there too, so the
CPU tests run the code a graph captures.

What a graph reads or writes, besides the weights and its own
intermediates:

- the loop's cache, a tuple of tensors (L, rows, positions, ...):
  Qwen3's K/V, DeepSeek-V3's latent cache, which ``generate`` or
  ``generate_text`` makes for the loop, as an eager loop's: a cache held between loops would lie
  beside the next prefill's logits and raise the peak by its size (8.8
  GB at B=32, 1,201 positions, f32). The next loop of a shape asks the
  allocator for the same sizes in the same order and finds the same
  blocks; where the cache lies elsewhere, the plan captures anew;
- the plan's token input (rows,) and position (one int32, set by a fill
  each step), which the column kernel reads when it runs.

A model keeps a :class:`_Slot` per CUDA device: the graphs' memory pool
(the intermediates and logits of every capture, and of the one eager
forward before the first, which sets up the side stream; replays of one
slot never overlap) and up to ``_PLANS`` :class:`_Plan`, each a loop
shape's graph (rows, cache length and dtype: a file's loop, a warm-up's
short budget, the translator's prompts), the least recently used going
past that. The LM's weights (names, addresses, shapes, dtypes) are the
slot's key too: a model changed in place drops every plan. A loop
returns nothing that aliases a static buffer or a graph's output. Graphs
are captured on a side stream with ``capture_error_mode="thread_local"``
and replayed on the decoding stream; ``lm_step`` runs inside
``full_f32``, so TF32 stays off in every captured product. A slot
serves one loop at a time.

The kernels' launch counters (``_build.count``) take a capture's
launches as the graph's and add them at each replay; the eager forward
that sets up a slot is not a step and counts nothing.

Whisper's loops have a module of their own (``models/whisper/
step_graph.py``): their plans carry the beam reorder's pair of caches
and the cross-K/V; these, one cache and a device position. The two
share ``_build``'s count helpers.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, Optional

import torch
from torch import nn

from whisperjav_tpu_torch.ops.cuda import _build

# plans a slot keeps: a file's loop and the warm-up's short budget, or
# the translator's cache lengths (30-cue prompts and their answers reach
# five 256-position lengths); each holds its logits, (rows, vocab) f32:
# 19 MB at B=32
_PLANS = 6


def _weights_key(model: nn.Module) -> tuple:
    """What a captured forward bakes in of the model: its config and each
    LM parameter's name, address, shape and dtype (the audio tower's are
    not read)."""
    return (model.config,) + tuple(
        (name, p.data_ptr(), tuple(p.shape), p.dtype)
        for name, p in model.named_parameters()
        if not name.startswith("audio."))


class _Plan:
    """One loop shape's graph, its logits and the launches it holds; the
    cache's addresses it reads (None until its first loop); its token
    input and position."""

    def __init__(self, token: torch.Tensor, pos: torch.Tensor):
        self.token, self.pos = token, pos
        self.cache_at: Optional[tuple] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.launches: dict = {}

    def read_at(self, cache_at: tuple) -> None:
        """The cache's addresses of this loop: other than the graph's
        drops the graph."""
        if cache_at != self.cache_at:
            self.cache_at = cache_at
            self.graph = self.logits = None
            self.launches = {}


class _Slot:
    """A model's graph cache on one CUDA device: the graphs' pool, the
    weights' key, the plans (the most recently used last), the stream of
    the last loop, the capture stream and the pool's anchor
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


_SLOTS: "weakref.WeakKeyDictionary[nn.Module, Dict[torch.device, _Slot]]" \
    = weakref.WeakKeyDictionary()
_SLOTS_LOCK = threading.Lock()


def _claim(model: nn.Module, device: torch.device) -> Optional[_Slot]:
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
    """One decode loop's single-token forward over ``cache`` (a tuple of
    tensors, each (L, rows, positions, ...)), a call:
    ``forward(model, token, pos, cache)`` (the model's ``step_forward``),
    replayed from the plan's graph on CUDA, run eagerly on the CPU.
    ``graph_steps`` counts the steps whose forward was a replay,
    ``captures`` the graphs captured for this loop."""

    def __init__(self, model: nn.Module, cache, forward: Callable):
        self.model, self.cache, self.forward = model, cache, forward
        self.graph_steps = 0
        self.captures = 0
        rows, t_max = cache[0].shape[1:3]
        dev = cache[0].device
        self.slot = slot = _claim(model, dev)
        if slot is None:
            self.plan = None
            self.pos = torch.zeros((1,), dtype=torch.int32, device=dev)
            return

        def make() -> _Plan:
            with torch.inference_mode(False):
                return _Plan(
                    torch.zeros((rows,), dtype=torch.long, device=dev),
                    torch.zeros((1,), dtype=torch.int32, device=dev))

        self.plan = plan = slot.plan(_weights_key(model),
                                     (rows, t_max, cache[0].dtype), make)
        plan.read_at(tuple(t.data_ptr() for t in cache))
        self.pos = plan.pos

    def __call__(self, token: torch.Tensor, pos: int) -> torch.Tensor:
        """Logits (rows, vocab) f32 of ``token`` (rows,) at ``pos``; the
        step's column goes into the cache. On CUDA the logits are the
        plan's own, overwritten by the next step's replay."""
        t_max = self.cache[0].shape[2]
        if not 0 <= pos < t_max:
            raise ValueError(f"decode step at {pos} outside the cache's "
                             f"{t_max} positions")
        self.pos.fill_(pos)
        plan = self.plan
        if plan is None:
            return self.forward(self.model, token, self.pos, self.cache)
        plan.token.copy_(token)
        if plan.graph is None:
            self._capture()
        plan.graph.replay()
        _build.count_replay(plan.launches)
        self.graph_steps += 1
        return plan.logits

    def _capture(self) -> None:
        """Capture the forward on the slot's side stream. The slot's
        first capture follows one eager forward there, its memory from
        the graphs' pool (lazy set-up, such as cuBLAS's workspace for the
        stream, must not happen inside a capture; the forward writes the
        column the replay writes again), and a one-op graph that
        keeps the pool's count of captures above zero while the slot
        lives: a graph dropped then gives its memory to the next capture,
        where a pool whose captures were all gone would take none."""
        slot, plan = self.slot, self.plan
        dev = slot.device
        with torch.cuda.device(dev):
            first = slot.side is None
            if first:
                slot.side = torch.cuda.Stream(device=dev)
                slot.graph_pool = torch.cuda.MemPool()
            stream = torch.cuda.current_stream(dev)
            slot.side.wait_stream(stream)
            args = (self.model, plan.token, plan.pos, self.cache)
            with torch.cuda.stream(slot.side):
                if first:
                    with _build.capturing(), \
                            torch.cuda.use_mem_pool(slot.graph_pool, dev):
                        self.forward(*args)
                    slot.anchor = torch.cuda.CUDAGraph()
                    slot.anchor.capture_begin(
                        pool=slot.graph_pool.id,
                        capture_error_mode="thread_local")
                    plan.pos.add_(0)
                    slot.anchor.capture_end()
                graph = torch.cuda.CUDAGraph()
                with _build.capturing() as held:
                    graph.capture_begin(pool=slot.graph_pool.id,
                                        capture_error_mode="thread_local")
                    try:
                        logits = self.forward(*args)
                    finally:
                        graph.capture_end()
            stream.wait_stream(slot.side)
        plan.graph, plan.logits, plan.launches = graph, logits, held
        self.captures += 1
