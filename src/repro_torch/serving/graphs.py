"""The engine's step cache: one captured CUDA graph per shape bucket.

The port's counterpart of the JAX engine's compiled fused steps (JAX
``serving/engine.py``: ``_build_fused_step``, ``_build_fused_block_step``,
``_build_fused_prefill_step``, ``_build_fused_chunk_step``,
``_build_fused_mixed_step``), which trace once per operand-shape bucket
and replay.  Here a step is keyed by the same shapes; its first call is
a miss, which bumps the engine's retrace counter under the JAX name,
counted where the JAX closures count a trace: ``stats["jit_traces"]``
for the decode round and ``stats["block_jit_traces"]`` for the K-block
round, keyed ``(Bp, W)``; ``stats["prefill_jit_traces"]`` for the
prefill batch (length bucket, ``Bp``, whether it writes KV) and the
chunk step (chunk bucket, ``Bp``, ``W``, whether it writes);
``stats["mixed_jit_traces"]`` for the mixed round (its chunk and decode
operands' shapes).  A mixed key holds two steps, the chunk half and the
decode half (:meth:`StepCache.get_many`), counted once: the token choice
runs between them, outside any graph.

On the card, with capture on, a step is captured on its key's second
use, since most buckets of serving traffic are met once and a capture
costs about as much host time as the eager launches it records.  The
first call runs the body eagerly on a side stream over the static input
buffers and returns that result (one-time work such as kernel
attributes, cached scratch and cuBLAS's side-stream workspace happens
there, outside any capture); the second captures the body into a
``torch.cuda.CUDAGraph`` over the same buffers, then replays it once and
returns the replay's output; every later call replays.  Each call first
copies its inputs into the static buffers (host arrays through pinned
memory, device tensors device to device, neither waiting for the card);
a replay is one launch from the host for the whole step.  The engine's
graphs share one memory pool (they run one after another on one
stream).  The retrace counters count a key's first use, as JAX compiles
at first use, so they do not change with the capture policy.

What a replay relies on, and how it is kept:

* the arenas' addresses are baked into the graph: each replay checks
  them against the ones captured and raises if an arena moved;
* the kernel wrappers count their launches on the host, which a replay
  does not run: each graph keeps the :data:`repro_torch.kernels.LAUNCHES`
  delta of its capture (taken back out of the counts, since nothing ran
  then) and adds it at every replay, so the counts stay what the card
  ran;
* a body must not synchronise, upload from pageable memory or allocate
  pinned memory (a capture refuses them, and the capture's error is
  raised; nothing falls back to eager launches);
* the bodies and the arena list are bound methods of the engine, which
  owns the cache, and a step belongs to its cache: each is held weakly
  the other way, so an engine, its cache and its steps form no reference
  cycle, and a dropped engine frees its arenas and graphs at once (a
  cyclic collection that destroyed a graph inside another engine's
  capture would end that capture);
* a step's output is its graph's static buffer, rewritten at the next
  replay of that step: a caller reads it (or enqueues its reads) before
  then.

``pool_bytes`` is the growth of the allocator's reserved bytes across the
captures: what the graphs' shared pool holds.  ``first_use_seconds`` and
``capture_seconds`` are the host seconds of the eager first calls and of
the captures: the totals of the ``graphs.first_use`` and
``graphs.capture`` spans (:mod:`.spans`) in ``stats``.

Without capture (on the CPU, where the port runs its plain versions, or
``PagedEngine(cuda_graphs=False)``) the cache keeps the same keys and
counts, and a call runs the body eagerly on the inputs it was given.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, count_launch
from repro_torch.kernels.rowclone.ops import upload
from .spans import Tracer

Spec = Tuple[Tuple[int, ...], torch.dtype]


class Step:
    """One key's step: a body ``fn(**inputs) -> Tensor``, its inputs and,
    when capturing, the graph with its static inputs and output."""

    def __init__(self, cache: "StepCache", body: Callable[..., torch.Tensor],
                 specs: Dict[str, Spec]) -> None:
        self.cache = weakref.proxy(cache)      # the cache holds its steps
        self._body = weakref.WeakMethod(body)
        self.inputs: Dict[str, torch.Tensor] = {}
        if cache.capture:
            self.inputs = {name: torch.empty(shape, dtype=dtype,
                                             device=cache.device)
                           for name, (shape, dtype) in specs.items()}
        #: calls so far: the first runs eagerly, the second captures
        self.calls = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.output: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}
        self.arena_ptrs: Tuple[int, ...] = ()

    def load(self, name: str, value) -> None:
        """Set input ``name`` from a host array or a device tensor."""
        if not self.cache.capture:
            self.inputs[name] = (value if isinstance(value, torch.Tensor)
                                 else upload(value, self.cache.device))
            return
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.ascontiguousarray(value)).pin_memory()
        self.inputs[name].copy_(value, non_blocking=True)

    @property
    def body(self) -> Callable[..., torch.Tensor]:
        return self._body()

    def __call__(self) -> torch.Tensor:
        self.calls += 1
        if not self.cache.capture:
            return self.body(**self.inputs)
        if self.graph is None:
            if self.calls == 1:
                with self.cache.tracer.span("graphs.first_use"):
                    return self._first_use()
            with self.cache.tracer.span("graphs.capture"):
                self._capture()
        ptrs = self.cache.arena_ptrs()
        if ptrs != self.arena_ptrs:
            raise RuntimeError(
                "a captured step's arenas moved since its capture (the "
                f"graph writes {self.arena_ptrs}, the arenas are at {ptrs})")
        self.graph.replay()
        for name, n in self.launches.items():
            count_launch(name, n)
        return self.output

    def _first_use(self) -> torch.Tensor:
        """Run the body eagerly on the side stream (the warm-up of the
        capture that a second use makes); its result is this call's."""
        cache = self.cache
        main = torch.cuda.current_stream(cache.device)
        side = cache.side_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.body(**self.inputs)
        # later side-stream work (the next first use or capture) waits
        # for main again, so the blocks of ``out`` are not reused under
        # main's reads
        main.wait_stream(side)
        return out

    def _capture(self) -> None:
        """Capture the body over the static buffers; nothing runs on the
        card until the first replay."""
        cache = self.cache
        main = torch.cuda.current_stream(cache.device)
        side = cache.side_stream()
        side.wait_stream(main)
        before = dict(LAUNCHES)
        reserved = torch.cuda.memory_reserved(cache.device)
        graph = torch.cuda.CUDAGraph()
        # capture_begin/end rather than torch.cuda.graph, which also
        # synchronises and empties the allocator's cache: the allocations
        # after it would all go back to cudaMalloc
        with torch.cuda.stream(side):
            graph.capture_begin(pool=cache.pool())
            try:
                self.output = self.body(**self.inputs)
            except Exception:
                # end the broken capture; the body's error is the cause
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        cache.pool_bytes += (torch.cuda.memory_reserved(cache.device)
                             - reserved)
        self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                         if LAUNCHES[k] != before[k]}
        LAUNCHES.update(before)       # the capture ran nothing on the card
        self.arena_ptrs = cache.arena_ptrs()
        self.graph = graph


class StepCache:
    """Steps keyed by ``(counter, *key)``; ``counter`` names the
    ``stats`` entry a miss bumps (the owner's, ``tracer.stats``, where
    the first uses' and captures' spans total too)."""

    def __init__(self, device: torch.device, *, capture: bool,
                 tracer: Tracer,
                 arenas: Callable[[], Sequence[torch.Tensor]]) -> None:
        self.device = device
        self.capture = capture and device.type == "cuda"
        self.tracer = tracer
        self.stats = tracer.stats
        self._arenas = weakref.WeakMethod(arenas)
        self._steps: Dict[tuple, Step] = {}
        self._pool = None
        self._side: Optional[torch.cuda.Stream] = None
        #: reserved bytes the captures added (the graphs' pool)
        self.pool_bytes = 0

    def get(self, counter: str, key: tuple, body: Callable[..., torch.Tensor],
            specs: Dict[str, Spec]) -> Step:
        """The step of ``key``, made (and counted) on a miss; ``specs``
        give its inputs' shapes and dtypes (the static buffers)."""
        return self.get_many(counter, key, [(body, specs)])[0]

    def get_many(self, counter: str, key: tuple,
                 parts: Sequence[Tuple[Callable[..., torch.Tensor],
                                       Dict[str, Spec]]]
                 ) -> Tuple[Step, ...]:
        """The steps of ``key``, one per ``(body, specs)`` part, made on
        a miss and counted once for the whole key."""
        full = (counter,) + tuple(key)
        steps = self._steps.get(full)
        if steps is None:
            self.stats[counter] += 1
            steps = self._steps[full] = tuple(
                Step(self, body, specs) for body, specs in parts)
        return steps

    @property
    def first_use_seconds(self) -> float:
        """Host seconds of the eager first calls."""
        return self.stats["first_use_seconds"]

    @property
    def capture_seconds(self) -> float:
        """Host seconds of the captures."""
        return self.stats["capture_seconds"]

    def arena_ptrs(self) -> Tuple[int, ...]:
        return tuple(a.data_ptr() for a in self._arenas()())

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def side_stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    @property
    def captured(self) -> int:
        """Steps whose graph exists."""
        return sum(s.graph is not None for steps in self._steps.values()
                   for s in steps)

    @property
    def due(self) -> int:
        """Steps whose graph the policy requires: those of every key
        whose steps were each called at least twice (none without
        capture)."""
        if not self.capture:
            return 0
        return sum(len(steps) for steps in self._steps.values()
                   if min(s.calls for s in steps) >= 2)
