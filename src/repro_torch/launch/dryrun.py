"""Dry run: trace one rank's step of every (arch x shape) cell at the
production mesh, under a fake process group, and count its work.

The port's counterpart of the JAX package's ``launch/dryrun.py``, the
repo's planning tool: does one rank's share of a cell fit a card, and
which roofline term bounds it?

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --device meta
  python -m repro_torch.launch.dryrun --arch minitron-8b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --jobs 4 --device meta [--skip-existing]

Artifacts: experiments/dryrun_torch/<arch>__<shape>__<mesh>.json, where
``<mesh>`` is the production mesh's tag (16x16 or 2x16x16).

Kept from the JAX dryrun as they are: ``PARALLEL_OVERRIDES``,
:func:`parallel_for`, :func:`enc_dec_split`, :func:`input_specs` (meta
tensors for ShapeDtypeStructs), :func:`batch_pspecs`, :func:`all_cells`,
:func:`analytic_memory` (its arithmetic unchanged, the TPU's 16x16
layout assumed) and :func:`_cost_scaled_cfgs`.

What takes the place of lowering.  The JAX dryrun lets GSPMD partition
the step over the whole mesh and reads XLA's analyses.  The port shards
by hand and has no HLO: :func:`trace_cell` joins a fake process group
(``torch.testing._internal.distributed.fake_pg``: collectives that
move nothing) at the cell's world (256 or 512) as one rank, builds that
rank's parameter slices, optimizer state, cache and batch at their
local shapes, and runs one step of the port's own layout once, under
``FlopCounterMode`` and a dispatch mode that counts the bytes every
aten op reads and writes (:class:`_Traffic`).  Those bytes are the
unfused traffic the eager step launches, larger than XLA's post-fusion
"bytes accessed"; views and bare allocations move nothing and are not
counted.  The
collective bytes by kind come from ``Mesh.collective_bytes()``.  Every
number is one rank's.

The layouts (the record names its ``layout`` and ``rank_mesh``):

* every cell, ``rules``: the JAX dryrun's own layout on its mesh,
  ``{"data": 16, "model": 16}`` or ``{"pod": 2, "data": 16, "model":
  16}``: every parameter, optimizer moment, cache leaf and batch input
  is the block JAX's ``param_specs`` (FSDP hint on), ``cache_pspecs``
  and ``batch_pspecs`` give the device at the rank's coordinates, for
  every family: tensor parallelism over ``model`` where a dim divides
  it, FSDP slices gathered over the batch axes a layer at a time, MoE
  in the expert-parallel body.  A serving step is
  ``forward(rules=transformer.rule_layout(...))``, the cache's sequence
  over ``model`` with decode attention merged across it; a train step
  is ``make_train_step(rules=)``, whose model-axis collectives carry
  their backward, its gradients reduce-scattered over the batch axes
  (a multi-pod rank holds 8 of the 256 sequences).  The microbatch
  count is cut to a divisor of the rank's batch.
* ``trace_cell(model=m)`` reshapes that: a train cell at m = 1 takes
  ``zero3``, ZeRO-3 over one data axis, ``{"data": world, "model":
  1}`` under ``sharding_env(mesh, fsdp=True)``, as the JAX launcher
  trains, and at m > 1 ``rules`` on ``{"data": world // m, "model":
  m}``; a serving cell takes the serving engine's tensor-parallel step,
  ``tensor_parallel`` on ``{"data": world // m, "model": m}``
  (``forward(tp=_TP)``, dense layers only, the cache the rank's KV-head
  slice), or ``replica`` at m = 1 (whole weights a rank).

A batch that does not divide the batch axes (``long_500k``'s one row)
stays whole on every rank, as ``resolve_spec`` leaves it, and so does
any dim that does not divide the mesh axes it is ruled onto
(``resolve_spec``'s fallback): a path computed whole on every ``model``
rank is not summed over it.  A cell whose step the port cannot run in
its layout (its forward, optimizer or layout raises
``NotImplementedError`` or ``ValueError``) is recorded with
``"unsupported"``: the port's own error text, and no roofline.

No depth extrapolation: the JAX dryrun scans its layers, XLA's cost
analysis counts a ``while`` body once, so it lowered two reduced depths
and extrapolated (``cost_metrics_extrapolated``).  The port's forward
walks its layers in a Python loop and the trace counts every one, so the
record is the full-depth trace; :func:`extrapolate` keeps the affine rule
as a self-check.  Attention runs in tiles of ``attention_chunk=4096``,
the JAX dryrun's cost setting (the record gives the chunk).

On the card (``device=None``, or ``"cuda"``) the tensors are real:
values from a seeded generator drawn at each slice's shape (never a
whole leaf cut down).  The fake collectives leave their outputs as the
allocator handed them over, so shapes and bytes are exact and values
are not; no shape of the step depends on a value.  The record then adds
the peak allocated and reserved bytes above what the process held when
the trace began (``baseline_bytes``, none in a fresh process) and the
step's time in CUDA events, compute only.  A rank that runs out of memory is recorded with
``fits_hbm_measured: false`` and the allocator's message.  ``"meta"``
is the abstract pass: no memory, no time.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCHS, SHAPES, OptimizerConfig,
                                 ParallelConfig, cells_for)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (local_shape, resolve_spec,
                                              sharding_env)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.models.params import (ParamDef, draw_leaf, param_count,
                                       param_specs, param_specs_for_mesh,
                                       tree_leaves, tree_unflatten)
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import hw
from repro_torch.serving.engine import _TP
from repro_torch.training import train_step as ts
from repro_torch.training.optimizer import make_optimizer

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__),
                            "../../../experiments/dryrun_torch")
_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "../.."))

# Per-arch parallel overrides for the production dry-run (big configs use
# bf16 masters + bf16 optimizer moments and more microbatches), as the
# JAX dryrun sets them.
PARALLEL_OVERRIDES: Dict[str, Dict[str, Any]] = {
    "jamba-1.5-large-398b": dict(param_dtype="bfloat16",
                                 opt_state_dtype="bfloat16", microbatches=8),
    "deepseek-v2-236b": dict(param_dtype="bfloat16",
                             opt_state_dtype="bfloat16", microbatches=8),
    "llava-next-34b": dict(param_dtype="bfloat16",
                           opt_state_dtype="bfloat16", microbatches=8),
    "llama4-scout-17b-a16e": dict(microbatches=8),
    "granite-3-8b": dict(microbatches=4),
    "minitron-8b": dict(microbatches=2),
}
#: the attention tile of the trace (the JAX dryrun's cost lowering's)
TRACE_ATTENTION_CHUNK = 4096


def parallel_for(cfg: ModelConfig, multi_pod: bool,
                 **overrides) -> ParallelConfig:
    kw: Dict[str, Any] = dict(multi_pod=multi_pod, remat="full",
                              attention_impl="chunked", moe_impl="shard_map")
    kw.update(PARALLEL_OVERRIDES.get(cfg.name, {}))
    kw.update(overrides)
    return ParallelConfig(**kw)


# --------------------------------------------------------------------- #
# input_specs: meta tensors for every model input
# --------------------------------------------------------------------- #


def enc_dec_split(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[int, int]:
    """(enc_len, dec_len) of an encoder-decoder cell."""
    if shape.kind == "train":
        return shape.seq_len // 2, shape.seq_len // 2
    if shape.kind == "prefill":
        return 4096, shape.seq_len - 4096
    return 4096, shape.seq_len  # decode: dec KV budget = seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                pcfg: Optional[ParallelConfig] = None
                ) -> Dict[str, torch.Tensor]:
    """The step's global batch as meta tensors (shape and dtype only)."""
    del pcfg
    B, S = shape.global_batch, shape.seq_len
    fd = cfg.frontend_dim or cfg.d_model
    i32, f32 = torch.int32, torch.float32

    if shape.kind == "train":
        if cfg.family == "encdec":
            e, d = enc_dec_split(cfg, shape)
            return {"tokens": _meta((B, d), i32),
                    "labels": _meta((B, d), i32),
                    "frames": _meta((B, e, fd), f32)}
        if cfg.family == "vlm":
            return {"tokens": _meta((B, S - cfg.num_patch_tokens), i32),
                    "labels": _meta((B, S), i32),
                    "patch_embeds": _meta((B, cfg.num_patch_tokens, fd),
                                          f32)}
        return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}

    if shape.kind == "prefill":
        if cfg.family == "encdec":
            e, d = enc_dec_split(cfg, shape)
            return {"tokens": _meta((B, d), i32),
                    "frames": _meta((B, e, fd), f32)}
        if cfg.family == "vlm":
            return {"tokens": _meta((B, S - cfg.num_patch_tokens), i32),
                    "patch_embeds": _meta((B, cfg.num_patch_tokens, fd),
                                          f32)}
        return {"tokens": _meta((B, S), i32)}

    # decode
    return {"tokens": _meta((B, 1), i32)}


def batch_pspecs(cfg: ModelConfig, batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: resolve_spec(v.shape, ("batch",) + (None,) * (len(v.shape) - 1))
            for k, v in batch.items()}


# --------------------------------------------------------------------- #
# Meshes and layouts
# --------------------------------------------------------------------- #


class MeshShape:
    """A mesh's shape with no process group behind it: all that
    ``resolve_spec``, ``local_shape`` and ``sharding_env`` read."""

    def __init__(self, shape: Dict[str, int]) -> None:
        self.shape = dict(shape)

    def __enter__(self) -> "MeshShape":
        return self

    def __exit__(self, *exc) -> None:
        return None


def production_mesh_shape(multi_pod: bool) -> MeshShape:
    """The JAX package's production mesh, (16, 16) or (2, 16, 16)."""
    return MeshShape({"pod": 2, "data": 16, "model": 16} if multi_pod
                     else {"data": 16, "model": 16})


def mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def production_world(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


@dataclasses.dataclass(frozen=True)
class Layout:
    """The port's layout of one cell: ``zero3``, ``rules``,
    ``tensor_parallel`` or ``replica`` (see the module docstring) over
    ``mesh``."""
    name: str
    mesh: Dict[str, int]

    @property
    def model(self) -> int:
        return self.mesh["model"]


def plan_layout(shape: ShapeConfig, world: int, model: Optional[int] = None,
                multi_pod: bool = False) -> Layout:
    """The cell's layout at ``world`` ranks.  Every cell takes the rule
    set's layout on the JAX dryrun's mesh (the production mesh at its
    world; elsewhere ``{"data": world // m, "model": m}``, m the largest
    of 16, 8, 4, 2, 1 dividing ``world``).  ``model`` sets the model
    axis instead: a train cell takes ZeRO-3 at 1 and the rule set's
    layout above it, a serving cell the engine's tensor-parallel step
    (a replica at 1)."""
    if model is None:
        if world == production_world(multi_pod):
            return Layout("rules", production_mesh_shape(multi_pod).shape)
        m = next(k for k in (16, 8, 4, 2, 1) if world % k == 0)
        return Layout("rules", {"data": world // m, "model": m})
    if shape.kind == "train":
        m, name = model, ("rules" if model > 1 else "zero3")
    else:
        m, name = model, ("tensor_parallel" if model > 1 else "replica")
    if world % m:
        raise ValueError(f"model axis {m} does not divide {world} ranks")
    return Layout(name, {"data": world // m, "model": m})


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """Join a fake process group (collectives that move nothing) of
    ``world`` ranks as ``rank`` for the ``with`` block, and leave it."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised;"
                           " the dry run joins a fake one of its own")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:          # not a public API of torch
        raise RuntimeError(f"torch {torch.__version__} has no fake process "
                           f"group (torch.testing._internal.distributed."
                           f"fake_pg): {e}") from e
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------- #
# Counting
# --------------------------------------------------------------------- #


_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
                torch.ops.aten.new_empty_strided, torch.ops.aten._unsafe_view,
                torch.ops.aten.lift_fresh}


# in-place ops that overwrite their destination without reading it
_OVERWRITES = {torch.ops.aten.copy_, torch.ops.aten.fill_,
               torch.ops.aten.zero_, torch.ops.aten.normal_,
               torch.ops.aten.uniform_, torch.ops.aten.random_,
               torch.ops.aten.bernoulli_, torch.ops.aten.exponential_}


def _tensor_bytes(tree, skip=()) -> int:
    return sum(t.numel() * t.element_size() for t in _pytree_leaves(tree)
               if isinstance(t, torch.Tensor)
               and not any(t is s for s in skip))


class _Traffic(TorchDispatchMode):
    """The bytes every aten op reads and writes, each once: its tensor
    operands are read, except a destination it only writes (an ``out=``
    argument, or ``copy_``'s and the fills' ``self``); the arguments it
    mutates and the results that are not an argument are written.  So
    ``add_(a, b)`` moves 3 a-sized tensors, ``copy_(dst, src)`` two,
    ``zero_`` one.  An op that writes part of its destination
    (``index_put_``, ``scatter_``) counts the whole destination.  A
    view or a bare allocation moves nothing and is skipped; collectives
    are counted by the mesh."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "aten" and not func.is_view \
                and func.overloadpacket not in _ALLOCATIONS:
            self.ops += 1
            mutated, write_only = [], []
            overwrite = func.overloadpacket in _OVERWRITES
            for i, a in enumerate(func._schema.arguments):
                if a.alias_info is None or not a.alias_info.is_write:
                    continue
                v = kwargs.get(a.name, args[i] if i < len(args) else None)
                mutated.append(v)
                if a.kwarg_only or overwrite:
                    write_only.append(v)
            write_only = _pytree_leaves(write_only)
            inputs = _pytree_leaves((args, kwargs))
            self.bytes += (_tensor_bytes((args, kwargs), write_only)
                           + _tensor_bytes(mutated)
                           + _tensor_bytes(out, inputs))
        return out


def _counted(fn):
    """(fn's result, flops, bytes, aten ops) of one call."""
    with FlopCounterMode(display=False) as flops, _Traffic() as traffic:
        out = fn()
    return out, int(flops.get_total_flops()), traffic.bytes, traffic.ops


# --------------------------------------------------------------------- #
# One rank's inputs
# --------------------------------------------------------------------- #


class _Maker:
    """This rank's tensors: meta, or drawn on the card from a seeded
    generator at their own shapes."""

    def __init__(self, device: torch.device, seed: int) -> None:
        self.dev = device
        self.gen = None
        if device.type != "meta":
            self.gen = torch.Generator(device=device).manual_seed(seed)

    def leaf(self, d: ParamDef, shape, dtype) -> torch.Tensor:
        if self.gen is None:
            return _meta(shape, dtype)
        return draw_leaf(d, self.gen, self.dev, dtype, tuple(shape))

    def like(self, spec: torch.Tensor, shape, vocab: int = 0
             ) -> torch.Tensor:
        """A batch input: token ids below ``vocab``, else normal."""
        if self.gen is None:
            return _meta(shape, spec.dtype)
        if vocab:
            return torch.randint(0, vocab, tuple(shape), generator=self.gen,
                                 dtype=spec.dtype, device=self.dev)
        return torch.randn(tuple(shape), generator=self.gen,
                           dtype=spec.dtype, device=self.dev)

    def zeros(self, shape, dtype) -> torch.Tensor:
        if self.gen is None:
            return _meta(shape, dtype)
        return torch.zeros(tuple(shape), dtype=dtype, device=self.dev)

    def full(self, shape, value: int, dtype) -> torch.Tensor:
        if self.gen is None:
            return _meta(shape, dtype)
        return torch.full(tuple(shape), value, dtype=dtype, device=self.dev)


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _pytree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _env(layout: Layout, ms: MeshShape):
    """The sharding env the layout's specs resolve under."""
    return sharding_env(ms, multi_pod="pod" in ms.shape,
                        fsdp=layout.name in ("zero3", "rules"))


def _param_specs(defs, layout: Layout, ms: MeshShape) -> Dict[str, Any]:
    if layout.name in ("zero3", "rules"):
        with _env(layout, ms):
            return dict(tree_leaves(param_specs(defs)))
    if layout.name == "tensor_parallel":
        return dict(tree_leaves(param_specs_for_mesh(defs, ms)))
    return {path: () for path, _ in tree_leaves(defs)}


def _rank_params(defs, layout: Layout, ms: MeshShape, dtype, make: _Maker):
    specs = _param_specs(defs, layout, ms)
    flat = {path: make.leaf(d, local_shape(d.shape, specs[path], ms), dtype)
            for path, d in tree_leaves(defs)}
    return tree_unflatten(defs, flat)


def _rank_batch(cfg, shape, layout: Layout, ms: MeshShape, make: _Maker):
    specs = input_specs(cfg, shape)
    with _env(layout, ms):
        pspecs = batch_pspecs(cfg, specs)
    return {k: make.like(v, local_shape(v.shape, pspecs[k], ms),
                         vocab=cfg.vocab_size if v.dtype == torch.int32
                         else 0)
            for k, v in specs.items()}


def _rank_cache(cfg, shape, pcfg, layout: Layout, ms: MeshShape, b: int,
                make: _Maker):
    """The decode cache: under the rule set this rank's block of the
    global batch's cache (``cache_pspecs``); else ``b`` rows, the
    KV-head slice of them under the engine's tensor parallelism."""
    enc_len = enc_dec_split(cfg, shape)[0] if cfg.family == "encdec" else 0
    kvd = torch.float8_e4m3fn if pcfg.kv_cache_dtype.startswith("float8") \
        else None
    m = layout.model if layout.name == "tensor_parallel" else 1
    if layout.name == "rules":
        b = shape.global_batch
        with _env(layout, ms):
            specs = dict(tree_leaves(T.cache_pspecs(cfg, b, shape.seq_len,
                                                    enc_len)))

    def one(path, pair):
        out = []
        for t, sp in zip(pair, specs[path] if layout.name == "rules"
                         else ((),) * len(pair)):
            s = list(local_shape(t.shape, sp, ms))
            if m > 1:
                s[3] //= m                   # (layers, b, S, kv heads, hd)
            out.append(make.zeros(s, t.dtype))
        return tuple(out)

    spec = T.cache_spec(cfg, b, shape.seq_len, enc_len, kv_dtype=kvd)
    return tree_unflatten(spec, {p: one(p, pair)
                                 for p, pair in tree_leaves(spec)})


def rank_arguments(cfg: ModelConfig, shape: ShapeConfig, *, multi_pod: bool,
                   device: DeviceLike = "meta") -> Dict[str, Any]:
    """A cell's rank-0 arguments in its layout at the production world,
    built without a process group or a step: ``layout`` and ``batch``,
    and a train cell's ``state`` (parameters in ``param_dtype`` and
    AdamW's moments in ``opt_state_dtype``, as ``init_state`` makes
    them) or a serving cell's ``params``, ``cache`` and ``lengths`` (the
    blocks :func:`trace_cell` hands the step)."""
    layout = plan_layout(shape, production_world(multi_pod),
                         multi_pod=multi_pod)
    pcfg, ms = parallel_for(cfg, multi_pod), MeshShape(layout.mesh)
    make = _Maker(resolve_device(device), seed=0)
    if shape.kind != "train":
        return _serving_args(cfg, shape, pcfg, layout, ms, make)
    params = _rank_params(T.model_defs(cfg), layout, ms,
                          _dtype(pcfg.param_dtype), make)
    opt_init, _ = make_optimizer(OptimizerConfig(),
                                 _dtype(pcfg.opt_state_dtype))
    return {"layout": layout,
            "state": {"params": params, "opt": opt_init(params)},
            "batch": _rank_batch(cfg, shape, layout, ms, make)}


def _serving_args(cfg, shape, pcfg, layout: Layout, ms: MeshShape,
                  make: _Maker) -> Dict[str, Any]:
    batch = _rank_batch(cfg, shape, layout, ms, make)
    b_local = batch["tokens"].shape[0]
    params = _rank_params(T.model_defs(cfg), layout, ms, torch.bfloat16, make)
    cache = _rank_cache(cfg, shape, pcfg, layout, ms, b_local, make)
    S = shape.seq_len
    if cfg.family == "encdec" and shape.kind == "prefill":
        S = batch["tokens"].shape[1]
    return {"layout": layout, "params": params, "cache": cache,
            "batch": batch, "lengths": make.full((b_local,), S, torch.int32)}


def _largest_divisor(n: int, at_most: int) -> int:
    return max(k for k in range(1, max(min(n, at_most), 1) + 1) if n % k == 0)


# --------------------------------------------------------------------- #
# trace_cell: one rank's step, counted
# --------------------------------------------------------------------- #


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, *, multi_pod: bool,
               parallel_overrides: Optional[Dict[str, Any]] = None,
               rank: int = 0, device: DeviceLike = None,
               world: Optional[int] = None,
               model: Optional[int] = None) -> Dict[str, Any]:
    """Run one step of the cell as rank ``rank`` of the port's layout
    (see the module docstring) and return its record.  ``world``
    (default: the production mesh's 256 or 512 ranks) and ``model``
    (default: the planned model axis) reshape the world, for tests.
    ``device``: None is the card, ``"meta"`` the abstract pass."""
    dev = resolve_device(device)
    world = world or production_world(multi_pod)
    over = {"attention_chunk": TRACE_ATTENTION_CHUNK}
    over.update(parallel_overrides or {})
    pcfg = parallel_for(cfg, multi_pod, **over)
    defs = T.model_defs(cfg)
    n_params = param_count(defs)
    layout = plan_layout(shape, world, model, multi_pod)
    ms = MeshShape(layout.mesh)
    info = {"arch": cfg.name, "shape": shape.name,
            "mesh": mesh_tag(multi_pod), "chips": world, "params": n_params,
            "param_dtype": pcfg.param_dtype,
            "opt_state_dtype": pcfg.opt_state_dtype,
            "microbatches": pcfg.microbatches}
    analytic = analytic_memory(cfg, shape, info) if world % 16 == 0 else None
    rec: Dict[str, Any] = dict(
        info, layout=layout.name, rank_mesh=layout.mesh, rank=rank,
        device=dev.type, attention_chunk=pcfg.attention_chunk,
        microbatches_requested=pcfg.microbatches,
        memory={"analytic_bytes_per_device": analytic,
                "hbm_bytes": hw.HBM_BYTES,
                "fits_hbm_analytic": (None if analytic is None
                                      else bool(analytic <= hw.HBM_BYTES))})
    if shape.kind != "train":
        rec["param_dtype"] = "bfloat16"           # serving: bf16 weights
    on_card = dev.type == "cuda"
    if on_card:
        torch.empty(0, device=dev)    # the allocator's stats exist from here
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        # what the process already holds (none in a fresh one): the
        # peaks below are the trace's own, above it
        base = {"allocated": torch.cuda.memory_allocated(dev),
                "reserved": torch.cuda.memory_reserved(dev)}
        rec["memory"]["baseline_bytes"] = base["allocated"]
        rec["memory"]["baseline_reserved_bytes"] = base["reserved"]
    t0 = time.perf_counter()
    try:
        with fake_group(world, rank):
            _trace(cfg, shape, pcfg, layout, ms, dev, rec)
    except (NotImplementedError, ValueError) as e:
        rec["unsupported"] = f"{type(e).__name__}: {e}"
    except torch.cuda.OutOfMemoryError as e:
        rec["memory"]["fits_hbm_measured"] = False
        rec["memory"]["out_of_memory"] = str(e).splitlines()[0]
    finally:
        if on_card:
            gc.collect()
            rec["memory"]["peak_bytes_per_device"] = \
                torch.cuda.max_memory_allocated(dev) - base["allocated"]
            rec["memory"]["peak_reserved_bytes"] = \
                torch.cuda.max_memory_reserved(dev) - base["reserved"]
            torch.cuda.empty_cache()
    rec["trace_s"] = time.perf_counter() - t0
    return rec


def _trace(cfg, shape, pcfg, layout: Layout, ms: MeshShape, dev,
           rec) -> None:
    """Build this rank's inputs, run the step once counted (and once
    timed on the card), and fill ``rec``."""
    make = _Maker(dev, seed=0)
    mesh = Mesh(layout.mesh)
    defs = T.model_defs(cfg)
    if shape.kind == "train":
        batch = _rank_batch(cfg, shape, layout, ms, make)
        b_local = batch["tokens"].shape[0]
    else:
        a = _serving_args(cfg, shape, pcfg, layout, ms, make)
        batch = a["batch"]
    rec["batch_local"] = {k: list(v.shape) for k, v in batch.items()}

    if shape.kind == "train":
        mb = _largest_divisor(b_local, pcfg.microbatches)
        pcfg = dataclasses.replace(pcfg, microbatches=mb)
        rec["microbatches"] = mb
        rules = T.rule_layout(cfg, mesh) if layout.name == "rules" else None
        with sharding_env(mesh, multi_pod="pod" in ms.shape, fsdp=True):
            params = _rank_params(defs, layout, ms,
                                  _dtype(pcfg.param_dtype), make)
            init_state, step = ts.make_train_step(
                cfg, pcfg, OptimizerConfig(),
                state_dtype=_dtype(pcfg.opt_state_dtype), mesh=mesh,
                rules=rules)
            state = init_state(params)
            del params
        args = (state, batch)

        def run():          # ZeRO-3's step reads the env as it runs
            with sharding_env(mesh, multi_pod="pod" in ms.shape, fsdp=True):
                return step(*args)
    else:
        params, cache, lengths = a["params"], a["cache"], a["lengths"]
        del a
        tp = _TP(mesh, False) if layout.name == "tensor_parallel" else None
        rules = None
        if layout.name == "rules":
            enc = enc_dec_split(cfg, shape)[0] \
                if cfg.family == "encdec" else 0
            rules = T.rule_layout(cfg, mesh, global_batch=shape.global_batch,
                                  max_len=shape.seq_len, enc_len=enc)
        if shape.kind == "prefill":
            step = ts.make_prefill_step(cfg, pcfg, tp=tp, rules=rules)
            args = (params, batch, cache, lengths)
        else:
            step = ts.make_decode_step(cfg, pcfg, tp=tp, rules=rules)
            args = (params, batch, cache, shape.seq_len - 1, lengths)

        def run():
            return step(*args)
    rec["memory"]["argument_bytes"] = _nbytes(args)
    rec["memory"]["fits_hbm_arguments"] = bool(
        rec["memory"]["argument_bytes"] <= hw.HBM_BYTES)

    mesh.reset_collectives()
    out, flops, nbytes, n_ops = _counted(run)
    del out
    coll = mesh.collective_bytes()
    counts = coll.pop("_counts")
    terms = ra.RooflineTerms(
        flops=float(flops), hbm_bytes=float(nbytes),
        coll_bytes=float(ra.collective_bytes_total(coll)),
        chips=rec["chips"],
        model_flops=ra.model_flops(cfg, shape, rec["params"]))
    rec["traced"] = {"flops": flops, "bytes": nbytes, "aten_ops": n_ops}
    rec["collectives"] = coll
    rec["collective_counts"] = counts
    rec["roofline"] = terms.as_dict()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run()
        end.record()
        torch.cuda.synchronize(dev)
        del out
        rec["step_ms"] = start.elapsed_time(end)
        rec["memory"]["fits_hbm_measured"] = True


# --------------------------------------------------------------------- #
# First-principles memory, and the depth self-check
# --------------------------------------------------------------------- #


def analytic_memory(cfg: ModelConfig, shape: ShapeConfig,
                    info: Dict[str, Any]) -> int:
    """First-principles per-device HBM estimate of the JAX package's
    layout (model axis 16, TPU dtype semantics), unchanged.

    train: params + grads + 2 opt moments (all sharded over every chip)
           + remat carry stacks + working set allowance.
    serve: bf16 params + KV cache (batch x seq sharded) + activations.
    """
    chips = info["chips"]
    n = info["params"]
    pbytes = 2 if info["param_dtype"] == "bfloat16" else 4
    sbytes = 2 if info["opt_state_dtype"] == "bfloat16" else 4
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    data_shards = chips // 16  # model axis = 16 on both meshes
    b_local = max(B // data_shards, 1)
    mb = max(info.get("microbatches", 1), 1)

    if shape.kind == "train":
        states = n * (pbytes + 4 + 2 * sbytes) / chips  # +grads fp32
        carry = cfg.num_layers * (b_local // mb) * S * d * 2  # bf16 stacks
        work = 4 * (b_local // mb) * S * d * 4  # a few fp32 working copies
        return int(states + carry + work)

    # serving: bf16 params + cache + small activations
    params_b = n * 2 / chips
    hd = cfg.resolved_head_dim
    if cfg.mla:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
        layers = cfg.num_layers
    elif cfg.family == "ssm":
        per_tok, layers = 0, 0
    elif cfg.family == "hybrid":
        per_tok = 2 * cfg.num_kv_heads * hd
        layers = cfg.num_layers // cfg.attn_every
    elif cfg.family == "encdec":
        per_tok = 2 * cfg.num_kv_heads * hd
        layers = cfg.dec_layers
    else:
        per_tok = 2 * cfg.num_kv_heads * hd
        layers = cfg.num_layers
    cache = layers * B * S * per_tok * 2 / chips  # sharded batch x seq
    if cfg.ssm:
        s_ = cfg.ssm
        d_in = s_.expand * d
        nh = d_in // s_.head_dim
        n_ssm = (cfg.num_layers - cfg.num_layers // cfg.attn_every
                 if cfg.family == "hybrid" else cfg.num_layers)
        cache += n_ssm * B * nh * s_.head_dim * s_.state_dim * 4 / max(data_shards, 1)
    toks = B if shape.kind == "decode" else B * S
    act = 6 * (toks // max(data_shards, 1)) * d * 2
    return int(params_b + cache + act)


def _cost_scaled_cfgs(cfg: ModelConfig):
    """Two reduced-depth variants (n = uniform-group repeat count) plus
    the full repeat count, for affine cost extrapolation."""
    dc = dataclasses
    if cfg.family == "hybrid":
        per = cfg.attn_every  # one superblock = `per` sublayers
        return ([(dc.replace(cfg, num_layers=per), 1),
                 (dc.replace(cfg, num_layers=2 * per), 2)],
                cfg.num_layers // per)
    if cfg.family == "encdec":
        return ([(dc.replace(cfg, enc_layers=2, dec_layers=2, num_layers=4), 1),
                 (dc.replace(cfg, enc_layers=4, dec_layers=4, num_layers=8), 2)],
                cfg.enc_layers // 2)
    if cfg.moe and cfg.moe.first_dense_layers:
        fd = cfg.moe.first_dense_layers
        return ([(dc.replace(cfg, num_layers=fd + 2), 2),
                 (dc.replace(cfg, num_layers=fd + 4), 4)],
                cfg.num_layers - fd)
    return ([(dc.replace(cfg, num_layers=2), 2),
             (dc.replace(cfg, num_layers=4), 4)],
            cfg.num_layers)


def extrapolate(cfg: ModelConfig, shape: ShapeConfig, *,
                multi_pod: bool = False, **trace_kw) -> Dict[str, Any]:
    """The JAX dryrun's affine rule in the layer count, m(n) = a + b n,
    pinned by meta traces at the two reduced depths of
    :func:`_cost_scaled_cfgs` and read at the full depth: a self-check
    of the full-depth trace (layers of a group are identical, so every
    count is affine in their number).  Integer counts stay integers
    where the rule divides exactly."""
    (pairs, n_full) = _cost_scaled_cfgs(cfg)
    (cfg_a, n_a), (cfg_b, n_b) = pairs
    ra_, rb_ = (trace_cell(c, shape, multi_pod=multi_pod, device="meta",
                           **trace_kw) for c in (cfg_a, cfg_b))

    def ext(a, b):
        q, r = divmod((b - a) * (n_full - n_a), n_b - n_a)
        return a + q if r == 0 else a + (b - a) * (n_full - n_a) / (n_b - n_a)

    return {"flops": ext(ra_["traced"]["flops"], rb_["traced"]["flops"]),
            "bytes": ext(ra_["traced"]["bytes"], rb_["traced"]["bytes"]),
            "collectives": {k: ext(ra_["collectives"][k],
                                   rb_["collectives"][k])
                            for k in ra_["collectives"]},
            "extrapolated_from": [n_a, n_b, n_full]}


# --------------------------------------------------------------------- #
# run_cell and the sweep (one fresh process a cell)
# --------------------------------------------------------------------- #


def card_line() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = ARTIFACT_DIR,
             parallel_overrides: Optional[Dict[str, Any]] = None,
             tag: str = "", device: DeviceLike = None) -> Dict[str, Any]:
    """Trace one cell (:func:`trace_cell`, rank 0) and write its record
    to ``out_dir/<arch>__<shape>__<mesh><tag>.json``; on the card the
    record also names the card and its power limit."""
    rec = trace_cell(ARCHS[arch], SHAPES[shape_name], multi_pod=multi_pod,
                     parallel_overrides=parallel_overrides, device=device)
    if rec["device"] == "cuda":
        rec["card"] = {"name": torch.cuda.get_device_name(0),
                       "nvidia_smi": card_line()}
    os.makedirs(out_dir, exist_ok=True)
    name = f"{arch}__{shape_name}__{rec['mesh']}{tag}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def all_cells(multi_pod_too: bool = True):
    cells = []
    for arch, cfg in ARCHS.items():
        for shape in cells_for(cfg):
            cells.append((arch, shape.name, False))
            if multi_pod_too:
                cells.append((arch, shape.name, True))
    return cells


def _sweep(args) -> int:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_SRC] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs: Dict[Any, Tuple] = {}
    failures = []
    todo = list(all_cells())
    while todo or procs:
        while todo and len(procs) < args.jobs:
            arch, shape, mp = todo.pop(0)
            path = os.path.join(args.out,
                                f"{arch}__{shape}__{mesh_tag(mp)}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"skip {arch} {shape} {mesh_tag(mp)}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out", args.out]
            if args.device:
                cmd += ["--device", args.device]
            if mp:
                cmd.append("--multi-pod")
            procs[subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, env=env)] = \
                (arch, shape, mp)
        for p in list(procs):
            if p.poll() is not None:
                arch, shape, mp = procs.pop(p)
                out = p.stdout.read().decode()
                status = "OK" if p.returncode == 0 else "FAIL"
                print(f"[{status}] {arch} {shape} {mesh_tag(mp)}",
                      flush=True)
                if p.returncode != 0:
                    failures.append((arch, shape, mp, out[-2000:]))
        time.sleep(0.2)
    for arch, shape, mp, out in failures:
        print(f"--- FAILURE {arch} {shape} mp={mp} ---\n{out}\n")
    return 1 if failures else 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="meta (no memory, no time) or cuda (default)")
    args = ap.parse_args(argv)

    if args.all:
        return _sweep(args)
    rec = run_cell(args.arch, args.shape, args.multi_pod, args.out,
                   device=args.device)
    print(json.dumps({k: rec.get(k) for k in
                      ("arch", "shape", "mesh", "layout", "rank_mesh",
                       "device", "trace_s", "step_ms", "unsupported")},
                     indent=1))
    print(json.dumps(rec["memory"], indent=1))
    if "roofline" in rec:
        print(json.dumps(rec["roofline"], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
