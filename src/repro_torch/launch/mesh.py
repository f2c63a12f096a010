"""Device meshes over ``torch.distributed``: one process per shard.

The port's counterpart of the JAX package's ``launch/mesh.py``.  JAX
runs one controller over a mesh of devices; the port runs one process
per shard (SPMD): every rank runs the same host schedule and holds only
its slice of the parameters and arenas, and where the JAX package
writes ``psum`` over a mesh axis the port calls ``all_reduce`` over
that axis's subgroup.

* :class:`Mesh` is built over the initialised default process group.
  ``shape`` is a dict in JAX's axis order (``{"data": 2, "model": 2}``),
  ranks are laid out row-major over it as ``jax.make_mesh`` lays out
  devices, there is one subgroup per axis, and ``index(axis)`` is this
  rank's coordinate (JAX's ``axis_index``).  An axis may also be a
  tuple of axes in mesh order (``("pod", "data")``, the multi-pod
  mesh's batch axes), one subgroup over their product, the coordinate
  row-major over them as JAX splits a dim over several axes.  Its
  collectives
  (:meth:`Mesh.all_reduce`, :meth:`Mesh.all_to_all_single`,
  :meth:`Mesh.all_gather`, :meth:`Mesh.reduce_scatter`) run over that
  subgroup, count their bytes and calls by kind
  (:meth:`Mesh.collective_bytes`), on CPU tensors over
  gloo and on CUDA tensors over NCCL or gloo (gloo copies them through
  the host itself).  A collective over an axis of one rank runs but
  is not counted (XLA drops such collectives, so the counts stay the
  JAX package's).
* :func:`run_ranks` starts ``world`` ranks on this host, each in a
  fresh spawned process that joins the group through a ``FileStore`` in
  a new temporary directory (so concurrent rank groups never collide on
  a port), runs a module-level function and returns its result.  The
  whole run has a time limit: a rank that raises, dies or outlives it
  ends every rank, and the call raises.
* :func:`process_group` joins (or forms, at world 1) a group in the
  calling process, for a rank's body and for one-rank meshes.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

AXES = ("pod", "data", "model")
#: collective kinds, as the JAX package's roofline names HLO collectives
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# all_gather into one tensor (renamed all_gather_single in later torch)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


#: a mesh axis, or a tuple of them in mesh order
Axis = Union[str, Tuple[str, ...]]


def _names(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _key(axes: Tuple[str, ...]) -> Axis:
    return axes[0] if len(axes) == 1 else axes


class Mesh:
    """A mesh of the default group's ranks (see the module docstring).

    ``with mesh:`` is allowed (``sharding_env`` enters its mesh, as a
    JAX mesh is a context manager) and does nothing."""

    def __init__(self, shape: Dict[str, int]) -> None:
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialised default process "
                               "group (run_ranks or process_group)")
        names = tuple(shape)
        if any(a not in AXES for a in names):
            raise ValueError(f"mesh axes {names}: each must be one of {AXES}")
        sizes = tuple(int(shape[a]) for a in names)
        world, rank = dist.get_world_size(), dist.get_rank()
        if int(np.prod(sizes)) != world:
            raise ValueError(f"mesh {dict(shape)} needs {int(np.prod(sizes))} "
                             f"ranks, the process group has {world}")
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self.axis_names = names
        self.backend = dist.get_backend()
        self.rank = rank
        self._coords = dict(zip(names, (int(c) for c in
                                        np.unravel_index(rank, sizes))))
        grid = np.arange(world).reshape(sizes)
        # per-kind bytes and calls of this mesh's collectives (the
        # output tensor's bytes, as the JAX package's roofline counts an
        # HLO collective)
        self._bytes: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self._calls: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self._groups = {}
        # one subgroup per axis, and one over the axes before ``model``
        # together where there are two (the multi-pod batch axes)
        spans = [(a,) for a in names]
        lead = tuple(a for a in names if a != "model")
        if len(lead) > 1:
            spans.append(lead)
        for axes in spans:
            dims = [names.index(a) for a in axes]
            n = int(np.prod([sizes[d] for d in dims]))
            # new_group is collective: every rank makes every group, in
            # the same order, and keeps the one it belongs to; the axes
            # last, row-major, as JAX orders a dim split over them
            lines = np.moveaxis(grid, dims,
                                range(grid.ndim - len(dims), grid.ndim))
            for ranks in lines.reshape(-1, n):
                g = dist.new_group([int(r) for r in ranks])
                if rank in ranks:
                    self._groups[_key(axes)] = g

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def index(self, axis: Axis) -> int:
        """This rank's coordinate along ``axis`` (JAX's ``axis_index``),
        row-major over a tuple of axes."""
        idx = 0
        for a in _names(axis):
            idx = idx * self.shape[a] + self._coords[a]
        return idx

    def size(self, axis: Axis) -> int:
        return int(np.prod([self.shape[a] for a in _names(axis)]))

    def _group(self, axis: Axis):
        return self._groups[_key(_names(axis))]

    # -- collectives over one axis ------------------------------------- #

    def _count(self, kind: str, out: torch.Tensor, axis: Axis) -> None:
        if self.size(axis) == 1:
            return
        self._bytes[kind] += out.numel() * out.element_size()
        self._calls[kind] += 1

    def collective_bytes(self) -> Dict[str, Any]:
        """Bytes and calls of this mesh's collectives by kind since it
        was made or :meth:`reset_collectives`: ``{kind: bytes, ...,
        "_counts": {kind: calls}}``, the shape of the JAX package's
        ``roofline.analysis.parse_collective_bytes`` (whose HLO text the
        port has no counterpart of)."""
        return dict(self._bytes, _counts=dict(self._calls))

    def reset_collectives(self) -> None:
        for k in COLLECTIVES:
            self._bytes[k] = self._calls[k] = 0

    def all_reduce(self, x: torch.Tensor, axis: Axis,
                   op: str = "sum") -> torch.Tensor:
        """Reduce ``x`` in place over ``axis`` (``sum``, ``min`` or
        ``max``) and return it."""
        rop = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(x, rop, group=self._group(axis))
        self._count("all-reduce", x, axis)
        return x

    def all_to_all_single(self, x: torch.Tensor, axis: Axis) -> torch.Tensor:
        """Split dim 0 of ``x`` into ``size(axis)`` equal blocks; block
        ``j`` goes to coordinate ``j``, and block ``i`` of the result
        came from coordinate ``i``."""
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=self._group(axis))
        self._count("all-to-all", out, axis)
        return out

    def all_gather(self, x: torch.Tensor, axis: Axis,
                   dim: Optional[int] = None) -> torch.Tensor:
        """Every coordinate's ``x`` in coordinate order: stacked,
        ``(size(axis),) + x.shape``, or with ``dim`` concatenated along
        that dim (the full tensor whose blocks the coordinates hold, as
        :func:`~repro_torch.distributed.sharding.local_slice` cuts
        it)."""
        n = self.size(axis)
        out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
        _ALL_GATHER(out, x.reshape(-1).contiguous(),
                    group=self._group(axis))
        self._count("all-gather", out, axis)
        out = out.view((n,) + tuple(x.shape))
        if dim is None:
            return out
        shape = list(x.shape)
        shape[dim] *= n
        return out.movedim(0, dim).reshape(shape)

    def reduce_scatter(self, x: torch.Tensor, axis: Axis,
                       dim: int = 0) -> torch.Tensor:
        """The sum of every coordinate's ``x`` over ``axis``, this
        coordinate's block of it along ``dim`` (``x.shape[dim]`` must
        divide by ``size(axis)``)."""
        n = self.size(axis)
        full = x.movedim(dim, 0).contiguous()
        out = torch.empty((full.shape[0] // n,) + tuple(full.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _REDUCE_SCATTER(out, full, group=self._group(axis))
        self._count("reduce-scatter", out, axis)
        return out.movedim(0, dim).contiguous()

    def barrier(self) -> None:
        dist.barrier()


def make_local_mesh(data: int = 1, model: int = 1, *, pod: int = 0) -> Mesh:
    """A small mesh over the default group: ``{"data", "model"}``, or
    ``{"pod", "data", "model"}`` with ``pod``.  The group's world size
    must be the product of the axes."""
    if pod:
        return Mesh({"pod": pod, "data": data, "model": model})
    return Mesh({"data": data, "model": model})


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production shapes, (16, 16) or (2, 16, 16);
    raises unless the default group has that many ranks."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    return Mesh(shape)


# ------------------------------------------------------------------------ #
# Process groups and rank launch
# ------------------------------------------------------------------------ #


@contextlib.contextmanager
def process_group(backend: str, *, rank: int = 0, world: int = 1,
                  store_path: Optional[str] = None,
                  timeout: float = 300.0):
    """Join the default process group for the ``with`` block and leave
    it after.  Ranks meet through a ``FileStore`` at ``store_path`` (a
    new temporary file when None, enough at world 1).  Over NCCL a rank
    takes card ``rank % device_count``; a world larger than the card
    count is refused, since NCCL does not run two ranks on one card."""
    if backend == "nccl":
        _check_nccl(world)
        torch.cuda.set_device(rank % torch.cuda.device_count())
    tmp = None
    if store_path is None:
        tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
        store_path = os.path.join(tmp, "store")
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout))
    try:
        yield
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _check_nccl(world: int) -> None:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world > n:
        raise ValueError(
            f"nccl with {world} ranks needs {world} cards, this host has "
            f"{n} (NCCL runs one rank a card); use backend='gloo'")


def _rank_main(fn, rank, world, backend, store_path, args, out_q, timeout,
               threads) -> None:
    torch.set_num_threads(threads)
    try:
        with process_group(backend, rank=rank, world=world,
                           store_path=store_path, timeout=timeout):
            result = fn(rank, world, *args)
        # pickled here, by value: a tensor put on the queue as it is
        # would pass as a handle to this process's memory, which ends
        out_q.put((rank, True, pickle.dumps(result)))
    except Exception:                     # reported to run_ranks
        out_q.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable[..., Any], world: int, *, backend: str,
              args: Sequence[Any] = (), timeout: float = 120.0,
              threads: int = 1) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes
    that form one process group over ``backend`` (``gloo`` on the CPU;
    ``nccl``, one card a rank, or ``gloo`` on the card), and return the
    ranks' results in rank order.  ``fn`` must be importable by name
    (a module-level function) and its result picklable.  Each rank
    computes on ``threads`` CPU threads.  If any rank raises or exits,
    or the ranks are not all done within ``timeout`` seconds, every
    rank is ended and this raises, with the failing rank's traceback."""
    if backend == "nccl":
        _check_nccl(world)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    store_path = os.path.join(tmp, "store")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, store_path, tuple(args),
                               out_q, timeout, threads), daemon=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    results: Dict[int, Any] = {}
    failure: Optional[str] = None
    try:
        for p in procs:
            p.start()
        while len(results) < world and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = (f"ranks {sorted(set(range(world)) - set(results))}"
                           f" did not finish within {timeout} s")
                break
            try:
                rank, ok, payload = out_q.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    # a rank's last message may still be in the pipe
                    try:
                        rank, ok, payload = out_q.get(timeout=2.0)
                    except queue_mod.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no result")
                        break
                else:
                    continue
            if ok:
                results[rank] = pickle.loads(payload)
            else:
                failure = f"rank {rank} failed:\n{payload}"
        if failure is not None:
            # a rank's failure makes its peers' collectives fail too: keep
            # every report that arrives in a moment, the cause among them
            end = time.monotonic() + 2.0
            while time.monotonic() < end:
                try:
                    rank, ok, payload = out_q.get(timeout=0.2)
                except queue_mod.Empty:
                    continue
                if not ok:
                    failure += f"\nrank {rank} failed:\n{payload}"
    finally:
        for p in (p for p in procs if p.pid is not None):
            if failure is None:
                p.join(timeout=max(5.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out_q.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, "
                           f"world={world}, {backend}): {failure}")
    return [results[r] for r in range(world)]


__all__ = ["AXES", "COLLECTIVES", "Mesh", "make_local_mesh",
           "make_production_mesh", "process_group", "run_ranks"]
