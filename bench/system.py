"""The system under test: ``repro_torch``'s paged engine and its async
front door, built from a configuration file and the benchmark's
weights.  With the families' program mappings (``program_config`` and
``program_params`` in ``bench/families/<model_type>.py``, which import
it inside those functions), the only module of the benchmark that
imports the program.

It uses the program's public surface: ``ModelConfig``/``SSMConfig``,
``transformer.model_defs`` (to check the weights' layout),
``PagedEngine`` (``submit``, ``run``, ``has_work``,
``prefill_backlog_tokens``, ``stats``, ``cache``; ``mesh=`` in rank
mode), ``Request``, ``AsyncServer``/``TokenStream``,
``kernels.LAUNCHES`` and ``launch.mesh`` (``Mesh``, ``run_ranks``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from bench.model import SOLO, Model, Ranks, family


def program_config(m: Model):
    """The program's ``ModelConfig`` for ``m`` (the family's mapping)."""
    return family(m.family).program_config(m)


def program_params(m: Model, w: Dict[str, torch.Tensor], cfg,
                   ranks: Ranks = SOLO, mesh=None) -> Dict:
    """The program's parameter tree over the benchmark's weights (the
    family's mapping, views: the two sides read the same memory),
    checked leaf by leaf against the shapes the program defines: each
    leaf whole, or, over ``mesh``, this rank's block of it as the
    program's tensor-parallel layout cuts it."""
    from repro_torch.distributed.sharding import local_shape
    from repro_torch.models import transformer as T
    from repro_torch.models.params import param_specs_for_mesh, tree_leaves

    params = family(m.family).program_params(m, w, ranks)
    defs = T.model_defs(cfg)
    want = {p: {tuple(d_.shape)} for p, d_ in tree_leaves(defs)}
    if mesh is not None:
        for p, spec in tree_leaves(param_specs_for_mesh(defs, mesh)):
            want[p].add(local_shape(next(iter(want[p])), spec, mesh))
    have = {p: tuple(t.shape) for p, t in tree_leaves(params)}
    bad = sorted((p, have.get(p), sorted(want.get(p, ())))
                 for p in set(want) | set(have)
                 if have.get(p) not in want.get(p, ()))
    if bad:
        raise ValueError(f"weights do not fit the program's layout "
                         f"(leaf, shape, shapes it may have): {bad}")
    return params


def engine(m: Model, w: Dict[str, torch.Tensor], seed: int, device,
           mesh=None, ranks: Ranks = SOLO, **override):
    """A ``PagedEngine`` for ``m`` with the configuration file's engine
    settings (``override`` replaces some, for the CPU tests), over
    ``mesh`` in rank mode (the engine cuts whole weights to this rank's
    share, and keeps a share as it is)."""
    from repro_torch.serving.engine import PagedEngine

    cfg = program_config(m)
    kw = dict(m.engine, **override)
    zero_scan = kw.pop("zero_scan", False)
    eng = PagedEngine(cfg, program_params(m, w, cfg, ranks, mesh),
                      seed=seed, device=device, mesh=mesh, **kw)
    if zero_scan:
        eng.cache.enable_zero_scan()
    return eng


def request(rid: int, prompt, max_new: int, temperature: float):
    from repro_torch.serving.engine import Request

    return Request(rid, prompt, max_new_tokens=max_new,
                   temperature=temperature)


def server(m: Model, eng):
    """The async front door with no deadline (nothing is shed) and the
    configuration file's ``front_door`` settings."""
    from repro_torch.serving.server import AsyncServer

    return AsyncServer(eng, ttft_slo_ms=None, **m.raw.get("front_door", {}))


def mesh(world: int):
    """A mesh of one ``model`` axis over the ``world`` ranks of the
    default process group."""
    from repro_torch.launch.mesh import Mesh

    return Mesh({"model": world})


def run_ranks(fn, world: int, *, backend: str, args, timeout: float,
              threads: int) -> List:
    """``fn(rank, world, *args)`` in ``world`` spawned processes that
    form one process group over ``backend``; their results in rank
    order (the program's ``launch.mesh.run_ranks``)."""
    from repro_torch.launch.mesh import run_ranks as spawn

    return spawn(fn, world, backend=backend, args=args, timeout=timeout,
                 threads=threads)


def launches() -> Dict[str, int]:
    from repro_torch.kernels import LAUNCHES

    return dict(LAUNCHES)


def arena_residue(eng) -> int:
    """Nonzero elements in the arena pages and state rows that nothing
    holds: a page or row is zeroed when it is freed (RowClone-Init, or
    skipped where the Ambit zero scan found it zero already), so a free
    one holds only zeros.  Live sequences and the prefix cache keep
    theirs."""
    cache = eng.cache
    cache.flush_pending()
    n_pages = cache.k_arena.shape[1]
    free = sorted(set(range(n_pages)) - set(cache.refcount))
    n = 0
    if free:
        idx = torch.as_tensor(free, device=cache.k_arena.device)
        # a layer at a time: a whole arena's comparison would not fit
        for a in (cache.k_arena, cache.v_arena):
            n += sum(int(torch.count_nonzero(a[i].index_select(0, idx)))
                     for i in range(a.shape[0]))
    st = cache.state
    if st is not None:
        rows = sorted(set(range(st.num_slots)) - set(st.rows.values()))
        if rows:
            idx = torch.as_tensor(rows, device=st.ssm.device)
            for a in (st.conv, st.ssm):
                n += sum(int(torch.count_nonzero(a[g, j].index_select(0, idx)))
                         for g in range(a.shape[0])
                         for j in range(a.shape[1]))
    return n
