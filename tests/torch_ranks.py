"""Rank bodies for the port's multi-rank tests (no JAX import).

``launch.mesh.run_ranks`` spawns fresh processes that import their
function by name, so the bodies the ``test_torch_*`` files start live
here, importable without JAX.  Each runs the same schedule on every
rank and returns what the parent test compares: recorded logits,
arena slices, launch deltas and owner breakdowns.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.params import from_jax_params
from repro_torch.serving.engine import PagedEngine, Request

PAGE = 4
SNAP_AFTER = 3          # engine steps before the arenas are read


class Forced(PagedEngine):
    """The engine with every token taken from a reference's choices
    (call by call, row by row); records its own logits.  Without a
    reference it chooses freely (and still records)."""

    def __init__(self, *a, ref_tokens: Optional[List[np.ndarray]] = None,
                 **kw):
        super().__init__(*a, **kw)
        self.ref_tokens = ref_tokens
        self.logits: List[np.ndarray] = []
        self.tokens: List[np.ndarray] = []

    def _choose(self, logits, temps, seed, rowmap=None):
        self.logits.append(logits.float().cpu().numpy())
        if self.ref_tokens is None:
            tok = super()._choose(logits, temps, seed, rowmap=rowmap)
        else:
            tok = torch.from_numpy(
                np.asarray(self.ref_tokens[len(self.logits) - 1],
                           np.int64)).to(logits.device)
        self.tokens.append(tok.cpu().numpy())
        return tok


def prompts(vocab: int, lens=(12, 7, 9), seed: int = 7) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def prefix_prompts(vocab: int) -> List[np.ndarray]:
    """Three prompts sharing a 9-token (two-page) system prefix."""
    rng = np.random.default_rng(11)
    system = rng.integers(0, vocab, 9).astype(np.int32)
    return [np.concatenate([system, rng.integers(0, vocab, n)
                            .astype(np.int32)]) for n in (3, 6, 2)]


WORKLOADS = {
    # name: (prompts(vocab), engine keywords, new tokens, rounds a step)
    "main": (prompts, {}, 6, 1),
    "chunked": (lambda v: prompts(v, lens=(12, 7, 19)),
                dict(max_prefill_chunk=8, decode_block_rounds=4,
                     mixed_rounds=True), 9, 4),
    "prefix": (prefix_prompts, dict(prefix_cache=True), 5, 1),
}


def serve(cfg, params, workload: str, *, mesh=None, ref_tokens=None,
          snap: bool = True, **kw) -> Dict:
    """Serve one workload step by step, a step being ``run`` over the
    workload's rounds (the prefix workload's requests one at a time, so
    later ones hit the committed prefix); returns the
    streams, each choice's logits and tokens, each step's launch delta,
    the owner breakdown and, after ``SNAP_AFTER`` steps, the K/V arenas
    (their shard views under a mesh: a collective on every rank)."""
    make, eng_kw, new, rounds = WORKLOADS[workload]
    eng = Forced(cfg, params, page_size=PAGE, num_pages=64, device="cpu",
                 mesh=mesh, ref_tokens=ref_tokens, **eng_kw, **kw)
    if workload == "prefix":
        eng.cache.enable_zero_scan()
    waves = ([[p] for p in make(cfg.vocab_size)] if workload == "prefix"
             else [make(cfg.vocab_size)])
    q = eng.cache.queue
    results, deltas, arenas, rid, steps = {}, [], None, 0, 0
    for wave in waves:
        for p in wave:
            eng.submit(Request(rid, p, max_new_tokens=new, temperature=0.0))
            rid += 1
        while eng.has_work:
            before = q.snapshot()
            results.update(eng.run(max_rounds=rounds))
            deltas.append(q.delta(before))
            steps += 1
            if snap and steps == SNAP_AFTER:
                arenas = _arenas(eng)
    if workload == "prefix":
        eng.cache.clear_prefix()
    return {"results": results, "logits": eng.logits, "tokens": eng.tokens,
            "deltas": deltas, "owners": q.snapshot(by_owner=True),
            "arenas": arenas, "pages_in_use": eng.cache.pages_in_use,
            "stats": {k: eng.stats[k] for k in (
                "prefix_hits", "multi_round_blocks", "mixed_dispatches")}}


def _arenas(eng) -> List[torch.Tensor]:
    lib = eng.cache.lib
    if eng.mesh is None:
        return [lib.buffers[0].clone(), lib.buffers[1].clone()]
    # gathered from every rank, in head order along dim 3
    return [torch.cat(lib.shard_views(i), dim=3) for i in (0, 1)]


def dispatches(cfg, params, mesh) -> Dict:
    """The one-dispatch pins: a fused prefill batch, a decode round and
    a run of K-blocks."""
    out = {}
    eng = PagedEngine(cfg, params, page_size=PAGE, num_pages=64,
                      device="cpu", mesh=mesh)
    for i, p in enumerate(prompts(cfg.vocab_size, lens=(7, 7))):
        eng.submit(Request(i, p, max_new_tokens=8, temperature=0.0))
    before = eng.cache.queue.snapshot()
    eng._prefill_round()
    out["prefill"] = eng.cache.queue.delta(before)
    before = eng.cache.queue.snapshot()
    eng._decode_round()
    out["decode"] = eng.cache.queue.delta(before)
    blk = PagedEngine(cfg, params, page_size=PAGE, num_pages=128,
                      device="cpu", decode_block_rounds=8, mesh=mesh)
    for i, p in enumerate(prompts(cfg.vocab_size, lens=(7, 7), seed=3)):
        blk.submit(Request(i, p, max_new_tokens=64, temperature=0.0))
    blk.run(max_rounds=9)
    before = blk.cache.queue.snapshot()
    base = blk.stats["tokens_out"]
    blk.run(max_rounds=32)
    out["block"] = blk.cache.queue.delta(before)
    out["block_tokens"] = blk.stats["tokens_out"] - base
    return out


def sharded_serving(rank: int, world: int, cfg, np_params, refs: Dict,
                    bad_cfg=None) -> Dict:
    """Every check of ``tests/test_torch_sharded.py`` at one world size,
    on one rank: the three workloads teacher-forced by ``refs``, the
    main one again with compressed logits, the dispatch pins, and the
    refusal of a non-divisible head count."""
    mesh = make_local_mesh(model=world)
    params = from_jax_params(np_params, "cpu")
    out = {name: serve(cfg, params, name, mesh=mesh, ref_tokens=refs[name])
           for name in WORKLOADS}
    out["compressed"] = serve(cfg, params, "main", mesh=mesh,
                              ref_tokens=refs["main"], snap=False,
                              compressed_collectives=True)
    out["dispatch"] = dispatches(cfg, params, mesh)
    if bad_cfg is not None:
        try:
            PagedEngine(bad_cfg, params, page_size=PAGE, num_pages=16,
                        device="cpu", mesh=mesh)
        except ValueError as e:
            out["refusal"] = str(e)
    if rank:
        # one copy of the gathered arenas is enough
        for name in WORKLOADS:
            out[name]["arenas"] = None
    return out


def moe_ranks(rank: int, world: int, cfg, np_moe, x_np, capacities
              ) -> Dict:
    """``models.moe`` expert parallel at ``world`` ranks: ``_local_moe``
    on this rank's expert slice at each of ``capacities`` (float32
    sums, and bfloat16 at the first), and ``moe_layer`` under
    ``sharding_env`` from the full weights."""
    import dataclasses

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distributed.sharding import sharding_env
    from repro_torch.models import moe as M
    from repro_torch.models.layers import cast

    mesh = make_local_mesh(model=world)
    p = from_jax_params(np_moe, "cpu")
    x = from_jax_params(x_np, "cpu")
    m = cfg.moe
    e_local = m.num_experts // world

    def mine(w):
        return cast(w).narrow(0, rank * e_local, e_local)

    out = {}
    runs = [(("f32", c), c, torch.float32) for c in capacities]
    runs.append((("bf16", capacities[0]), capacities[0], torch.bfloat16))
    for name, capacity, dt in runs:
        y, aux = M._local_moe(
            x, p["router"].float(), mine(p["w_gate"]), mine(p["w_up"]),
            mine(p["w_down"]), top_k=m.top_k, num_experts=m.num_experts,
            capacity=capacity, activation=cfg.activation,
            model_axis="model", psum_dtype=dt, mesh=mesh)
        out[name] = (y.float(), float(aux))
    big = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=8.0))
    with sharding_env(mesh, fsdp=False):
        y, aux = M.moe_layer(big, ParallelConfig(moe_impl="shard_map"), p,
                             x)
    out["layer"] = (y.float(), float(aux))
    return out


def compression_ranks(rank: int, world: int, xs, grads) -> Dict:
    """``distributed.compression`` at ``world`` ranks: this rank's
    ``xs[rank]`` through ``psum_compressed`` and its gradient tree
    ``grads[rank]`` through ``compressed_grad_sync``."""
    from repro_torch.distributed.compression import (compressed_grad_sync,
                                                     psum_compressed)

    mesh = make_local_mesh(data=world)
    x = torch.from_numpy(xs[rank])
    tree = {k: torch.from_numpy(v) for k, v in grads[rank].items()}
    return {"psum": psum_compressed(x, mesh, "data"),
            "sync": compressed_grad_sync(tree, mesh, "data")}


def train_step_ranks(rank: int, world: int, cfg, np_params, batch) -> Dict:
    """One data-parallel ``make_train_step`` step on this rank's block
    of ``batch`` (float32 weights ``np_params``): its metrics and the
    updated parameters."""
    from repro_torch.configs.base import OptimizerConfig, ParallelConfig
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.train_step import make_train_step

    mesh = make_local_mesh(data=world)
    params = from_jax_params(np_params, "cpu")
    per = batch["tokens"].shape[0] // world
    mine = {k: torch.from_numpy(v[rank * per:(rank + 1) * per])
            for k, v in batch.items()}
    init_state, step = make_train_step(
        cfg, ParallelConfig(remat="none", attention_impl="naive",
                            moe_impl="dense"),
        OptimizerConfig(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10),
        mesh=mesh)
    state, metrics = step(init_state(params), mine)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": dict(tree_leaves(state["params"]))}


def sharded_eager(rank: int, world: int, cfg, np_params,
                  ref_tokens: List[np.ndarray]) -> Dict:
    """The main workload through the eager prefill oracle
    (``fused_prefill=False``) on a ``model`` mesh of ``world`` ranks,
    teacher-forced by ``ref_tokens``; rank 0 keeps the gathered
    arenas."""
    mesh = make_local_mesh(model=world)
    params = from_jax_params(np_params, "cpu")
    out = serve(cfg, params, "main", mesh=mesh, ref_tokens=ref_tokens,
                fused_prefill=False)
    if rank:
        out["arenas"] = None
    return out


def round_collectives(rank: int, world: int, cfg, np_params) -> Dict:
    """The mesh's collective counters over one decode round of the main
    workload (after its prefill), and the round's padded batch."""
    mesh = make_local_mesh(model=world)
    eng = PagedEngine(cfg, from_jax_params(np_params, "cpu"), page_size=PAGE,
                      num_pages=64, device="cpu", mesh=mesh)
    for i, p in enumerate(prompts(cfg.vocab_size)):
        eng.submit(Request(i, p, max_new_tokens=8, temperature=0.0))
    eng._prefill_round()
    mesh.reset_collectives()
    eng._decode_round()
    return {"bytes": mesh.collective_bytes(), "active": len(eng.active)}


def mesh_layout(rank: int, world: int) -> Dict:
    """This rank's coordinates and subgroup sums on a {data: 2, model: 2}
    mesh, and the production mesh's refusal at this world size."""
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_local_mesh(data=2, model=2)
    out = {"data": mesh.index("data"), "model": mesh.index("model")}
    for axis in ("data", "model"):
        x = torch.tensor([float(rank)])
        out[f"sum_{axis}"] = float(mesh.all_reduce(x, axis)[0])
    try:
        make_production_mesh()
    except ValueError as e:
        out["production"] = str(e)
    return out


def fail_or_hang(rank: int, world: int, how: str) -> None:
    """Rank 1 raises while rank 0 waits for it in a collective
    (``how="raise"``), or rank 1 never returns (``"hang"``)."""
    import time

    if how == "raise":
        if rank == 1:
            raise ValueError("rank 1 fails on purpose")
        torch.distributed.barrier()
    elif rank == 1:
        time.sleep(600)


def zero_steps(rank: int, world: int, cfg, np_params, batches, opt_kw,
               ckpt_dir: Optional[str] = None, resume: bool = False,
               save_after: Optional[int] = None, snap_after: int = 1,
               f32: bool = True) -> Dict:
    """``make_train_step`` steps under ``sharding_env(mesh, fsdp=True)``
    (the ZeRO-3 layout) on this rank's block of each of ``batches``, in
    float32 (``layers.COMPUTE_DTYPE``; bf16 with ``f32=False``, where
    the dense layers' leaves gather in bf16), beside the replicated
    data-parallel step on the same blocks from the same weights.
    Returns the ZeRO step's metrics by step, its state's slices at the
    end and after ``snap_after`` steps, the replicated state after
    ``snap_after`` steps cut to the same slices and its metrics, and
    each state leaf's split dim.  ``ckpt_dir``: with ``save_after`` every rank joins a
    save of the ZeRO state after that many steps (rank 0 writes the
    one-device layout); with ``resume`` the ZeRO state is first loaded
    from the latest checkpoint there and only the batches after it
    run."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import OptimizerConfig, ParallelConfig
    from repro_torch.distributed.sharding import sharding_env
    from repro_torch.models import layers
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.training.train_step import make_train_step, state_shards

    if f32:
        layers.COMPUTE_DTYPE = torch.float32
    mesh = make_local_mesh(data=world)
    params = from_jax_params(np_params, "cpu")
    pcfg = ParallelConfig(remat="full", attention_impl="naive",
                          moe_impl="dense")
    ocfg = OptimizerConfig(**opt_kw)
    with sharding_env(mesh, fsdp=True):
        zinit, zstep = make_train_step(cfg, pcfg, ocfg, mesh=mesh)
    rinit, rstep = make_train_step(cfg, pcfg, ocfg, mesh=mesh)
    zstate = zinit(tree_map(torch.clone, params))
    rstate = rinit(tree_map(torch.clone, params))
    shards = state_shards(zstate, zstep.layout)
    start = 0
    if resume:
        zstate, start = Checkpointer(ckpt_dir).load(zstate, shards=shards)
    per = batches[0]["tokens"].shape[0] // world
    out = {"metrics": [], "start": start, "dims": shards.dims}
    for i, batch in enumerate(batches[start:], start):
        mine = {k: torch.from_numpy(v[rank * per:(rank + 1) * per])
                for k, v in batch.items()}
        zstate, m = zstep(zstate, mine)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i < snap_after and not resume:
            rstate, rm = rstep(rstate, mine)
            out.setdefault("replicated_metrics", []).append(
                {k: float(v) for k, v in rm.items()})
        if i + 1 == snap_after:
            out["snap"] = {p: t.clone() for p, t in tree_leaves(zstate)}
            out["replicated"] = {p: shards.part(p, t)
                                 for p, t in tree_leaves(rstate)}
        if save_after == i + 1:
            ckpt = Checkpointer(ckpt_dir)
            ckpt.save(i + 1, zstate, shards=shards)
            ckpt.wait()
            mesh.barrier()
    out["state"] = dict(tree_leaves(zstate))
    return out


def zero_steps_each(rank: int, world: int, cfg, np_params, batches,
                    opts: Dict[str, Dict]) -> Dict:
    """:func:`zero_steps` for each optimizer of ``opts`` (name ->
    ``OptimizerConfig`` keywords), in one rank group."""
    return {name: zero_steps(rank, world, cfg, np_params, batches, kw)
            for name, kw in opts.items()}


def collectives(rank: int, world: int) -> Dict:
    """``Mesh.all_gather`` along a dim and ``Mesh.reduce_scatter`` on
    rank-dependent tensors, and the mesh's byte counters after them."""
    mesh = make_local_mesh(data=world)
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) + 100 * rank
    out = {"gather1": mesh.all_gather(x, "data", 1),
           "gather0": mesh.all_gather(x, "data", 0)}
    full = torch.arange(8 * world * 3, dtype=torch.float32).reshape(
        3, 8 * world) * (rank + 1)
    out["scatter"] = mesh.reduce_scatter(full, "data", 1)
    out["bytes"] = mesh.collective_bytes()
    return out


def rule_forward(rank: int, world: int, cases: Dict) -> Dict:
    """Each case's ``forward`` in the rule set's serving layout on this
    rank's blocks (``transformer.rule_layout``): a prefill, then a
    decode step per entry of ``case["decode"]``, computing and caching
    in float32.  Returns per case the rank's mesh coordinates, its batch
    block's logits and its cache blocks by path."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.params import rule_params, tree_leaves
    L.COMPUTE_DTYPE = torch.float32
    T.CACHE_DTYPE = torch.float32
    meshes: Dict = {}
    out = {}
    for name, c in cases.items():
        key = tuple(c["mesh"].items())
        if key not in meshes:
            meshes[key] = Mesh(c["mesh"])
        mesh = meshes[key]
        cfg, B, n = c["cfg"], c["batch"], c["prompt_len"]
        rules = T.rule_layout(cfg, mesh, global_batch=B,
                              max_len=c["max_len"], enc_len=c["enc_len"])
        params = rule_params(from_jax_params(c["params"], "cpu"),
                             T.model_defs(cfg), mesh)
        cache = rules.cut_cache(T.init_cache(cfg, B, c["max_len"],
                                             c["enc_len"], device="cpu"))

        def rows(**kw):
            return rules.cut_batch({k: torch.as_tensor(v)
                                    for k, v in kw.items()})

        def lens(m):
            return np.full((B,), m, np.int32)

        b = rows(**c["prefill"], lengths=lens(n))
        lg, cache, _ = T.forward(cfg, c["pcfg"], params,
                                 {k: v for k, v in b.items()
                                  if k != "lengths"}, mode="prefill",
                                 cache=cache, lengths=b["lengths"],
                                 rules=rules)
        got = {"coords": {a: mesh.index(a) for a in c["mesh"]},
               "prefill": lg.numpy(), "decode": []}
        for t, tok in enumerate(c["decode"]):
            b = rows(tokens=tok, lengths=lens(n + t + 1))
            lg, cache = T.forward(cfg, c["pcfg"], params,
                                  {"tokens": b["tokens"]}, mode="decode",
                                  cache=cache, write_pos=n + t,
                                  lengths=b["lengths"], rules=rules)
            got["decode"].append(lg.numpy())
        got["cache"] = {p: [t.numpy() for t in pair]
                        for p, pair in tree_leaves(cache)}
        out[name] = got
    return out


def rule_train(rank: int, world: int, cases: Dict) -> Dict:
    """Each case's ``make_train_step`` steps in the rule set's 2-D
    layout (``rules=transformer.rule_layout(cfg, mesh)``) on this rank's
    blocks of the whole parameters (``rule_params``, in the case's
    ``param_dtype``) and of each global
    batch of ``case["batches"]``, computing in float32.  Returns per case
    the rank's mesh coordinates, the metrics by step, and every state
    leaf's block and spec at the end.  With ``case["ckpt_dir"]`` every
    rank then joins a checkpoint's save there and loads it back into a
    fresh state (``reloaded``: equal to the saved one bit for bit)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.params import rule_params, tree_leaves
    from repro_torch.training.train_step import make_train_step, state_shards
    L.COMPUTE_DTYPE = torch.float32
    meshes: Dict = {}
    out = {}
    for name, c in cases.items():
        key = tuple(c["mesh"].items())
        if key not in meshes:
            meshes[key] = Mesh(c["mesh"])
        mesh = meshes[key]
        cfg = c["cfg"]
        rules = T.rule_layout(cfg, mesh)
        params = rule_params(from_jax_params(c["params"], "cpu"),
                             T.model_defs(cfg), mesh,
                             dtype=getattr(torch, c["pcfg"].param_dtype))
        init, step = make_train_step(cfg, c["pcfg"],
                                     OptimizerConfig(**c["opt"]), rules=rules)
        state = init(params)
        metrics = []
        for batch in c["batches"]:
            mine = rules.cut_batch({k: torch.as_tensor(v)
                                    for k, v in batch.items()})
            state, m = step(state, mine)
            metrics.append({k: float(v) for k, v in m.items()})
        shards = state_shards(state, step.layout)
        out[name] = {"coords": {a: mesh.index(a) for a in c["mesh"]},
                     "metrics": metrics, "specs": shards.specs,
                     "state": {p: t.numpy()
                               for p, t in tree_leaves(state)}}
        if c.get("ckpt_dir"):
            # every rank joins the save (rank 0 writes the whole leaves),
            # then loads its blocks back into a fresh state
            ckpt = Checkpointer(c["ckpt_dir"])
            ckpt.save(1, state, shards=shards)
            ckpt.wait()
            mesh.barrier()
            fresh = init(rule_params(from_jax_params(c["params"], "cpu"),
                                     T.model_defs(cfg), mesh))
            loaded, _ = ckpt.load(fresh, shards=shards)
            out[name]["reloaded"] = all(
                torch.equal(a, b) for (_, a), (_, b) in
                zip(tree_leaves(loaded), tree_leaves(state)))
    return out
