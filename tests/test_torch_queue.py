"""The port's op queue, pimolib face and paged KV cache against the JAX
package's, exactly: the same scripted ops must give the same launch
accounting, the same allocator decisions and bit-identical arenas."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.core.allocator import Allocation as JAllocation  # noqa: E402
from repro.core.pimolib import Blocking as JBlocking, TpuLib  # noqa: E402
from repro.serving.kv_cache import PagedKVCache as JCache  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core.allocator import Allocation  # noqa: E402
from repro_torch.core.op_registry import last_writer  # noqa: E402
from repro_torch.core.pimolib import (Blocking, TorchLib,  # noqa: E402
                                      make_torch_arena)
from repro_torch.models.params import numpy_to_torch, torch_to_numpy  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache  # noqa: E402

L, P, S, KVH, D = 2, 12, 4, 2, 8


def _bits(x):
    if isinstance(x, torch.Tensor):
        return torch_to_numpy(x)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _nonzero(d):
    return {k: v for k, v in d.items() if v}


def _assert_same_queue(q, jq):
    assert q.stats == {k: jq.stats[k] for k in q.stats}
    assert _nonzero(q.launches_by_kind) == _nonzero(jq.launches_by_kind)
    assert q.saved_by_kind == jq.saved_by_kind


class _Pair:
    """One scripted op applied to the port's lib and the JAX lib."""

    def __init__(self, rng):
        arenas = [rng.normal(size=(L, P, S, KVH, D)).astype(ml_dtypes.bfloat16)
                  for _ in range(2)]
        self.lib = TorchLib(buffers=[numpy_to_torch(a, "cpu")
                                     for a in arenas], deferred=True)
        self.jlib = TpuLib(buffers=[jnp.asarray(a) for a in arenas],
                           deferred=True)

    def __call__(self, op, *rows_list, fin=False, **kw):
        getattr(self.lib, op)(*(Allocation(tuple(r), 0)
                                for r in rows_list),
                              blocking=Blocking.FIN if fin else Blocking.ACK,
                              **kw)
        getattr(self.jlib, op)(*(JAllocation(tuple(r), 0)
                                 for r in rows_list),
                               blocking=JBlocking.FIN if fin else
                               JBlocking.ACK, **kw)

    def kv(self, pages, slots, k, v):
        for lib, cvt in ((self.lib, lambda a: numpy_to_torch(a, "cpu")),
                         (self.jlib, jnp.asarray)):
            lib.queue.enqueue_kv_writes(pages, slots, cvt(k), cvt(v))

    def check(self):
        _assert_same_queue(self.lib.queue, self.jlib.queue)
        for a, b in zip(self.lib.buffers, self.jlib.buffers):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_scripted_ops_match_jax_queue():
    rng = np.random.default_rng(0)
    pair = _Pair(rng)
    pair("copy", [1, 2], [5, 6])
    pair("copy", [1], [7])              # fan-out from page 1: coalesces
    pair("init", [3])                   # kind change: hazard flush
    pair("init", [4], value=1.0)        # second fill value: second launch
    pair("copy", [3], [2])              # reads a pending init: hazard flush
    pair.check()
    pair("flush")
    pair.check()
    k = rng.normal(size=(L, 3, KVH, D)).astype(ml_dtypes.bfloat16)
    v = rng.normal(size=(L, 3, KVH, D)).astype(ml_dtypes.bfloat16)
    pair.kv([8, 9, 8], [0, 1, 0], k, v)          # a duplicate slot ...
    pair.kv([8], [0], k[:, 1:2], v[:, 1:2])      # ... and a later writer
    pair("flush")
    pair.check()
    # the last enqueued write to (8, 0) won
    np.testing.assert_array_equal(_bits(pair.lib.buffers[0][:, 8, 0]),
                                  _bits(k[:, 1]))
    vals = rng.normal(size=(L, 1, S, KVH, D)).astype(np.float32)
    pair.lib.write(Allocation((10,), 0), torch.from_numpy(vals))
    pair.jlib.write(JAllocation((10,), 0), jnp.asarray(vals))
    pair("copy", [10], [11])
    pair("copy", [10], [0], fin=True)   # a FIN call flushes the backlog
    pair.check()
    np.testing.assert_array_equal(
        _bits(pair.lib.read(Allocation((11, 0), 0))),
        _bits(pair.jlib.read(JAllocation((11, 0), 0))))


def test_last_writer_keeps_enqueue_order():
    assert last_writer([1, 2, 1, 3, 2], [0, 0, 0, 1, 0]).tolist() == [2, 3, 4]


def test_unlayered_arena_lib():
    arena = make_torch_arena(2, 4, 16, dtype=torch.float32, device="cpu")
    lib = TorchLib(arena)
    src = arena.allocator.alloc(2)
    dst = arena.allocator.alloc(2, same_group_as=src)
    lib.write(src, torch.ones(2, 16))
    r = lib.copy(src, dst)
    assert r.launches == 1 and not r.deferred
    assert torch.equal(lib.read(dst), torch.ones(2, 16))
    lib.init(dst, 0.0)
    assert torch.count_nonzero(arena.buffer[list(dst.rows)]) == 0


def _caches():
    jcfg = jreduced(JARCHS["granite-3-8b"], num_layers=2, num_kv_heads=2)
    cfg = reduced(ARCHS["granite-3-8b"], num_layers=2, num_kv_heads=2)
    return (PagedKVCache(cfg, num_pages=32, page_size=4, device="cpu"),
            JCache(jcfg, num_pages=32, page_size=4))


def _kv(rng, cfg, n):
    shape = (cfg.num_layers, n, cfg.num_kv_heads, cfg.resolved_head_dim)
    return [rng.normal(size=shape).astype(ml_dtypes.bfloat16)
            for _ in range(2)]


def _assert_same_cache(c, jc, ids):
    assert c.pages_in_use == jc.pages_in_use
    assert sorted(c.seqs) == sorted(jc.seqs)
    for sid in c.seqs:
        assert vars(c.seqs[sid]) == vars(jc.seqs[sid])
    if ids:
        bt, lens = c.block_table(ids)
        jbt, jlens = jc.block_table(ids)
        np.testing.assert_array_equal(bt.numpy(), np.asarray(jbt))
        np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(_bits(c.k_arena), _bits(jc.k_arena))
    np.testing.assert_array_equal(_bits(c.v_arena), _bits(jc.v_arena))
    _assert_same_queue(c.queue, jc.queue)
    assert c.stats == {k: jc.stats[k] for k in c.stats}


def test_cache_ledger_matches_jax():
    rng = np.random.default_rng(1)
    c, jc = _caches()
    cfg = c.cfg

    def both(fn, *args, **kw):
        getattr(c, fn)(*args, **kw)
        getattr(jc, fn)(*args, **kw)

    def write_prompt(sid, start=0):
        # the prompt's KV through the queue's kv_write kind, against the
        # cache's own scatter plan
        k, v = _kv(rng, cfg, c.seqs[sid].length - start)
        for cache, cvt in ((c, lambda a: numpy_to_torch(a, "cpu")),
                           (jc, jnp.asarray)):
            pages, slots = cache.prefill_scatter_plan(cache.seqs[sid],
                                                      start=start)
            cache.queue.admit("kv_write", pages, cache.lib.flush)
            cache.queue.enqueue_kv_writes(pages, slots, cvt(k), cvt(v))
            cache.flush_pending()

    both("create", 0, 10)
    write_prompt(0)
    both("create", 1, 9, share_with=0, shared_len=8)
    write_prompt(1, start=8)
    _assert_same_cache(c, jc, [0, 1])
    both("fork", 0, 2)                       # CoW copy of the tail page
    _assert_same_cache(c, jc, [0, 1, 2])
    for sid in (0, 1, 2):
        c.ensure_writable_tail(c.seqs[sid])
        jc.ensure_writable_tail(jc.seqs[sid])
    c.flush_pending()
    jc.flush_pending()
    k, v = _kv(rng, cfg, 3)
    c.write_token_kv_batch([0, 1, 2], numpy_to_torch(k, "cpu"),
                           numpy_to_torch(v, "cpu"))
    jc.write_token_kv_batch([0, 1, 2], jnp.asarray(k), jnp.asarray(v))
    _assert_same_cache(c, jc, [0, 1, 2])
    c.reserve_tokens(c.seqs[1], 6)           # crosses two page boundaries
    jc.reserve_tokens(jc.seqs[1], 6)
    both("fork", 1, 3)
    c.reserve_tokens(c.seqs[3], 1)
    jc.reserve_tokens(jc.seqs[3], 1)
    _assert_same_cache(c, jc, [0, 1, 2, 3])
    for sid in (1, 0, 3, 2):
        both("free", sid)
        _assert_same_cache(c, jc, sorted(c.seqs))
    assert c.pages_in_use == 0
    assert torch.count_nonzero(c.k_arena) == 0    # init-on-free


def test_block_reservation_and_fused_commits_match_jax():
    """The K-block's bookkeeping: a multi-page reservation with a CoW of
    a shared partial tail, block tables over the reserved pages with a
    committed-length override (the chunked prefix table), and the fused
    block / round / prefill commits with and without their launch."""
    c, jc = _caches()

    def both(fn, *args, **kw):
        getattr(c, fn)(*args, **kw)
        getattr(jc, fn)(*args, **kw)

    both("create", 0, 6)
    both("create", 1, 13)
    both("fork", 0, 2)                  # 2 shares 0's full page
    for cache in (c, jc):
        cache.reserve_tokens(cache.seqs[1], 9)
        cache.reserve_tokens(cache.seqs[2], 8)
        cache.flush_pending()
    _assert_same_cache(c, jc, [0, 1, 2])
    bt, lens = c.block_table([1, 2, 1], lengths=[4, 0, 12])
    jbt, jlens = jc.block_table([1, 2, 1], lengths=[4, 0, 12])
    np.testing.assert_array_equal(bt.numpy(), np.asarray(jbt))
    np.testing.assert_array_equal(lens.numpy(), [4, 0, 12])
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    c.commit_fused_block([1, 2], [9, 3])
    jc.commit_fused_block([1, 2], [9, 3], jc.k_arena, jc.v_arena, rounds=9)
    c.commit_fused_round([0], kind=None)
    jc.commit_fused_round([0], jc.k_arena, jc.v_arena, kind=None)
    c.commit_fused_prefill(kind=None)
    jc.commit_fused_prefill(jc.k_arena, jc.v_arena, [], [], kind=None)
    c.commit_fused_prefill()
    jc.commit_fused_prefill(jc.k_arena, jc.v_arena, [], [])
    _assert_same_cache(c, jc, [0, 1, 2])
    assert _nonzero(c.queue.launches_by_kind)["fused_decode_block"] == 1
    for sid in (1, 0, 2):
        both("free", sid)
    _assert_same_cache(c, jc, [])
    assert c.pages_in_use == 0


def test_cache_refuses_what_is_not_ported():
    """A mesh whose ``model`` axis does not divide ``num_kv_heads`` is
    refused with the JAX cache's ``ValueError`` (meshes are served:
    ``tests/test_torch_sharded.py``); MLA still raises; ``state_slots``
    and trace recording are served (a dense cache has no state arena),
    and so is the VLM family, laid out as dense."""
    cfg = reduced(ARCHS["granite-3-8b"], num_layers=2)

    class TwoWay:
        shape = {"data": 1, "model": 2}

    with pytest.raises(ValueError,
                       match="num_kv_heads=3 not divisible by mesh model "
                             "axis 2"):
        PagedKVCache(dataclasses.replace(cfg, num_kv_heads=3), device="cpu",
                     mesh=TwoWay())
    assert PagedKVCache(cfg, device="cpu", record_trace=True).trace.events \
        == []
    with pytest.raises(NotImplementedError):
        PagedKVCache(reduced(ARCHS["deepseek-v2-236b"]), device="cpu")
    vlm = reduced(ARCHS["llava-next-34b"])
    assert PagedKVCache(vlm, device="cpu").n_layers == vlm.num_layers
    assert PagedKVCache(cfg, device="cpu", state_slots=4).state is None
