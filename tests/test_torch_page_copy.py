"""The RowClone page copy (the JAX package's ``page_copy_batched``, rows
2 and 13 of the port's kernel table) against the JAX package.

On CPU tensors ``pim_page_copy_batched``, the pair entry
``pim_page_copy_batched_pair`` and ``pim_state_copy`` /
``pim_state_copy_pair`` run their plain versions; each is held bit for
bit against the JAX package's reference and its Pallas
``page_copy_batched`` in interpret mode, on the same numpy inputs: a
chain (an op reads the page another op writes: every copy reads the
arena as it was before the batch), a duplicate destination (the last op
wins), a disjoint batch, a (K, V) pair of one shape and a conv/SSD state
pair whose rows differ in size and dtype.

The wrapper's launch plan (which route, which descriptors, the staged
route's scratch offsets, the op list in the launch or uploaded) is held
against the reference through a host model of ``rc_copy_pages``'s
contract; the queue's accounting of a hybrid fork (a KV tail copy and a
state row copy in one flush) against the JAX cache's.  The port refuses
a hybrid cut with no attention layer.

The CUDA kernel has no CPU mode: the ``cuda``-marked tests hold it
against its plain version on the card, on both sides of the cluster
route's capacity and at 2 MiB rows, and skip here.  JAX is imported in
fixtures only.
"""

import ctypes
import struct
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts, reset_launches  # noqa: E402
from repro_torch.kernels.rowclone import ops as rc_ops  # noqa: E402
from repro_torch.kernels.rowclone import ref as rc_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ss_ops  # noqa: E402
from repro_torch.models.params import numpy_to_torch, torch_to_numpy  # noqa: E402


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import ml_dtypes
    from repro.kernels.rowclone import ref as jref, rowclone
    from repro.kernels.ssm_scan import ops as jss
    return types.SimpleNamespace(jnp=jnp, ref=jref, rc=rowclone, ss=jss,
                                 bf16=ml_dtypes.bfloat16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# (src, dst) op lists over 6 pages
OPS = {
    "chain": ([0, 1], [1, 2]),
    "duplicate": ([2, 3, 0], [1, 1, 4]),
    "disjoint": ([1, 2], [4, 5]),
}


def _data(shape, dt, seed):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return a.astype(dt)


def _bits(x):
    a = torch_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    return np.ascontiguousarray(a).view(np.uint8)


def _same(got, *wants):
    for w in wants:
        assert tuple(got.shape) == tuple(np.shape(w))
        np.testing.assert_array_equal(_bits(got), _bits(w))


def _jax_batched(jx, arena, src, dst):
    """The JAX reference's and the Pallas kernel's (interpret mode)
    ``page_copy_batched`` on an (L, P, ...) numpy arena."""
    s = jx.jnp.asarray(np.asarray(src, np.int32))
    d = jx.jnp.asarray(np.asarray(dst, np.int32))
    L, P = arena.shape[:2]
    a = jx.jnp.asarray(arena)
    pl = jx.rc.page_copy_batched(a.reshape(L, P, -1), s, d, block_cols=8,
                                 interpret=True)
    return jx.ref.page_copy_batched(a, s, d), pl.reshape(arena.shape)


def _jax_state(jx, arena, src, dst):
    """The JAX package's ``pim_state_copy``, reference and Pallas."""
    s = jx.jnp.asarray(np.asarray(src, np.int32))
    d = jx.jnp.asarray(np.asarray(dst, np.int32))
    return [jx.ss.pim_state_copy(jx.jnp.asarray(arena), s, d,
                                 use_pallas=pallas, interpret=True)
            for pallas in (False, True)]


@pytest.mark.parametrize("case", sorted(OPS))
def test_copy_matches_jax(jx, case):
    """One op list through every entry, each arena against the JAX
    reference and Pallas: ``pim_page_copy_batched`` on a (3, 6, 4, 2, 8)
    bf16 KV arena, ``pim_state_copy`` on a (1, 2, 6, 4, 10) f32 state
    arena, a (K, V) pair of one shape through
    ``pim_page_copy_batched_pair``, and the conv (bf16, rows of 3 x 12)
    and SSD (f32, rows of 2 x 4 x 8) state arenas through
    ``pim_state_copy_pair``."""
    src, dst = OPS[case]
    kv = _data((3, 6, 4, 2, 8), jx.bf16, seed=1)
    got = rc_ops.pim_page_copy_batched(numpy_to_torch(kv, "cpu"), src, dst)
    _same(got, *_jax_batched(jx, kv, src, dst))
    st = _data((1, 2, 6, 4, 10), np.float32, seed=2)
    got = ss_ops.pim_state_copy(numpy_to_torch(st, "cpu"), src,
                                np.asarray(dst, np.int32))
    _same(got, *_jax_state(jx, st, src, dst))

    k, v = (_data((2, 6, 4, 2, 8), jx.bf16, seed=s) for s in (3, 4))
    tk, tv = numpy_to_torch(k, "cpu"), numpy_to_torch(v, "cpu")
    rc_ops.pim_page_copy_batched_pair(tk, tv, src, dst)
    _same(tk, *_jax_batched(jx, k, src, dst))
    _same(tv, *_jax_batched(jx, v, src, dst))

    conv = _data((1, 2, 6, 3, 12), jx.bf16, seed=5)
    ssm = _data((1, 2, 6, 2, 4, 8), np.float32, seed=6)
    tc, ts = numpy_to_torch(conv, "cpu"), numpy_to_torch(ssm, "cpu")
    ss_ops.pim_state_copy_pair(tc, ts, torch.tensor(src), dst)
    _same(tc, *_jax_state(jx, conv, src, dst))
    _same(ts, *_jax_state(jx, ssm, src, dst))


def test_pair_refuses_what_the_kernel_does_not_take():
    """An empty batch changes nothing and launches nothing; pages out of
    either arena raise ``IndexError``; lists of two lengths and arenas
    on two devices raise ``ValueError``."""
    reset_launches()
    a0, a1 = torch.zeros((2, 4, 8)), torch.ones((2, 6, 3))
    rc_ops.pim_page_copy_batched_pair(a0, a1, [], [])
    assert torch.count_nonzero(a0) == 0 and bool((a1 == 1).all())
    with pytest.raises(IndexError):
        rc_ops.pim_page_copy_batched_pair(a0, a1, [0], [4])
    with pytest.raises(IndexError):
        rc_ops.pim_page_copy_batched(a0, [-1], [2])
    with pytest.raises(ValueError):
        rc_ops.pim_page_copy_batched_pair(a0, a1, [0, 1], [2])
    with pytest.raises(ValueError):
        rc_ops.pim_page_copy_batched_pair(a0, a1.to("meta"), [0], [1])
    assert set(launch_counts().values()) == {0}


def test_route_switches_at_the_cluster_capacity(monkeypatch):
    """The wrapper's route, picked on the host: direct without a hazard
    (an op reading another's destination; a row copied onto itself is
    none), else cluster while a layer's batch fits the cluster's chunks
    (16 blocks of 8 here), staged past that or on rows that are not
    16-byte aligned."""
    monkeypatch.setattr(rc_ops, "cluster_chunks", lambda: 128)
    hazard = rc_ops._reads_a_write
    assert hazard(*OPS["chain"]) and not hazard(*OPS["disjoint"])
    assert not hazard([1, 2], [1, 3]) and hazard([1, 2], [2, 3])
    route = rc_ops.copy_route
    kib = 1024
    # phase 2's overlapping case: 16 pages of 32 KiB, 32 chunks a layer
    assert route([32 * kib], 16, True) == "cluster"
    assert route([32 * kib, 32 * kib], 64, True) == "cluster"
    assert route([32 * kib], 65, True) == "staged"
    assert route([26112, 2 * kib * kib], 1, True) == "cluster"
    assert route([26112, 2 * kib * kib], 2, True) == "staged"
    assert route([9], 2, False) == "staged"


class _ContractModel:
    """``rc_copy_pages`` on host memory, as its contract in
    ``csrc/rowclone.cu`` states it: 6 descriptor values an arena, 2n ops
    (sources, then destinations) inline or at ``dev_idx``, the identity
    bits, and on the cluster route every source of a (layer, arena) read
    before any of its destinations is written."""

    def __init__(self, capacity):
        self.capacity = capacity
        self.calls = []

    def rc_copy_cluster_chunks(self):
        return self.capacity

    def rc_copy_pages(self, desc, arenas, dev_idx, host_idx, n, identity,
                      route, stream):
        vals = struct.unpack(f"{6 * arenas}q", desc)
        idx = (list((ctypes.c_int * (2 * n)).from_address(dev_idx))
               if dev_idx is not None
               else list(struct.unpack(f"{2 * n}i", host_idx)))
        self.calls.append((route, identity, dev_idx is not None))
        for z in range(arenas):
            s_base, d_base, s_rows, d_rows, row, layers = vals[6 * z:6 * z + 6]
            for l in range(layers):
                moves = [(s_base + (l * s_rows + (i if identity & 1
                                                  else idx[i])) * row,
                          d_base + (l * d_rows + (i if identity & 2
                                                  else idx[n + i])) * row)
                         for i in range(n)]
                rows = [ctypes.string_at(s, row) for s, _ in moves]
                for (s, d), b in zip(moves, rows):
                    ctypes.memmove(d, b if route == 1
                                   else ctypes.string_at(s, row), row)
        return 0


@pytest.mark.parametrize("case", ["direct", "staged", "long"])
def test_launch_plan_copies_as_the_reference(monkeypatch, case):
    """The wrapper's launches (descriptors, op lists, scratch offsets)
    through the contract model, on a pair of unequal rows: a disjoint
    batch (direct), a chain staged through scratch, and a chain of 300
    ops (past ``INLINE_PAIRS``: the list uploaded) down the cluster
    route.  The arenas equal the reference's, and ``LAUNCHES`` counts
    one launch (two on the staged route)."""
    model = _ContractModel(capacity=1 if case == "staged" else 1024)
    monkeypatch.setattr(rc_ops._build, "load", lambda name: model)
    monkeypatch.setattr(rc_ops, "cluster_chunks", model.rc_copy_cluster_chunks)
    monkeypatch.setattr(rc_ops, "_stream", lambda t: 0)
    P = 600 if case == "long" else 8
    src, dst = {"direct": ([1, 2, 5], [3, 4, 3]),
                "staged": ([0, 1, 6], [1, 2, 6]),
                "long": (list(range(300)), list(range(1, 301)))}[case]
    g = torch.Generator().manual_seed(7)
    arenas = (torch.randn((3, P, 4, 8), generator=g).to(torch.bfloat16),
              torch.randint(-100, 100, (3, P, 48), generator=g,
                            dtype=torch.int8))
    want = [a.clone() for a in arenas]
    for w in want:
        rc_ref.page_copy_batched(w, torch.tensor(src), torch.tensor(dst))
    s, d = rc_ops._copy_ops(src, dst, P)
    reset_launches()
    rc_ops._launch_copy(arenas, 2, s, d, "page_copy_batched")
    for a, w in zip(arenas, want):
        assert torch.equal(a, w)
    assert [c[0] for c in model.calls] == {"direct": [0], "staged": [0, 0],
                                           "long": [1]}[case]
    assert model.calls[0][2] == (case == "long")
    assert launch_counts()["page_copy_batched"] == len(model.calls)


def test_hybrid_fork_flush_counts_as_jax(jx):
    """A hybrid cache's fork (a CoW copy of the KV tail page and a state
    row copy, one flush): the queue's launch deltas equal the JAX
    cache's (``page_copy`` and ``state_copy`` two each, one per arena),
    and the child's tail page and state row are the parent's."""
    from repro.configs import ARCHS as JARCHS, reduced as jreduced
    from repro.serving.kv_cache import PagedKVCache as JCache
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.serving.kv_cache import PagedKVCache

    kw = dict(num_layers=4, attn_every=4)
    c = PagedKVCache(reduced(ARCHS["jamba-1.5-large-398b"], **kw),
                     num_pages=8, page_size=4, device="cpu")
    jc = JCache(jreduced(JARCHS["jamba-1.5-large-398b"], **kw),
                num_pages=8, page_size=4)
    g = torch.Generator().manual_seed(8)
    for t in (c.k_arena, c.v_arena, c.state.conv, c.state.ssm):
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    for cache in (c, jc):
        cache.create(0, 6)
    before, jbefore = c.queue.snapshot(), jc.queue.snapshot()
    c.fork(0, 1)
    jc.fork(0, 1)
    delta = c.queue.delta(before)
    assert delta == jc.queue.delta(jbefore)
    assert delta["page_copy"] == 2 and delta["state_copy"] == 2
    tail, new = c.seqs[0].pages[-1], c.seqs[1].pages[-1]
    assert tail != new
    for a in (c.k_arena, c.v_arena):
        assert torch.equal(a[:, new], a[:, tail])
    r0, r1 = c.state.rows[0], c.state.rows[1]
    for a in (c.state.conv, c.state.ssm):
        assert torch.equal(a[:, :, r1], a[:, :, r0])


@pytest.mark.parametrize("chunk", [None, 8])
def test_hybrid_cut_without_attention_is_refused(chunk):
    """A hybrid cut below one period (jamba at 2 layers, one attention
    layer in 8) holds no attention layer: the port's engine refuses it
    in its constructor, with or without chunked prefill."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.serving.engine import PagedEngine

    cfg = reduced(ARCHS["jamba-1.5-large-398b"], num_layers=2)
    with pytest.raises(ValueError, match="no attention layer"):
        PagedEngine(cfg, {}, device="cpu", max_prefill_chunk=chunk)


# ------------------------------------------------------------------ #
# The CUDA kernel against its plain version (the card only)
# ------------------------------------------------------------------ #


def _card_arena(shape, dtype, seed, cuda):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(shape, generator=g, device=cuda).to(dtype)


def _one_arena_case(case, cuda):
    src, dst = OPS.get(case, OPS["chain"])
    if case == "over_capacity":
        n = rc_ops.cluster_chunks() // 2 + 1       # 32 KiB rows: 2 chunks
        src, dst = list(range(n)), list(range(1, n + 1))
        return src, dst, _card_arena((3, n + 2, 16, 1024), torch.bfloat16,
                                     1, cuda)
    if case == "two_mib_rows":
        return src, dst, _card_arena((4, 6, 512 * 1024), torch.float32, 2,
                                     cuda)
    if case == "one_layer":
        return src, dst, _card_arena((6, 16 * 1024), torch.bfloat16, 3,
                                     cuda)
    return src, dst, _card_arena((40, 6, 16, 8, 128), torch.bfloat16, 4,
                                 cuda)


@pytest.mark.cuda
def test_cuda_page_copy_matches_plain(cuda):
    """One arena, bit for bit against the plain version: the cluster
    route (a chain over granite's 40 layers of 32 KiB pages, and one
    layer through ``pim_page_copy``), the direct route (disjoint, and
    the duplicate once resolved), the staged route (a layer's batch one
    page over the cluster's capacity, and a chain of 2 MiB rows);
    ``LAUNCHES`` counts the route's launches."""
    routes = {"chain": "cluster", "one_layer": "cluster",
              "disjoint": "direct", "duplicate": "direct",
              "over_capacity": "staged", "two_mib_rows": "staged"}
    for case, want_route in routes.items():
        src, dst, arena = _one_arena_case(case, cuda)
        want = arena.clone()
        lead = 1 if case == "one_layer" else 2
        name = "page_copy" if lead == 1 else "page_copy_batched"
        s, d = rc_ops._copy_ops(src, dst, arena.shape[lead - 1])
        route = "direct"
        if rc_ops._reads_a_write(s, d):
            route = rc_ops.copy_route([rc_ops._row_bytes(arena, lead)],
                                      len(s), True)
        assert route == want_route, case
        reset_launches()
        if lead == 1:
            rc_ops.pim_page_copy(arena, src, dst)
            rc_ref.page_copy(want, torch.tensor(src), torch.tensor(dst))
        else:
            rc_ops.pim_page_copy_batched(arena, src, dst)
            rc_ref.page_copy_batched(want, torch.tensor(src),
                                     torch.tensor(dst))
        torch.cuda.synchronize()
        assert launch_counts()[name] == (2 if route == "staged" else 1), case
        assert torch.equal(arena.view(torch.uint8),
                           want.view(torch.uint8)), case


@pytest.mark.cuda
def test_cuda_pair_copy_matches_plain(cuda):
    """The pair in one launch, bit for bit: granite's (K, V) page rows
    (32 KiB, 40 layers) and mamba2-1.3b's state rows (conv 3 x 4352 bf16,
    SSD 64 x 64 x 128 f32 = 2 MiB, 48 layers, 6 rows), chained (the
    cluster route for the KV pair, the staged route for the state pair,
    whose 2 MiB rows overflow a cluster) and disjoint."""
    for case in ("kv_chain", "kv_disjoint", "state_chain", "state_disjoint",
                 "state_one_row"):
        pair, ops_case = case.split("_", 1)
        src, dst = {"chain": OPS["chain"], "disjoint": OPS["disjoint"],
                    "one_row": ([0], [5])}[ops_case]
        if pair == "kv":
            a0 = _card_arena((40, 6, 16, 8, 128), torch.bfloat16, 5, cuda)
            a1 = _card_arena((40, 6, 16, 8, 128), torch.bfloat16, 6, cuda)
        else:
            a0 = _card_arena((48, 1, 6, 3, 4352), torch.bfloat16, 7, cuda)
            a1 = _card_arena((48, 1, 6, 64, 64, 128), torch.float32, 8, cuda)
        w0, w1 = a0.clone(), a1.clone()
        reset_launches()
        if pair == "kv":
            rc_ops.pim_page_copy_batched_pair(a0, a1, src, dst)
            rc_ref.page_copy_batched_pair(w0, w1, torch.tensor(src),
                                          torch.tensor(dst))
        else:
            ss_ops.pim_state_copy_pair(a0, a1, src, dst)
            for w in (w0, w1):
                rc_ref.page_copy_batched(w.view(48, 6, -1),
                                         torch.tensor(src), torch.tensor(dst))
        torch.cuda.synchronize()
        staged = case == "state_chain"
        assert launch_counts()["page_copy_batched"] == (2 if staged else 1)
        for a, w in ((a0, w0), (a1, w1)):
            assert torch.equal(a.view(torch.uint8), w.view(torch.uint8)), \
                case
