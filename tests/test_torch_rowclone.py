"""The port's public RowClone API against the JAX package's, bit for bit.

``pim_copy``, ``pim_init``, ``pim_page_copy`` and ``pim_page_init`` on
CPU tensors run their plain versions; each is held against the JAX
package's reference and its Pallas kernel in interpret mode on the same
numpy inputs (``copy_2d``, ``init_2d``, ``page_copy``, ``page_init``):
float32, bfloat16, int32 and int8; odd widths; ranks 1 to 3; a bf16 fill
of 0.1 (0.100098 after rounding) and an int32 fill of 1.5 (1); a chain
whose destination is another op's source and a duplicate destination
(the last op wins).  An empty page batch is held against the reference
only: the JAX package's unbatched Pallas ``page_copy`` fails on one.

Also held against the JAX cache: the queue's single-token form
(``enqueue_kv_write``, ``has_kind``) and ``PagedKVCache.append_token_kv``
through a copy-on-write tail, with the same arenas, launch deltas and
refcounts.

The CUDA kernels have no CPU mode: one test per kernel holds it against
its plain version on the card and skips here.  JAX is imported in
fixtures only, so those also run where JAX is not installed.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts, reset_launches  # noqa: E402
from repro_torch.kernels.rowclone import ops as rc_ops  # noqa: E402
from repro_torch.kernels.rowclone import ref as rc_ref  # noqa: E402
from repro_torch.models.params import numpy_to_torch, torch_to_numpy  # noqa: E402

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "int32": torch.int32, "int8": torch.int8}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import ml_dtypes
    from repro.kernels.rowclone import ops as jops, ref as jref, rowclone
    return types.SimpleNamespace(
        jnp=jnp, ops=jops, ref=jref, rc=rowclone,
        np_dtypes={"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
                   "int32": np.int32, "int8": np.int8},
        dtypes={"float32": jnp.float32, "bfloat16": jnp.bfloat16,
                "int32": jnp.int32, "int8": jnp.int8})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _data(shape, dt, seed):
    """numpy data of ``dt`` (bf16 via ml_dtypes' rounding of float32)."""
    rng = np.random.default_rng(seed)
    if dt.startswith("int"):
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, shape, endpoint=True,
                            dtype=np.int64).astype(dt)
    import ml_dtypes
    a = rng.normal(size=shape).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dt == "bfloat16" else a


def _bits(x):
    """Raw bytes of a torch tensor or JAX/numpy array."""
    if isinstance(x, torch.Tensor):
        a = torch_to_numpy(x.cpu())
    else:
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            a = a.view(np.int16)
    return np.ascontiguousarray(a).view(np.uint8)


def _same(got, *wants):
    for w in wants:
        assert tuple(got.shape) == tuple(np.shape(w))
        np.testing.assert_array_equal(_bits(got), _bits(w))


# ------------------------------------------------------------------ #
# copy_2d and init_2d
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("dt,shape,value", [
    ("float32", (6, 10), 1.5),
    ("bfloat16", (33,), 0.1),          # rank 1, odd length, 0.100098
    ("int8", (2, 3, 5), -3),           # rank 3, odd width
])
def test_pim_copy_and_init_match_jax(jx, dt, shape, value):
    a = _data(shape, dt, seed=len(shape))
    got = rc_ops.pim_copy(numpy_to_torch(a, "cpu"))
    _same(got, jx.ref.copy_2d(jx.jnp.asarray(a)),
          jx.ops.pim_copy(jx.jnp.asarray(a), use_pallas=True,
                          interpret=True))
    got = rc_ops.pim_init(shape, value, TORCH[dt], device="cpu")
    _same(got, jx.ref.init_2d(shape, value, jx.dtypes[dt]),
          jx.ops.pim_init(shape, value, jx.dtypes[dt], use_pallas=True,
                          interpret=True))


# ------------------------------------------------------------------ #
# page_copy and page_init
# ------------------------------------------------------------------ #


PAGE_CASES = {
    # a chain: op 1 reads page 1, which op 0 writes (every op reads the
    # arena as it was before the batch); bf16 rows of 66 bytes
    "chain": ("bfloat16", 33, [0, 1], [1, 2], [3, 5], 0.1),
    # a duplicate destination: the last op wins; int8 rows of 9 bytes
    "duplicate": ("int8", 9, [2, 3, 0], [1, 1, 4], [6, 1], -3),
    # disjoint; int32 rows, a float fill cast to 1
    "disjoint": ("int32", 6, [1, 2], [5, 6], [0, 7], 1.5),
}


@pytest.mark.parametrize("case", sorted(PAGE_CASES))
def test_pim_page_copy_and_init_match_jax(jx, case):
    dt, width, src, dst, init_pages, value = PAGE_CASES[case]
    arena = _data((8, width), dt, seed=width)
    s, d, ip = (np.asarray(x, np.int32) for x in (src, dst, init_pages))
    got = rc_ops.pim_page_copy(numpy_to_torch(arena, "cpu"), s, d)
    want_ref = jx.ref.page_copy(jx.jnp.asarray(arena), jx.jnp.asarray(s),
                                jx.jnp.asarray(d))
    want_pl = jx.ops.pim_page_copy(jx.jnp.asarray(arena), jx.jnp.asarray(s),
                                   jx.jnp.asarray(d), use_pallas=True,
                                   interpret=True)
    _same(got, want_ref, want_pl)
    got = rc_ops.pim_page_init(got, ip, value)
    _same(got,
          jx.ref.page_init(want_ref, jx.jnp.asarray(ip), value),
          jx.ops.pim_page_init(want_pl, jx.jnp.asarray(ip), value,
                               use_pallas=True, interpret=True))


def test_empty_batches_change_nothing_and_launch_nothing(jx):
    """An empty page batch leaves the arena as the JAX reference does
    (held against the reference only), an empty buffer copies and fills
    to an empty buffer, and the CPU paths launch no kernel."""
    reset_launches()
    arena = _data((4, 6), "float32", seed=9)
    empty = np.zeros((0,), np.int32)
    t = numpy_to_torch(arena, "cpu")
    _same(rc_ops.pim_page_copy(t, empty, empty),
          jx.ref.page_copy(jx.jnp.asarray(arena), jx.jnp.asarray(empty),
                           jx.jnp.asarray(empty)))
    _same(rc_ops.pim_page_init(t, empty, 1.0),
          jx.ref.page_init(jx.jnp.asarray(arena), jx.jnp.asarray(empty), 1.0))
    assert rc_ops.pim_copy(torch.zeros((0, 3))).shape == (0, 3)
    assert rc_ops.pim_init((2, 0), 1.0, device="cpu").shape == (2, 0)
    with pytest.raises(ValueError):
        rc_ops.pim_page_copy(t, [0, 1], [2])
    with pytest.raises(IndexError):
        rc_ops.pim_page_init(t, [4], 0.0)
    assert set(launch_counts().values()) == {0}


def test_fill_refuses_eight_byte_dtypes():
    """The fill kernels write a repeated 32-bit word: 1-, 2- and 4-byte
    dtypes only (JAX without x64 has no 8-byte dtype)."""
    for dt in (torch.float64, torch.int64):
        with pytest.raises(TypeError):
            rc_ops.fill_pattern(1.0, dt)
        with pytest.raises(TypeError):
            rc_ops.pim_init((2, 2), 1.0, dt, device="cpu")
    assert rc_ops.fill_pattern(-3, torch.int8) == 0xFDFDFDFD
    assert rc_ops.fill_pattern(1.5, torch.int32) == 1


# ------------------------------------------------------------------ #
# The single-token write path
# ------------------------------------------------------------------ #


def test_append_token_kv_matches_jax_through_a_cow_tail(jx):
    from repro.configs import ARCHS as JARCHS, reduced as jreduced
    from repro.serving.kv_cache import PagedKVCache as JCache
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.serving.kv_cache import PagedKVCache

    jcfg = jreduced(JARCHS["granite-3-8b"], num_layers=2, num_kv_heads=2)
    cfg = reduced(ARCHS["granite-3-8b"], num_layers=2, num_kv_heads=2)
    c = PagedKVCache(cfg, num_pages=16, page_size=4, device="cpu")
    jc = JCache(jcfg, num_pages=16, page_size=4)
    assert c.queue.has_kind("kv_write") and not c.queue.has_kind("nope")
    assert jc.queue.has_kind("kv_write")
    rng = np.random.default_rng(5)
    shape = (c.n_layers, cfg.num_kv_heads, cfg.resolved_head_dim)

    def both(fn, *args):
        getattr(c, fn)(*args)
        getattr(jc, fn)(*args)

    both("create", 0, 0)
    for step in range(7):
        if step == 5:
            both("fork", 0, 1)          # the tail (slot 1 of page 1) shares
        k = rng.normal(size=shape).astype(np.float32)
        v = rng.normal(size=shape).astype(np.float32)
        before, jbefore = c.queue.snapshot(), jc.queue.snapshot()
        c.append_token_kv(c.seqs[0], torch.from_numpy(k), torch.from_numpy(v))
        jc.append_token_kv(jc.seqs[0], jx.jnp.asarray(k), jx.jnp.asarray(v))
        assert c.queue.delta(before) == jc.queue.delta(jbefore), step
    assert c.stats["cow_copies"] == jc.stats["cow_copies"] == 1
    assert c.refcount == jc.refcount
    assert [s.pages for s in c.seqs.values()] == \
        [s.pages for s in jc.seqs.values()]
    for a, ja in ((c.k_arena, jc.k_arena), (c.v_arena, jc.v_arena)):
        np.testing.assert_array_equal(_bits(a), _bits(ja))
    both("free", 0)
    both("free", 1)
    assert c.pages_in_use == 0 and torch.count_nonzero(c.k_arena) == 0


# ------------------------------------------------------------------ #
# CUDA kernels against their plain versions (the card only)
# ------------------------------------------------------------------ #


@pytest.mark.cuda
def test_cuda_copy_2d_matches_plain(cuda):
    for dt, shape in (("bfloat16", (33,)), ("int8", (3, 5, 7)),
                      ("float32", (257, 129))):
        src = numpy_to_torch(_data(shape, dt, seed=1), "cpu").to(cuda)
        reset_launches()
        got = rc_ops.pim_copy(src)
        torch.cuda.synchronize()
        assert launch_counts()["copy_2d"] == 1
        assert torch.equal(got.cpu(), rc_ref.copy_2d(src.cpu()))


@pytest.mark.cuda
def test_cuda_init_2d_matches_plain(cuda):
    for dt, shape, value in (("bfloat16", (33,), 0.1),
                             ("int8", (3, 5, 7), -3),
                             ("int32", (100, 17), 1.5),
                             ("float32", (4096, 33), 0.0)):
        got = rc_ops.pim_init(shape, value, TORCH[dt], device=cuda)
        torch.cuda.synchronize()
        want = rc_ref.init_2d(shape, value, TORCH[dt])
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_cuda_page_copy_matches_plain(cuda):
    for case in sorted(PAGE_CASES):
        dt, width, src, dst, _, _ = PAGE_CASES[case]
        arena = numpy_to_torch(_data((8, width), dt, seed=3), "cpu")
        want = rc_ref.page_copy(arena.clone(), torch.tensor(src),
                                torch.tensor(dst))
        got = rc_ops.pim_page_copy(arena.to(cuda), src, dst)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_cuda_page_init_matches_plain(cuda):
    for case in sorted(PAGE_CASES):
        dt, width, _, _, pages, value = PAGE_CASES[case]
        arena = numpy_to_torch(_data((8, width), dt, seed=4), "cpu")
        want = rc_ref.page_init(arena.clone(), torch.tensor(pages), value)
        got = rc_ops.pim_page_init(arena.to(cuda), pages, value)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(_bits(got), _bits(want))
