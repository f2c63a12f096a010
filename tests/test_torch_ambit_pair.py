"""The Ambit page ops (the JAX package's ``page_bitwise_batched`` and
``page_not_batched``, rows 8 and 9 of the port's kernel table) on one
arena, on a (K, V) pair in one launch, on an overlapping batch and on a
batch longer than the inline op list, against the JAX package.

On CPU tensors ``pim_page_bitwise_batched`` and its pair entry
``pim_page_bitwise_batched_pair`` run their plain versions; each arena
is held bit for bit against the JAX package's reference and its Pallas
kernels in interpret mode, on the same numpy inputs, for AND, OR and
NOT.  The wrapper's launch plan (route, op codes, the op list in the
launch or uploaded, the staged route's gather) is held against the
reference through a host model of ``am_page_rows``'s contract, as
``test_torch_page_copy.py`` models ``rc_copy_pages``.  ``TorchLib``'s
flush of a bound (K, V) pair calls the pair entry once a kind, while
the queue's ``launches_by_kind`` equal the JAX lib's (one per arena).

The CUDA kernel has no CPU mode: the ``cuda``-marked tests hold it
against its plain version on the card and skip here.  JAX is imported
in fixtures only.
"""

import ctypes
import struct
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import op_registry  # noqa: E402
from repro_torch.core.allocator import Allocation  # noqa: E402
from repro_torch.core.pimolib import TorchLib  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launches  # noqa: E402
from repro_torch.kernels.ambit import ops as amb_ops  # noqa: E402
from repro_torch.kernels.ambit import ref as amb_ref  # noqa: E402
from repro_torch.models.params import numpy_to_torch, torch_to_numpy  # noqa: E402

OPS = ("and", "or", "not")
# (pages, src, dst) batches: a disjoint batch; a chain (op 1 reads the
# page op 0 writes, op 2 its own page); a batch of 300 ops, past the 256
# (src, dst) pairs the launch carries, whose op i reads the page op i - 1
# writes
CASES = {
    "one_arena": (8, [0, 2, 5], [1, 3, 6]),
    "pair": (8, [0, 2, 5], [1, 3, 6]),
    "overlapping": (8, [0, 1, 4, 7], [1, 2, 4, 0]),
    "long": (304, list(range(300)), list(range(1, 301))),
}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import ml_dtypes
    from repro.core.allocator import Allocation as JAllocation
    from repro.core.pimolib import TpuLib
    from repro.kernels.ambit import ops as jamb
    return types.SimpleNamespace(jnp=jnp, amb=jamb, TpuLib=TpuLib,
                                 Allocation=JAllocation,
                                 bf16=ml_dtypes.bfloat16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _data(shape, dt, seed):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return a.astype(dt)


def _bits(x):
    a = torch_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    return np.ascontiguousarray(a).view(np.uint8)


def _jax(jx, arena, src, dst, op):
    """The JAX package's reference and Pallas (interpret mode) results of
    one batch on a numpy arena."""
    s = jx.jnp.asarray(np.asarray(src, np.int32))
    d = jx.jnp.asarray(np.asarray(dst, np.int32))
    return [jx.amb.pim_page_bitwise_batched(jx.jnp.asarray(arena), s, d,
                                            op=op, **kw)
            for kw in (dict(use_pallas=False),
                       dict(use_pallas=True, interpret=True))]


def _plain(arena, src, dst, op):
    s, d = torch.tensor(src), torch.tensor(dst)
    if op == "not":
        return amb_ref.page_not_batched(arena, s, d)
    return amb_ref.page_bitwise_batched(arena, s, d, op)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bitwise_matches_jax(jx, case):
    """AND, OR and NOT through the port's CPU entries, bit for bit
    against the JAX reference and Pallas: one bf16 (2, P, 4, 2, 8) arena,
    or a (K, V) pair of one shape through the pair entry (the
    overlapping batch on a pair too); the long batch on an int32
    (1, 304, 16) arena."""
    P, src, dst = CASES[case]
    for op in OPS:
        if case == "long":
            arenas = [np.random.default_rng(1).integers(
                -2**31, 2**31, (1, P, 16), dtype=np.int64).astype(np.int32)]
        else:
            arenas = [_data((2, P, 4, 2, 8), jx.bf16, seed=s)
                      for s in ((3,) if case == "one_arena" else (4, 5))]
        got = [numpy_to_torch(a, "cpu") for a in arenas]
        if len(got) == 2:
            amb_ops.pim_page_bitwise_batched_pair(*got, src, dst, op=op)
        else:
            amb_ops.pim_page_bitwise_batched(got[0], src, dst, op=op)
        for g, a in zip(got, arenas):
            for want in _jax(jx, a, src, dst, op):
                np.testing.assert_array_equal(_bits(g), _bits(want),
                                              err_msg=f"{case} {op}")


class _AmbitModel:
    """``am_page_rows`` on host memory, as its contract in
    ``csrc/ambit.cu`` and ``csrc/page_rows.cuh`` states it: 6 descriptor
    values an arena, 2n ops (sources, then destinations) inline or at
    ``dev_idx``, the identity bits, op 0 AND, 1 OR, 2 NOT, 3 COPY, and on
    the cluster route every source of a (layer, arena) read before any
    of its destinations is written (the direct route reads each source
    when its op runs, so a hazard sent down it shows)."""

    FN = {0: np.bitwise_and, 1: np.bitwise_or,
          2: lambda s, d: np.bitwise_not(s), 3: lambda s, d: s}

    def __init__(self, capacity):
        self.capacity = capacity
        self.calls = []

    def am_cluster_chunks(self):
        return self.capacity

    def am_page_rows(self, desc, arenas, dev_idx, host_idx, n, identity,
                     route, op, stream):
        vals = struct.unpack(f"{6 * arenas}q", desc)
        idx = (list((ctypes.c_int * (2 * n)).from_address(dev_idx))
               if dev_idx is not None
               else list(struct.unpack(f"{2 * n}i", host_idx)))
        self.calls.append((route, op, dev_idx is not None, arenas))
        fn = self.FN[op]

        def row(addr, nbytes):
            return np.frombuffer(ctypes.string_at(addr, nbytes), np.uint8)

        for z in range(arenas):
            s_base, d_base, s_rows, d_rows, nb, layers = vals[6 * z:6 * z + 6]
            for l in range(layers):
                moves = [(s_base + (l * s_rows + (i if identity & 1
                                                  else idx[i])) * nb,
                          d_base + (l * d_rows + (i if identity & 2
                                                  else idx[n + i])) * nb)
                         for i in range(n)]
                staged = [row(s, nb) for s, _ in moves]
                for (s, d), pre in zip(moves, staged):
                    src = pre if route == 1 else row(s, nb)
                    ctypes.memmove(d, fn(src, row(d, nb)).tobytes(), nb)
        return 0


@pytest.mark.parametrize("case", ["direct", "cluster", "staged", "long"])
def test_launch_plan_computes_as_the_reference(monkeypatch, case):
    """The wrapper's launches through the contract model, on a pair of
    unequal rows (bf16 pages beside int8 ones): a disjoint batch (the
    direct route), a chain (the cluster route), the chain past the
    cluster's capacity (two launches: a COPY gather, then the op from
    scratch) and a chain of 300 ops (the op list uploaded, the cluster
    route).  Every arena equals the reference's; ``LAUNCHES`` counts
    the launches under the op's name."""
    model = _AmbitModel(capacity=1 if case == "staged" else 4096)
    monkeypatch.setattr(amb_ops._build, "load", lambda name: model)
    monkeypatch.setattr(amb_ops, "cluster_chunks", model.am_cluster_chunks)
    monkeypatch.setattr(amb_ops, "_stream", lambda t: 0)
    P = 304 if case == "long" else 8
    src, dst = {"direct": ([1, 2, 5], [3, 4, 6]),
                "cluster": ([0, 1, 6], [1, 2, 6]),
                "staged": ([0, 1, 6], [1, 2, 6]),
                "long": (list(range(300)), list(range(1, 301)))}[case]
    g = torch.Generator().manual_seed(7)
    for op, code in amb_ops._OP_CODE.items():
        model.calls.clear()
        arenas = (torch.randn((3, P, 4, 8), generator=g).to(torch.bfloat16),
                  torch.randint(-100, 100, (3, P, 48), generator=g,
                                dtype=torch.int8))
        want = [_plain(a.clone(), src, dst, op) for a in arenas]
        reset_launches()
        route = amb_ops._launch_bitwise(arenas, src, dst, op)
        for a, w in zip(arenas, want):
            assert torch.equal(a.view(torch.uint8), w.view(torch.uint8)), \
                (case, op)
        assert route == {"long": "cluster"}.get(case, case)
        plan = {"direct": [(0, code)], "cluster": [(1, code)],
                "staged": [(0, amb_ops._COPY), (0, code)],
                "long": [(1, code)]}[case]
        assert [c[:2] for c in model.calls] == plan
        assert all(c[2] == (case == "long") and c[3] == 2
                   for c in model.calls)
        name = "page_not_batched" if op == "not" else "page_bitwise_batched"
        assert launch_counts()[name] == len(plan)
        assert sum(launch_counts().values()) == len(plan)


def test_torchlib_pair_flush_is_one_call_a_kind(jx, monkeypatch):
    """A deferred ``TorchLib`` bound to a bf16 (K, V) pair, against the
    JAX ``TpuLib`` on the same ops: the arenas bit for bit, and the
    queue's ``launches_by_kind`` and counters equal (two a kind, one per
    arena), while each kind's flush calls the pair entry once."""
    calls = []
    pair = amb_ops.pim_page_bitwise_batched_pair

    def spy(a0, a1, src, dst, *, op):
        calls.append(op)
        return pair(a0, a1, src, dst, op=op)

    monkeypatch.setattr(op_registry.amb_ops, "pim_page_bitwise_batched_pair",
                        spy)
    arenas = [_data((2, 12, 4, 2, 8), jx.bf16, seed=s) for s in (8, 9)]
    lib = TorchLib(buffers=[numpy_to_torch(a, "cpu") for a in arenas],
                   deferred=True)
    jlib = jx.TpuLib(buffers=[jx.jnp.asarray(a) for a in arenas],
                     deferred=True)
    # the second OR batch reads page 3, which the first wrote: the
    # queue flushes before it (``admit``)
    script = [("or", (0, 1), (2, 3)), ("or", (3,), (5,)),
              ("and", (6, 7, 2), (8, 9, 6)), ("not", (2,), (10,)),
              ("not", (11, 1), (0, 1))]
    for lb, A in ((lib, Allocation), (jlib, jx.Allocation)):
        for op, s, d in script:
            lb.bitwise(op, A(s, 0), A(d, 0))
        lb.flush()
    for a, ja in zip(lib.buffers, jlib.buffers):
        np.testing.assert_array_equal(_bits(a), _bits(ja))
    assert calls == ["or", "or", "and", "not"]
    nz = {k: v for k, v in jlib.queue.launches_by_kind.items() if v}
    assert {k: v for k, v in lib.queue.launches_by_kind.items() if v} == nz
    assert nz == {"page_or": 4, "page_and": 2, "page_not": 2}
    assert lib.queue.stats == {k: jlib.queue.stats[k]
                               for k in lib.queue.stats}


def test_wrappers_refuse_what_the_kernel_does_not_take():
    """An empty batch changes nothing and launches nothing; a repeated
    destination, lists of two lengths, an unknown op and a pair on two
    devices raise ``ValueError``; pages outside either arena
    ``IndexError``."""
    reset_launches()
    a0, a1 = torch.zeros((2, 4, 8)), torch.ones((2, 6, 3))
    amb_ops.pim_page_bitwise_batched_pair(a0, a1, [], [], op="and")
    assert torch.count_nonzero(a0) == 0 and bool((a1 == 1).all())
    for args, kw in ((([0, 1], [2, 2]), {"op": "or"}),
                     (([0, 1], [2]), {"op": "and"}),
                     (([0], [1]), {"op": "xor"})):
        with pytest.raises(ValueError):
            amb_ops.pim_page_bitwise_batched(a0, *args, **kw)
    with pytest.raises(IndexError):
        amb_ops.pim_page_bitwise_batched_pair(a0, a1, [0], [4], op="not")
    with pytest.raises(IndexError):
        amb_ops.pim_page_bitwise_batched(a0, [-1], [2], op="not")
    with pytest.raises(ValueError):
        amb_ops.pim_page_bitwise_batched_pair(a0, a1.to("meta"), [0], [1],
                                              op="or")
    assert set(launch_counts().values()) == {0}


# ------------------------------------------------------------------ #
# The CUDA kernel against its plain version (the card only)
# ------------------------------------------------------------------ #


def _card(shape, dtype, seed, cuda):
    g = torch.Generator(device=cuda).manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                             device=cuda, dtype=dtype)
    return torch.randn(shape, generator=g, device=cuda).to(dtype)


@pytest.mark.cuda
def test_cuda_bitwise_matches_plain(cuda):
    """Bit for bit on the card, at granite-3-8b's page rows (40 layers of
    32 KiB): one arena and the (K, V) pair, disjoint (the direct route)
    and overlapping (the cluster route), a layer's batch one page past
    the cluster's capacity (the staged route: a gather, then the op),
    batches of 300 ops (uploaded; disjoint, and a chain past the
    cluster's capacity), and unaligned byte rows (staged);
    ``LAUNCHES`` counts the route's launches."""
    cap = amb_ops.cluster_chunks()
    over = cap // 2 + 1                      # 32 KiB rows: 2 chunks
    cases = {
        "disjoint": ((40, 40, 16, 8, 128), [0, 2, 5], [1, 3, 6], 1),
        "overlapping": ((40, 40, 16, 8, 128), [0, 1, 4, 7], [1, 2, 4, 0],
                        1),
        "over_capacity": ((3, over + 2, 16, 1024), list(range(over)),
                          list(range(1, over + 1)), 2),
        "long_disjoint": ((2, 600, 16, 8, 128), list(range(300)),
                          list(range(300, 600)), 1),
        "long_chain": ((2, 304, 16, 16), list(range(300)),
                       list(range(1, 301)), 2),
        "unaligned": ((3, 8, 9), [0, 1], [1, 2], 2),
    }
    for case, (shape, src, dst, launches) in cases.items():
        dtype = torch.int8 if case == "unaligned" else torch.bfloat16
        for op in OPS:
            for n_arenas in (1, 2):
                arenas = [_card(shape, dtype, 10 + k, cuda)
                          for k in range(n_arenas)]
                want = [_plain(a.clone(), src, dst, op) for a in arenas]
                reset_launches()
                if n_arenas == 2:
                    amb_ops.pim_page_bitwise_batched_pair(*arenas, src, dst,
                                                          op=op)
                else:
                    amb_ops.pim_page_bitwise_batched(arenas[0], src, dst,
                                                     op=op)
                torch.cuda.synchronize()
                assert sum(launch_counts().values()) == launches, \
                    (case, op, n_arenas)
                for a, w in zip(arenas, want):
                    assert torch.equal(a.view(torch.uint8),
                                       w.view(torch.uint8)), \
                        (case, op, n_arenas)


@pytest.mark.cuda
def test_cuda_torchlib_pair_is_one_launch_a_kind(cuda):
    """``TorchLib.bitwise`` on a full-size (K, V) pair: each kind's flush
    is one kernel launch, counted as two by the queue, and the arenas
    equal the plain versions'."""
    from repro_torch.core.allocator import SubarrayAllocator, arena_groups
    from repro_torch.core.pimolib import Blocking

    shape = (40, 64, 16, 8, 128)
    arenas = [_card(shape, torch.bfloat16, 20 + k, cuda) for k in range(2)]
    alloc = SubarrayAllocator(arena_groups(4, shape[1] // 4))
    lib = TorchLib(buffers=arenas, layered=True, allocator=alloc,
                   deferred=True)
    g = alloc.group_ids()[1]
    src, dst = alloc.alloc(8, group=g), alloc.alloc(8, group=g)
    for op in OPS:
        want = [_plain(a.clone(), src.rows, dst.rows, op) for a in arenas]
        before = lib.queue.snapshot()
        reset_launches()
        lib.bitwise(op, src, dst, blocking=Blocking.FIN)
        assert lib.queue.delta(before) == {f"page_{op}": 2}
        assert sum(launch_counts().values()) == 1
        for a, w in zip(arenas, want):
            assert torch.equal(a.view(torch.uint8), w.view(torch.uint8)), op
