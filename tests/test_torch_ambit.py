"""The Ambit kernels, ``TorchLib.bitwise`` and the zero-compare paths of
the port against the JAX package.

Kernels: the plain versions the wrappers run on CPU tensors are held bit
for bit against the JAX package's ``pim_page_bitwise_batched`` and
``pim_page_zero_scan``, both through the jnp reference and through the
Pallas kernels in interpret mode (as ``tests/test_ambit.py`` runs them),
on int32 and bf16 arenas: AND, OR and NOT on a disjoint batch, on an op
over its own page, and on a batch in which a later op writes the page an
earlier op reads (the op queue forms such batches: it flushes only when
a later op reads or rewrites a page already written).  The scan is held
on a page whose only nonzero bit is deep in the last layer and on a page
holding one ``-0.0`` (0x8000 in bf16: nonzero bits, though it compares
equal to zero as a float).

The lib: ``TorchLib.bitwise`` against ``TpuLib.bitwise`` on the same
allocations and ops: arenas bit for bit, one launch per kind per arena,
the same queue counters and ``stats["bitwises"]``.

The cache and engine: the cases of ``tests/test_ambit.py``'s serving
class side by side with the JAX cache, and a chunked, K=8 prefix-cache
workload with the scan on, whose zero-scan counters, launch deltas and
streams must equal the JAX engine's (the harness of
``test_torch_prefix.py``).

The CUDA kernels have no CPU mode; their test against the plain
versions needs the card and skips here.  JAX is imported in fixtures,
not at the top, so that test also runs where JAX is not installed.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core.allocator import Allocation  # noqa: E402
from repro_torch.core.pimolib import (Blocking, TorchLib,  # noqa: E402
                                      make_torch_arena)
from repro_torch.kernels import launch_counts, reset_launches  # noqa: E402
from repro_torch.kernels.ambit import ops as amb_ops  # noqa: E402
from repro_torch.kernels.ambit import ref as amb_ref  # noqa: E402
from repro_torch.models.params import torch_to_numpy  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache  # noqa: E402

L, P, ROW = 2, 8, (4, 2, 8)             # (layers, pages, page row dims)
# (src, dst) batches: disjoint; an op over its own page; a later op's
# destination is an earlier op's source (op 2 writes page 0, op 0 reads
# it: every op must read the pre-batch arena)
BATCHES = {"disjoint": ([0, 2, 5], [1, 3, 6]),
           "own_page": ([4, 2], [4, 7]),
           "later_dst_is_src": ([0, 2, 5], [1, 3, 0])}
ZERO_KEYS = ("init_skips_zero", "zero_audit_pages", "zero_audit_failures")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's Ambit kernels, lib and cache."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import ARCHS as JARCHS, reduced as jreduced
    from repro.core.allocator import Allocation as JAllocation
    from repro.core.pimolib import Blocking, TpuLib, make_tpu_arena
    from repro.kernels.ambit import ops as amb
    from repro.serving.kv_cache import PagedKVCache
    return types.SimpleNamespace(
        jnp=jnp, lax=jax.lax, amb=amb, Allocation=JAllocation,
        Blocking=Blocking, TpuLib=TpuLib, make_tpu_arena=make_tpu_arena,
        Cache=PagedKVCache,
        cfg=jreduced(JARCHS["granite-3-8b"], num_layers=2))


@pytest.fixture(scope="module")
def model():
    pytest.importorskip("jax")
    from test_torch_prefix import build_model
    return build_model()


def _arena(dtype, rng):
    """(L, P, ROW) int32 or bf16, as a torch tensor on the CPU (bf16
    rounded from float32 to nearest even, as numpy's bf16 rounds)."""
    if dtype == "int32":
        return torch.from_numpy(rng.integers(
            -2**31, 2**31, (L, P) + ROW, dtype=np.int64).astype(np.int32))
    return torch.from_numpy(rng.normal(size=(L, P) + ROW)
                            .astype(np.float32)).to(torch.bfloat16)


def _bits(x):
    """Raw bits of a torch tensor or a JAX/numpy array, as numpy."""
    if isinstance(x, torch.Tensor):
        return torch_to_numpy(x)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _to_jax(jx, t):
    """A CPU tensor as a JAX array of the same bits and dtype."""
    a = torch_to_numpy(t)
    if t.dtype == torch.bfloat16:
        return jx.lax.bitcast_convert_type(jx.jnp.asarray(a),
                                           jx.jnp.bfloat16)
    return jx.jnp.asarray(a)


@pytest.mark.parametrize("dtype", ["int32", "bfloat16"])
def test_bitwise_plain_matches_jax_bit_for_bit(jx, dtype):
    base = _arena(dtype, np.random.default_rng(3))
    jnp = jx.jnp
    for case, (src, dst) in BATCHES.items():
        for op in ("and", "or", "not"):
            got = amb_ops.pim_page_bitwise_batched(base.clone(), src, dst,
                                                   op=op)
            js, jd = jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32)
            for kw in (dict(use_pallas=False),
                       dict(use_pallas=True, interpret=True)):
                want = jx.amb.pim_page_bitwise_batched(_to_jax(jx, base), js,
                                                       jd, op=op, **kw)
                np.testing.assert_array_equal(_bits(got), _bits(want),
                                              err_msg=f"{case} {op} {kw}")


def _scan_arena(dtype):
    """Zero pages except: a 1 deep in the last layer of page 3, a
    ``-0.0`` (bf16; int32: the sign bit) alone in page 5, page 6 all
    ones."""
    arena = torch.zeros((L, P) + ROW, dtype=getattr(torch, dtype))
    arena[1, 3, 3, 1, 7] = 1
    if dtype == "bfloat16":
        arena[0, 5, 0, 0, 0] = -0.0
    else:
        arena[0, 5, 0, 0, 0] = -2**31
    arena[0, 6] = 1
    return arena


@pytest.mark.parametrize("dtype", ["int32", "bfloat16"])
def test_zero_scan_plain_matches_jax_bit_for_bit(jx, dtype):
    arena = _scan_arena(dtype)
    pages = [0, 3, 5, 6, 7, 3]
    got = amb_ops.pim_page_zero_scan(arena, pages)
    assert got.dtype == torch.bool
    for kw in (dict(use_pallas=False), dict(use_pallas=True, interpret=True)):
        want = jx.amb.pim_page_zero_scan(
            _to_jax(jx, arena), jx.jnp.asarray(pages, jx.jnp.int32), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  [True, False, False, False, True, False])
    if dtype == "bfloat16":      # -0.0 equals zero as a float, not in bits
        assert bool((arena[:, 5] == 0).all())


def test_cpu_wrappers_launch_no_kernel():
    reset_launches()
    arena = torch.ones((1, 4, 8), dtype=torch.bfloat16)
    amb_ops.pim_page_bitwise_batched(arena, [0], [1], op="not")
    assert not amb_ops.pim_page_zero_scan(arena, [1]).item()
    assert amb_ops.pim_page_zero_scan(arena, []).shape == (0,)
    assert set(launch_counts().values()) == {0}
    with pytest.raises(ValueError):
        amb_ops.pim_page_bitwise_batched(arena, [0], [1], op="xor")


def test_torchlib_bitwise_matches_tpulib(jx):
    """Unlayered uint8 pages with FIN (one launch per kind), then a
    deferred layered bf16 pair where an op reads a page a pending op
    wrote (``admit`` flushes first): arenas bit for bit, launches by
    kind, queue counters and ``stats["bitwises"]`` as the JAX lib's."""
    rng = np.random.default_rng(11)
    va = rng.integers(0, 256, (3, 64)).astype(np.uint8)
    vb = rng.integers(0, 256, (3, 64)).astype(np.uint8)
    for op, want in (("and", va & vb), ("or", va | vb), ("not", ~va)):
        lib = TorchLib(make_torch_arena(2, 8, 64, dtype=torch.uint8,
                                        device="cpu"))
        jlib = jx.TpuLib(jx.make_tpu_arena(num_slabs=2, pages_per_slab=8,
                                           page_elems=64,
                                           dtype=jx.jnp.uint8))
        JA = jx.Allocation
        for lb, (src, dst), blk in (
                (lib, (Allocation((0, 1, 2), 0), Allocation((3, 4, 5), 0)),
                 Blocking.FIN),
                (jlib, (JA((0, 1, 2), 0), JA((3, 4, 5), 0)),
                 jx.Blocking.FIN)):
            lb.write(src, va)
            lb.write(dst, vb)
            rec = lb.bitwise(op, src, dst, blocking=blk)
            assert rec.ok and rec.op == f"ambit_{op}" and rec.launches == 1
        np.testing.assert_array_equal(
            lib.read(Allocation((3, 4, 5), 0)).numpy(), want)
        np.testing.assert_array_equal(_bits(lib.buffers[0]),
                                      np.asarray(jlib.buffers[0]))
        assert lib.queue.launches_by_kind == {
            k: jlib.queue.launches_by_kind.get(k, 0)
            for k in lib.queue.launches_by_kind}
        assert lib.stats["bitwises"] == jlib.stats["bitwises"] == 3

    arenas = [torch.from_numpy(rng.normal(size=(L, 12) + ROW)
                               .astype(np.float32)).to(torch.bfloat16)
              for _ in range(2)]
    lib = TorchLib(buffers=[a.clone() for a in arenas], deferred=True)
    jlib = jx.TpuLib(buffers=[_to_jax(jx, a) for a in arenas], deferred=True)
    script = [("or", (0, 1), (2, 3)), ("or", (4,), (5,)),
              ("and", (6, 7), (8, 9)), ("not", (2,), (10,)),
              ("not", (11,), (0,)), ("and", (1,), (1,))]
    for lb, A in ((lib, Allocation), (jlib, jx.Allocation)):
        for op, s, d in script:
            lb.bitwise(op, A(s, 0), A(d, 0))
        lb.flush()
    for a, ja in zip(lib.buffers, jlib.buffers):
        np.testing.assert_array_equal(_bits(a), _bits(ja))
    assert lib.queue.stats == {k: jlib.queue.stats[k]
                               for k in lib.queue.stats}
    nz = {k: v for k, v in jlib.queue.launches_by_kind.items() if v}
    assert {k: v for k, v in lib.queue.launches_by_kind.items() if v} == nz
    assert nz == {"page_or": 2, "page_and": 4, "page_not": 2}
    assert lib.stats["bitwises"] == jlib.stats["bitwises"] == 8


def _ones(c, n):
    """Prompt KV of ones for ``n`` tokens, in the cache's framework."""
    shape = (c.n_layers, n, c.cfg.num_kv_heads, c.cfg.resolved_head_dim)
    if isinstance(c, PagedKVCache):
        return torch.ones(shape, dtype=torch.bfloat16)
    return np.ones(shape, np.float32)


def _case_skip_unwritten(c):
    """A written partial page and two reserved, never written pages: one
    scan launch per arena, two inits skipped and booked as saved."""
    seq = c.create(0, 2)
    k = _ones(c, 2)
    c.write_prompt_kv(seq, k, k)
    c.reserve_tokens(c.seqs[0], 9)
    assert len(c.seqs[0].pages) == 3
    c.free(0)
    assert c.stats["init_skips_zero"] == 2
    assert c.queue.saved_by_kind.get("page_init") == 2
    assert c.queue.launches_by_kind["page_zero_scan"] == 2


def _case_default_off(c):
    c.create(0, 6)
    c.free(0)
    assert c.queue.launches_by_kind.get("page_zero_scan", 0) == 0
    assert c.stats["init_skips_zero"] == 0


def _case_clear_prefix_audit(c):
    tokens = list(range(8))
    seq = c.create(0, 8, tokens=tokens)
    k = _ones(c, 8)
    c.write_prompt_kv(seq, k, k)
    assert c.commit_prefix(0, tokens) == 2
    c.free(0)                          # the tree still holds the pages
    assert c.pages_in_use == 2
    assert c.clear_prefix() == 2
    assert c.stats["zero_audit_pages"] == 2
    assert c.stats["zero_audit_failures"] == 0


@pytest.mark.parametrize("case,kw", [
    (_case_skip_unwritten, dict(zero_scan=True)),
    (_case_default_off, dict()),
    (_case_clear_prefix_audit, dict(prefix_cache=True, zero_scan=True))],
    ids=["skip_unwritten", "default_off", "clear_prefix_audit"])
def test_zero_scan_cache_matches_jax(jx, case, kw):
    cfg = reduced(ARCHS["granite-3-8b"], num_layers=2)
    pair = (PagedKVCache(cfg, num_pages=32, page_size=4, device="cpu", **kw),
            jx.Cache(jx.cfg, num_pages=32, page_size=4, **kw))
    for c in pair:
        case(c)
    c, jc = pair
    assert c.pages_in_use == 0 == jc.pages_in_use
    assert c.stats == {k: jc.stats[k] for k in c.stats}
    assert {k: v for k, v in c.queue.launches_by_kind.items() if v} == \
        {k: v for k, v in jc.queue.launches_by_kind.items() if v}
    assert c.queue.saved_by_kind == jc.queue.saved_by_kind
    for a, ja in ((c.k_arena, jc.k_arena), (c.v_arena, jc.v_arena)):
        np.testing.assert_array_equal(_bits(a), _bits(ja))
        assert not _bits(a).any()


def test_zero_scan_engine_matches_jax(model):
    """A chunked (8-token chunks), K=8 prefix-cache workload with the
    scan on, on a 24-page arena: a 20-token system prompt committed,
    then three tenants of it (one stopping at an EOS inside its first
    decode block, leaving reserved pages unwritten), then two fresh
    prompts that evict the cold prefix.  The scan's skipped inits, the
    ``clear_prefix`` audit and every step's launches (``page_zero_scan``
    included) equal the JAX engine's."""
    from test_torch_prefix import assert_same_run, check_choices, run_both
    _, cfg, _, _ = model
    rng = np.random.default_rng(5)
    sys_prompt = rng.integers(0, cfg.vocab_size, 20).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
             for _ in range(3)]
    fresh = [rng.integers(0, cfg.vocab_size, 30).astype(np.int32)
             for _ in range(2)]

    def req(rid, prompt, **kw):
        return lambda cls: cls(rid, prompt, max_new_tokens=12,
                               temperature=0.0, **kw)

    kw = dict(page_size=4, num_pages=24, max_prefill_chunk=8,
              decode_block_rounds=8, prefix_cache=True)

    def scan_on(engine):
        engine.cache.enable_zero_scan()

    def waves(eos=None):
        return [[req(0, sys_prompt)],
                [req(1, np.concatenate([sys_prompt, tails[0]]),
                     eos_token_id=eos),
                 req(2, np.concatenate([sys_prompt, tails[1]])),
                 req(3, np.concatenate([sys_prompt, tails[2]]))],
                [req(4, fresh[0]), req(5, fresh[1])]]

    # the EOS: a token of request 1's stream that its first K-block
    # emits (its first four come from chunk and mixed rounds), from a
    # JAX run without it
    jeng, jrun, _, _, _ = run_both(model, waves(), setup=scan_on, **kw)
    stream = jrun["results"][1]
    eos = next(t for i, t in enumerate(stream) if i >= 4
               and t not in stream[:i])
    jeng, jrun, eng, run, calls = run_both(model, waves(eos), setup=scan_on,
                                           **kw)
    assert_same_run(jeng, jrun, eng, run, keys=ZERO_KEYS + (
        "prefix_hits", "prefix_evictions", "pages_zeroed"))
    assert check_choices(eng, calls) >= 1
    st = eng.cache.stats
    assert st["prefix_hits"] >= 3 and st["prefix_evictions"] > 0
    assert st["init_skips_zero"] > 0
    assert st["zero_audit_pages"] > 0 and st["zero_audit_failures"] == 0
    assert eng.cache.queue.launches_by_kind["page_zero_scan"] == \
        jeng.cache.queue.launches_by_kind["page_zero_scan"] > 0
    assert eng.stats["multi_round_blocks"] > 0


# ------------------------------------------------------------------ #
# CUDA kernels against their plain versions (the card only; run with
# ``python -m pytest -m cuda --noconftest tests/test_torch_ambit.py``)
# ------------------------------------------------------------------ #


@pytest.mark.cuda
def test_cuda_ambit_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    cuda = torch.device("cuda")
    rng = np.random.default_rng(6)
    for dtype in ("int32", "bfloat16"):
        base = _arena(dtype, rng)
        for case, (src, dst) in BATCHES.items():
            for op in ("and", "or", "not"):
                want = amb_ref.page_not_batched(
                    base.clone(), torch.tensor(src), torch.tensor(dst)) \
                    if op == "not" else amb_ref.page_bitwise_batched(
                        base.clone(), torch.tensor(src), torch.tensor(dst),
                        op)
                got = amb_ops.pim_page_bitwise_batched(base.to(cuda), src,
                                                       dst, op=op)
                torch.cuda.synchronize()
                assert torch.equal(_bits_t(got.cpu()), _bits_t(want)), \
                    (dtype, case, op)
    for dtype in ("int32", "bfloat16"):
        arena = _scan_arena(dtype)
        pages = [0, 3, 5, 6, 7, 3]
        want = amb_ref.page_zero_scan(arena, torch.tensor(pages))
        got = amb_ops.pim_page_zero_scan(arena.to(cuda), pages)
        assert torch.equal(got.cpu(), want), dtype
        assert want.tolist() == [True, False, False, False, True, False]


def _bits_t(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
