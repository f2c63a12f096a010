"""The zero scan of a (K, V) pair in one launch, the token choice's draw
in one launch, and the step cache's capture on a key's second use.

On the CPU, against the JAX package on the same numpy-seeded inputs:

* ``ref.page_zero_scan_pair`` (what ``pim_page_zero_scan_pair`` runs on
  CPU tensors) against the JAX ``pim_page_zero_scan`` ANDed over the two
  arenas, through the Pallas kernel in interpret mode and through its
  reference, bit for bit: a page whose only set bits are a ``-0.0``, a
  page nonzero only in V, one nonzero only in its last layer, repeated
  pages, and a list of more than ``INLINE_ROWS`` (512) pages (the
  launch's parameters hold 512; a longer list is uploaded);
* ``PagedKVCache.scan_zero_pages`` against the JAX cache's: the flags and
  the ``launches_by_kind`` delta (``page_zero_scan`` counted once per
  arena, as JAX counts it);
* ``ref.random_uniform`` with and without a row map against the JAX
  ``pim_random_uniform(...)[rowmap]``, bit for bit, at the sampled
  path's (8, 1) and at (4096, 256);
* a sampled chunked engine (mixed rounds, K-blocks whose pad rows fold
  onto row 0) gives the same streams, ``launches_by_kind`` deltas and
  ``rng_ctr`` as the same engine drawing as the port drew before (the
  words, then four elementwise passes, then ``u[rowmap]``), and the
  JAX engine on the same workload has the same deltas and ``rng_ctr``.

On the card (``-m cuda``; JAX is imported only inside the CPU tests):

* the pair scan and the single-arena scan against their plain versions
  at their edges (bf16 and int32, rows not a multiple of 16 bytes, more
  than 512 pages, the same scratch reused by later launches), one launch
  each;
* the uniform draw against its plain version and against the words'
  old elementwise formula, with and without a row map;
* a step's first call runs eagerly and captures nothing, its second
  captures and replays, with equal outputs and unchanged counters.

Tolerances: none; every comparison here is exact (bits, flags, counts
and streams).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.kernels import (LAUNCHES, launch_counts,  # noqa: E402
                                 reset_launches)
from repro_torch.kernels.ambit import ops as amb_ops  # noqa: E402
from repro_torch.kernels.ambit import ref as amb_ref  # noqa: E402
from repro_torch.kernels.drange import ops as dr_ops  # noqa: E402
from repro_torch.kernels.drange import ref as dr_ref  # noqa: E402
from repro_torch.kernels.rowclone.ops import INLINE_ROWS  # noqa: E402
from repro_torch.models.params import torch_to_numpy  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache  # noqa: E402

CPU = torch.device("cpu")
ROW = (4, 2, 8)
# the scan's planted pages, expected zero flags by page
SCAN_PAGES = [0, 1, 2, 3, 4, 5, 2, 0, 3, 1]
SCAN_WANT = [True, False, False, False, False, True, False, True, False,
             False]
# a chunked, sampled engine: 4-token pages, 8-token chunks, K=4 blocks
CHUNKED = dict(page_size=4, num_pages=64, max_prefill_chunk=8,
               mixed_rounds=True, decode_block_rounds=4)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's scan, generator and cache."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS as JARCHS, reduced as jreduced
    from repro.kernels.ambit import ops as amb
    from repro.kernels.drange import ops as dr
    from repro.serving.kv_cache import PagedKVCache as JCache
    return types.SimpleNamespace(
        jnp=jnp, lax=jax.lax, amb=amb, dr=dr, Cache=JCache,
        cfg=jreduced(JARCHS["granite-3-8b"], num_layers=2))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels and graphs have "
                    "no CPU mode")
    return torch.device("cuda")


def _to_jax(jx, t):
    """A CPU tensor as a JAX array of the same bits and dtype."""
    a = torch_to_numpy(t)
    if t.dtype == torch.bfloat16:
        return jx.lax.bitcast_convert_type(jx.jnp.asarray(a),
                                           jx.jnp.bfloat16)
    return jx.jnp.asarray(a)


def _scan_pair(dtype, layers=3, pages=8, row=ROW):
    """A zero (K, V) pair but: page 1 holds one ``-0.0`` in K (int32:
    the sign bit), page 2 a 1 in V only, page 3 a 1 deep in K's last
    layer, page 4 random values in both; pages 0 and 5 stay zero."""
    rng = np.random.default_rng(11)
    dt = getattr(torch, dtype)
    k = torch.zeros((layers, pages) + row, dtype=dt)
    v = torch.zeros_like(k)
    k[0, 1].view(-1)[0] = -0.0 if dtype == "bfloat16" else -2**31
    v[1, 2].view(-1)[-1] = 1
    k[layers - 1, 3].view(-1)[-1] = 1
    for a in (k, v):
        a[:, 4] = torch.from_numpy(rng.integers(
            1, 100, (layers,) + row).astype(np.float32)).to(dt)
    return k, v


def _jax_pair(jx, k, v, pages, **kw):
    jp = jx.jnp.asarray(np.asarray(pages, np.int32))
    return (np.asarray(jx.amb.pim_page_zero_scan(_to_jax(jx, k), jp, **kw))
            & np.asarray(jx.amb.pim_page_zero_scan(_to_jax(jx, v), jp,
                                                   **kw)))


# ------------------------------------------------------------------ #
# CPU: the pair scan against the JAX scan over both arenas
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("dtype", ["bfloat16", "int32"])
def test_scan_pair_plain_matches_jax(jx, dtype):
    k, v = _scan_pair(dtype)
    got = amb_ref.page_zero_scan_pair(k, v, torch.tensor(SCAN_PAGES))
    assert got.dtype == torch.bool
    reset_launches()
    flags = amb_ops.pim_page_zero_scan_pair(k, v, SCAN_PAGES)
    assert set(launch_counts().values()) == {0}   # the plain version ran
    assert isinstance(flags, np.ndarray) and flags.dtype == bool
    np.testing.assert_array_equal(flags, got.numpy())
    for kw in (dict(use_pallas=False), dict(use_pallas=True, interpret=True)):
        np.testing.assert_array_equal(
            got.numpy(), _jax_pair(jx, k, v, SCAN_PAGES, **kw), err_msg=kw)
    assert got.tolist() == SCAN_WANT
    if dtype == "bfloat16":      # -0.0 equals zero as a float, not in bits
        assert bool((k[:, 1] == 0).all())
    assert amb_ops.pim_page_zero_scan_pair(k, v, []).shape == (0,)
    with pytest.raises(ValueError):
        amb_ops.pim_page_zero_scan_pair(k, v[:, :5], [0])
    with pytest.raises(IndexError):
        amb_ops.pim_page_zero_scan_pair(k, v, [0, 8])


def test_scan_pair_long_list_matches_jax(jx):
    """More pages than a launch's parameters hold: 700 of 600 (repeats),
    a third of the pages nonzero in one arena only."""
    rng = np.random.default_rng(12)
    P = 600
    k = torch.zeros((2, P, 2, 8), dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    for a, pages in ((k, rng.choice(P, 100, replace=False)),
                     (v, rng.choice(P, 100, replace=False))):
        for p in pages:
            a[int(rng.integers(2)), int(p)].view(-1)[
                int(rng.integers(16))] = 1.0
    pages = rng.integers(0, P, INLINE_ROWS + 188)
    got = amb_ops.pim_page_zero_scan_pair(k, v, pages)
    want = _jax_pair(jx, k, v, pages, use_pallas=False)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    # the Pallas kernel in interpret mode on a slice of the same list
    np.testing.assert_array_equal(
        got[:40], _jax_pair(jx, k, v, pages[:40], use_pallas=True,
                            interpret=True))


def test_cache_scan_flags_and_deltas_match_jax(jx):
    """Three sequences on both caches: K and V written with ones, K ones
    and V zeros, K zeros and V ones; the scan over their pages, over
    never-written pages and over repeats gives JAX's flags and launch
    delta, and so does ``free()``'s scan of the last one."""
    cfg = reduced(ARCHS["granite-3-8b"], num_layers=2)
    caches = (PagedKVCache(cfg, num_pages=32, page_size=4, device="cpu",
                           zero_scan=True),
              jx.Cache(jx.cfg, num_pages=32, page_size=4, zero_scan=True))
    shape = (2, 6, cfg.num_kv_heads, cfg.resolved_head_dim)
    seen = []
    for c in caches:
        ones = (torch.ones(shape, dtype=torch.bfloat16)
                if isinstance(c, PagedKVCache) else np.ones(shape, np.float32))
        zeros = ones * 0
        for sid, (kk, vv) in enumerate(((ones, ones), (ones, zeros),
                                        (zeros, ones))):
            seq = c.create(sid, 6)
            c.write_prompt_kv(seq, kk, vv)
        c.reserve_tokens(c.seqs[2], 11)          # a page never written
        pages = [p for s in range(3) for p in c.seqs[s].pages]
        pages += [0, 31, pages[0], pages[-1]]
        before = c.queue.snapshot()
        flags = c.scan_zero_pages(pages)
        delta = c.queue.delta(before)
        before = c.queue.snapshot()
        c.free(2)
        seen.append((np.asarray(flags), delta, c.queue.delta(before),
                     dict(c.stats)))
    (flags, delta, free_delta, stats), (jflags, jdelta, jfree, jstats) = seen
    assert flags.dtype == bool
    np.testing.assert_array_equal(flags, jflags)
    assert delta == jdelta and delta.get("page_zero_scan") == 2
    assert free_delta == jfree and free_delta.get("page_zero_scan") == 2
    assert stats == {k: jstats[k] for k in stats}
    assert stats["init_skips_zero"] == 3     # the reserved, unwritten pages
    assert flags.any() and not flags.all()


# ------------------------------------------------------------------ #
# CPU: the uniforms, with and without the row map, against JAX
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("shape", [(8, 1), (4096, 256)],
                         ids=["8x1", "4096x256"])
def test_random_uniform_plain_matches_jax(jx, shape):
    rng = np.random.default_rng(13)
    n_rows, n_cols = shape
    rowmap = (np.asarray([0, 1, 2, 3, 4, 5, 0, 0]) if shape == (8, 1)
              else rng.integers(0, n_rows, 300))
    for seed in ((0x9E3779B9, 12345), (0xFFFFFFF0, 0xFFFFFFFF)):
        jseed = jx.jnp.asarray(seed, jx.jnp.uint32)
        kws = [dict(use_pallas=False)]
        if shape == (8, 1):
            kws.append(dict(use_pallas=True, interpret=True))
        for kw in kws:
            want = np.asarray(jx.dr.pim_random_uniform(jseed, n_rows, n_cols,
                                                       **kw))
            got = dr_ref.random_uniform(seed, n_rows, n_cols, CPU).numpy()
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
            got = dr_ops.pim_random_uniform(
                seed, n_rows, n_cols, "cpu",
                rowmap=torch.from_numpy(rowmap)).numpy()
            assert got.shape == (rowmap.size, n_cols)
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want[rowmap].view(np.uint32))
    with pytest.raises(IndexError):
        dr_ref.random_uniform((1, 2), n_rows, n_cols, CPU,
                              rowmap=torch.tensor([n_rows]))


# ------------------------------------------------------------------ #
# CPU: the sampled engine's streams and rng_ctr
# ------------------------------------------------------------------ #


class _OldDraw(E.PagedEngine):
    """The port's engine drawing as it drew before the one-launch draw:
    the words, four elementwise passes, then the row map's gather."""

    def _choose(self, logits, temps, seed, rowmap=None):
        greedy = torch.argmax(logits, dim=-1)
        if np.all(temps == 0.0):
            return greedy
        bits = dr_ops.pim_random_u32(seed, logits.shape[0], 1,
                                     logits.device).view(torch.int32)
        u = ((bits >> 8) & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
        u = u[:, 0]
        if rowmap is not None:
            u = u[rowmap]
        t = torch.from_numpy(np.where(temps > 0.0, temps, np.float32(1.0)))
        cum = torch.cumsum(torch.softmax(logits.float() / t[:, None], -1),
                           -1)
        drawn = torch.argmax((cum > u[:, None]).to(torch.uint8), dim=-1)
        return torch.where(torch.from_numpy(temps == 0.0), greedy, drawn)


def _sampled_waves(vocab):
    """Four prompts of 10-21 tokens, three of them sampled, finishing at
    different rounds (a block's batch of 3 pads to 4 and folds)."""
    rng = np.random.default_rng(14)
    spec = [(16, 10, 1.0), (13, 20, 0.0), (21, 14, 0.7), (10, 18, 1.0)]
    return [[lambda cls, i=i, p=rng.integers(0, vocab, n).astype(np.int32),
             m=m, t=t: cls(i, p, max_new_tokens=m, temperature=t)
             for i, (n, m, t) in enumerate(spec)]]


def test_sampled_engine_streams_and_rng_ctr_unchanged(monkeypatch):
    pytest.importorskip("jax")
    import test_torch_prefix as H

    model = H.build_model()
    jcfg, cfg, jparams, params = model
    waves = _sampled_waves(cfg.vocab_size)
    jeng, jrun, _, _, _ = H.run_both(model, waves, **CHUNKED)
    draws = []
    orig = dr_ops.pim_random_uniform

    def counted(seed, n_rows, n_cols, device=None, rowmap=None):
        draws.append(None if rowmap is None else rowmap.tolist())
        return orig(seed, n_rows, n_cols, device, rowmap=rowmap)

    monkeypatch.setattr(dr_ops, "pim_random_uniform", counted)
    runs = []
    for cls in (E.PagedEngine, _OldDraw):
        eng = cls(cfg, params, device="cpu", **CHUNKED)
        runs.append((eng, H.drive(eng, waves)))
    (new, run), (old, orun) = runs
    assert run["results"] == orun["results"]
    assert run["deltas"] == orun["deltas"] == jrun["deltas"]
    assert new.rng_ctr == old.rng_ctr == jeng.rng_ctr
    # the new engine drew through the one-call draw, mixed rounds ran,
    # and a K-block folded a pad row onto row 0
    assert draws and new.stats["mixed_dispatches"] > 0
    assert any(rm is not None and len(set(rm)) < len(rm) for rm in draws)
    assert new.cache.pages_in_use == 0


# ------------------------------------------------------------------ #
# The card (-m cuda)
# ------------------------------------------------------------------ #


@pytest.mark.cuda
def test_cuda_scans_match_plain(cuda):
    for dtype in ("bfloat16", "int32"):
        k, v = _scan_pair(dtype)
        want = amb_ref.page_zero_scan_pair(k, v, torch.tensor(SCAN_PAGES))
        kc, vc = k.to(cuda), v.to(cuda)
        reset_launches()
        got = amb_ops.pim_page_zero_scan_pair(kc, vc, SCAN_PAGES)
        assert launch_counts()["page_zero_scan"] == 1
        assert got.tolist() == want.tolist() == SCAN_WANT, dtype
        for a, ac in ((k, kc), (v, vc)):
            single = amb_ops.pim_page_zero_scan(ac, SCAN_PAGES)
            assert single.device == ac.device
            assert torch.equal(single.cpu(), amb_ref.page_zero_scan(
                a, torch.tensor(SCAN_PAGES)))
        assert launch_counts()["page_zero_scan"] == 3
    # rows of 6 bytes (not a multiple of 16: the byte route), more pages
    # than the launch's parameters hold, then the same pair again with a
    # short list: the scratch each launch leaves must be zero
    rng = np.random.default_rng(15)
    P = 900
    k = torch.zeros((3, P, 3), dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    k[2, rng.choice(P, 200, replace=False), 2] = -0.0
    v[0, rng.choice(P, 200, replace=False), 0] = 1.0
    kc, vc = k.to(cuda), v.to(cuda)
    for pages in (rng.integers(0, P, INLINE_ROWS + 300), [5, 7, 5],
                  rng.integers(0, P, 64)):
        want = amb_ref.page_zero_scan_pair(k, v, torch.as_tensor(pages))
        got = amb_ops.pim_page_zero_scan_pair(kc, vc, pages)
        assert got.tolist() == want.tolist()
        single = amb_ops.pim_page_zero_scan(kc, pages)
        assert torch.equal(single.cpu(), amb_ref.page_zero_scan(
            k, torch.as_tensor(pages)))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_random_uniform_matches_plain(cuda):
    for seed, shape, rowmap in (((1, 2), (8, 1), [0, 1, 2, 3, 4, 5, 0, 0]),
                                ((0xFFFFFFFF, 7), (4096, 256), None),
                                ((5, 0x9E3779B9), (4096, 256),
                                 [4095, 0, 17, 17]),
                                ((3, 4), (300, 3), list(range(299, -1, -1)))):
        rm = None if rowmap is None else torch.tensor(rowmap, device=cuda)
        reset_launches()
        got = dr_ops.pim_random_uniform(seed, *shape, cuda, rowmap=rm)
        assert launch_counts()["random_u32"] == 1
        want = dr_ref.random_uniform(seed, *shape, CPU, rowmap=None if rm
                                     is None else rm.cpu())
        bits = dr_ops.pim_random_u32(seed, *shape, cuda).view(torch.int32)
        old = ((bits >> 8) & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
        if rm is not None:
            old = old[rm]
        torch.cuda.synchronize()
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
        assert torch.equal(got.view(torch.int32), old.view(torch.int32))
    assert dr_ops.pim_random_uniform((1, 2), 0, 1, cuda).shape == (0, 1)
    with pytest.raises(ValueError):
        dr_ops.pim_random_uniform((1, 2), 8, 1, cuda,
                                  rowmap=torch.zeros(8, dtype=torch.int32,
                                                     device=cuda))


@pytest.mark.cuda
def test_cuda_step_first_call_eager_second_captured(cuda):
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = reduced(ARCHS["granite-3-8b"], num_layers=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(T.model_defs(cfg), gen, cuda, torch.bfloat16)
    eng = E.PagedEngine(cfg, params, device=cuda, num_pages=64)
    rng = np.random.default_rng(16)
    for i in range(2):
        eng.submit(E.Request(i, rng.integers(0, cfg.vocab_size, 9)
                             .astype(np.int32), max_new_tokens=8,
                             temperature=0.0))
    cache = eng._steps
    eng.run(max_rounds=1)         # the prefill and a decode round: first uses
    assert cache.captured == 0 and cache.capture_seconds == 0.0
    assert cache.first_use_seconds > 0.0
    (step,) = [s for key, (s,) in cache._steps.items()
               if key[0] == "jit_traces"]
    assert step.calls == 1 and step.graph is None
    assert eng.stats["jit_traces"] == 1 and cache.due == 0
    torch.cuda.synchronize()
    # the round writes a slot no call reads: the same inputs give the
    # same logits, eager, captured and replayed
    eager = step.body(**step.inputs).clone()
    reset_launches()
    captured = step().clone()                   # the second use captures
    assert step.graph is not None and cache.captured == 1 == cache.due
    assert cache.capture_seconds > 0.0
    assert launch_counts() == {k: step.launches.get(k, 0) for k in LAUNCHES}
    replayed = step().clone()
    torch.cuda.synchronize()
    assert torch.equal(eager, captured) and torch.equal(eager, replayed)
    assert eng.stats["jit_traces"] == 1         # counted at first use only
    while eng.has_work:
        eng.run(max_rounds=1)
    assert eng.cache.pages_in_use == 0
