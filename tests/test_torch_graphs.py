"""The port's step cache (the decode round and the K-block round replayed
as CUDA graphs per shape bucket) and the two-arena RowClone launches.

On the CPU (where the port runs its plain versions and captures
nothing, but keeps the cache's keys and counts):

* the pair scatter's plain version against two calls of the JAX
  ``kv_scatter`` in interpret mode, bit for bit, pad-row duplicates
  included, and its refusal to convert what it is given;
* the pair page init's plain version against two calls of the JAX
  ``page_init_batched`` in interpret mode, bit for bit;
* the index-upload helper: the same indices back, out of range raises;
* the port engine against the JAX engine on one greedy workload that
  crosses a batch bucket (a late arrival) and a block-table-width
  bucket, with a fork of a live sequence and its free and 4-round
  K-blocks: ``stats["jit_traces"]`` and ``stats["block_jit_traces"]``
  equal the JAX engine's retrace counts, and the streams and every
  step's ``launches_by_kind`` delta equal JAX's (teacher-forced, with
  the harness of ``test_torch_prefix.py``).

On the card (``-m cuda``; JAX is imported only inside fixtures, so
these run with ``--noconftest`` where JAX is not installed):

* for dense, SSM, hybrid and MoE layouts at 2 layers (the hybrid one
  period), every token choice's logits with graphs on are bit-equal to
  those of the same engine with graphs off, and so are the streams,
  the launch deltas and the kernel launch counts;
* a replay after an in-place arena mutation reads the new contents;
* ``LAUNCHES`` after N replays is N times the captured delta, and the
  profiler's count of each kernel the card ran in them agrees;
* a replay against a swapped arena raises;
* the pair kernels match their plain versions bit for bit.

Tolerances: none; every comparison here is exact (page movement, bits,
counts and streams; the card's logits against the same card's).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.kernels import (LAUNCHES,  # noqa: E402
                                 device_kernel_counts, launch_counts,
                                 ran_on_device, reset_launches)
from repro_torch.kernels.rowclone import ops as rc_ops  # noqa: E402
from repro_torch.kernels.rowclone import ref as rc_ref  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402

CPU = torch.device("cpu")
# the layouts of the card tests: (arch, reduced() overrides)
FAMILIES = {"dense": ("granite-3-8b", dict(num_layers=2)),
            "ssm": ("mamba2-1.3b", dict(num_layers=2)),
            "hybrid": ("jamba-1.5-large-398b",
                       dict(num_layers=4, attn_every=4)),
            "moe": ("llama4-scout-17b-a16e", dict(num_layers=2))}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's RowClone kernels and references."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.rowclone import ref as rc_r, rowclone
    return types.SimpleNamespace(jnp=jnp, rc=rowclone, rc_ref=rc_r)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the CUDA kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _bf16(a: np.ndarray, device=CPU) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16).to(device)


def _scatter_inputs():
    """A (K, V) arena pair, a 5-row batch whose row 4 is a pad duplicate
    of row 0 (same slot, same payload)."""
    rng = np.random.default_rng(0)
    L, P, S, KVH, D, B = 2, 6, 4, 2, 8, 5
    arenas = [rng.normal(size=(L, P, S, KVH, D)).astype(np.float32)
              for _ in range(2)]
    news = [rng.normal(size=(L, B, KVH, D)).astype(np.float32)
            for _ in range(2)]
    for n in news:
        n[:, 4] = n[:, 0]
    pages = np.asarray([3, 1, 3, 5, 3], np.int32)
    slots = np.asarray([0, 2, 1, 3, 0], np.int32)
    return arenas, news, pages, slots


# ------------------------------------------------------------------ #
# CPU: the pair launches' plain versions against the JAX kernels
# ------------------------------------------------------------------ #


def test_pair_scatter_plain_matches_two_jax_scatters(jx):
    (ka, va), (kn, vn), pages, slots = _scatter_inputs()
    L, P, S = ka.shape[:3]
    B = pages.size
    k, v = _bf16(ka), _bf16(va)
    pg, sl = torch.from_numpy(pages), torch.from_numpy(slots)
    reset_launches()
    rc_ops.kv_scatter_pair_inline(k, v, pg, sl, _bf16(kn), _bf16(vn))
    assert set(launch_counts().values()) == {0}   # the plain version ran
    jp, js = jx.jnp.asarray(pages), jx.jnp.asarray(slots)
    for got, a, n in ((k, ka, kn), (v, va, vn)):
        a4 = jx.jnp.asarray(a, jx.jnp.bfloat16).reshape(L, P, S, -1)
        n3 = jx.jnp.asarray(n, jx.jnp.bfloat16).reshape(L, B, -1)
        want = jx.rc.kv_scatter(a4, jp, js, n3, interpret=True)
        np.testing.assert_array_equal(_bits(got).reshape(L, P, S, -1),
                                      _bits(want))
    # the wrapper converts nothing: a wrong dtype or layout raises
    with pytest.raises(TypeError):
        rc_ops.kv_scatter_pair_inline(k, v, pg.long(), sl, _bf16(kn),
                                      _bf16(vn))
    with pytest.raises(TypeError):
        rc_ops.kv_scatter_pair_inline(k, v, pg, sl,
                                      torch.from_numpy(kn), _bf16(vn))
    with pytest.raises(ValueError):
        rc_ops.kv_scatter_pair_inline(
            k, v, pg, sl, _bf16(kn).transpose(2, 3).contiguous()
            .transpose(2, 3), _bf16(vn))


@pytest.mark.parametrize("value", [0.0, 1.5])
def test_pair_init_plain_matches_two_jax_inits(jx, value):
    rng = np.random.default_rng(2)
    arenas = [rng.normal(size=(2, 6, 16)).astype(np.float32)
              for _ in range(2)]
    dst = [0, 3, 4]
    k, v = _bf16(arenas[0]), _bf16(arenas[1])
    rc_ops.pim_page_init_batched_pair(k, v, dst, value)
    d = jx.jnp.asarray(np.asarray(dst, np.int32))
    for got, a in ((k, arenas[0]), (v, arenas[1])):
        want = jx.rc.page_init_batched(jx.jnp.asarray(a, jx.jnp.bfloat16),
                                       d, value, block_cols=8,
                                       interpret=True)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    with pytest.raises(ValueError):
        rc_ops.pim_page_init_batched_pair(k, v[:, :5], dst, value)


def test_upload_index_returns_the_indices_and_checks_range():
    for idx in ([3, 0, 5], np.asarray([5, 5, 1], np.int64), [], (2,)):
        got = rc_ops.upload_index(idx, 6, "page", CPU)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(idx, np.int64).reshape(-1))
    for bad in ([0, 6], [-1, 2]):
        with pytest.raises(IndexError, match="page out of range"):
            rc_ops.upload_index(bad, 6, "page", CPU)


# ------------------------------------------------------------------ #
# CPU: the step cache's keys and counts against the JAX engine's jits
# ------------------------------------------------------------------ #


def _workload(cls):
    """Three greedy requests now and two after the first step (batch
    buckets 4, 8, 4, 2, 1); request 0 grows from 2 pages to 5 (table
    widths 2, 4 and 8)."""
    rng = np.random.default_rng(4)
    spec = [(28, 40), (9, 6), (14, 12), (17, 10), (5, 13)]
    reqs = [cls(i, rng.integers(0, 512, n).astype(np.int32),
                max_new_tokens=m, temperature=0.0)
            for i, (n, m) in enumerate(spec)]
    return reqs[:3], reqs[3:]


def _drive(engine, cls):
    """Serve the workload (requests of class ``cls``) step by step,
    alternating one decode round with a block of up to
    ``decode_block_rounds`` once nothing waits, so both steps meet every
    bucket: the late requests arrive after step 1, a live sequence forks
    after step 2 and its fork is freed after step 3.  Returns the
    results and every step's launch delta."""
    first, late = _workload(cls)
    for r in first:
        engine.submit(r)
    q = engine.cache.queue
    results, deltas, step = {}, [], 0
    while engine.has_work:
        rounds = (engine.decode_block_rounds
                  if engine.prefill_backlog_tokens() == 0 and step % 2
                  else 1)
        before = q.snapshot()
        results.update(engine.run(max_rounds=rounds))
        deltas.append(q.delta(before))
        step += 1
        if step == 1:
            for r in late:
                engine.submit(r)
        elif step == 2:
            rid = next(r for r in sorted(engine.active)
                       if engine.cache.seqs[r].length
                       % engine.cache.page_size)
            engine.cache.fork(rid, 1000)
        elif step == 3:
            engine.cache.free(1000)
    return results, deltas


def test_step_cache_counts_the_jax_retraces():
    pytest.importorskip("jax")
    import test_torch_prefix as H
    from repro.serving import engine as JE

    model = H.build_model()
    jcfg, cfg, jparams, params = model
    with H.recording() as calls:
        jeng = JE.PagedEngine(jcfg, jparams, use_pallas=False,
                              decode_block_rounds=4)
        jres, jdeltas = _drive(jeng, JE.Request)
    eng = H.Forced(cfg, params, device="cpu", ref_calls=calls,
                   decode_block_rounds=4)
    res, deltas = _drive(eng, E.Request)
    assert res == jres
    assert deltas == jdeltas
    for key in ("jit_traces", "block_jit_traces"):
        assert eng.stats[key] == jeng.stats[key], key
    # the workload crossed buckets: more than one key of each kind
    assert eng.stats["jit_traces"] > 1 and eng.stats["block_jit_traces"] > 1
    assert H.check_choices(eng, calls) > 0
    assert eng.cache.pages_in_use == 0 == jeng.cache.pages_in_use


# ------------------------------------------------------------------ #
# The card (-m cuda)
# ------------------------------------------------------------------ #


class Recording(E.PagedEngine):
    """Keeps every token choice's logits (a copy on the card)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.seen = []

    def _choose(self, logits, temps, seed, rowmap=None):
        self.seen.append(logits.clone())
        return super()._choose(logits, temps, seed, rowmap=rowmap)


def _card_model(fam, cuda):
    arch, kw = FAMILIES[fam]
    cfg = reduced(ARCHS[arch], **kw)
    gen = torch.Generator(device=cuda).manual_seed(0)
    return cfg, init_params(T.model_defs(cfg), gen, cuda, torch.bfloat16)


def _card_run(cfg, params, cuda, graphs):
    eng = Recording(cfg, params, device=cuda, num_pages=64,
                    decode_block_rounds=4, cuda_graphs=graphs)
    rng = np.random.default_rng(1)
    for i, (n, m) in enumerate(((7, 14), (19, 9), (3, 11))):
        eng.submit(E.Request(i, rng.integers(0, cfg.vocab_size, n)
                             .astype(np.int32), max_new_tokens=m,
                             temperature=0.0))
    q = eng.cache.queue
    reset_launches()
    results, deltas = {}, []
    while eng.has_work:
        before = q.snapshot()
        results.update(eng.run(max_rounds=eng.decode_block_rounds
                               if not eng.queue else 1))
        deltas.append(q.delta(before))
    torch.cuda.synchronize()
    return eng, results, deltas, launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_cuda_replayed_logits_equal_the_uncaptured_steps(cuda, fam):
    cfg, params = _card_model(fam, cuda)
    off = _card_run(cfg, params, cuda, graphs=False)
    on = _card_run(cfg, params, cuda, graphs=True)
    # a step is captured on its key's second use: every key met twice
    # has its graphs (two for a mixed key), no key met once has one
    assert on[0]._steps.captured == on[0]._steps.due > 0
    assert off[0]._steps.captured == 0
    assert on[1] == off[1]                    # streams
    assert on[2] == off[2]                    # launches_by_kind deltas
    assert on[3] == off[3]                    # kernel launches
    assert len(on[0].seen) == len(off[0].seen)
    for a, b in zip(on[0].seen, off[0].seen):
        assert torch.equal(a, b)
    for eng in (on[0], off[0]):
        assert eng.cache.pages_in_use == 0


def _captured_decode_step(cuda):
    """A dense engine mid-decode with its round's graph captured (on the
    round's second use) and replayed once; returns (engine, step)."""
    cfg, params = _card_model("dense", cuda)
    eng = E.PagedEngine(cfg, params, device=cuda, num_pages=64)
    rng = np.random.default_rng(2)
    for i in range(2):
        eng.submit(E.Request(i, rng.integers(0, cfg.vocab_size, 9)
                             .astype(np.int32), max_new_tokens=8,
                             temperature=0.0))
    # the prefill and the round's first use (eager), its capture (and
    # first replay), a replay
    for _ in range(3):
        eng.run(max_rounds=1)
    (step,) = [s for k, (s,) in eng._steps._steps.items()
               if k[0] == "jit_traces"]
    assert step.graph is not None
    return eng, step


@pytest.mark.cuda
def test_cuda_replay_reads_the_mutated_arena(cuda):
    eng, step = _captured_decode_step(cuda)
    # each call writes the round's slot, which no call reads: the same
    # inputs give the same logits until the arena's history changes
    before = step().clone()
    assert torch.equal(step(), before)
    eng.cache.k_arena.mul_(0.5)                    # in place: same address
    after = step().clone()
    assert not torch.equal(after, before)
    assert torch.equal(after, step.body(**step.inputs))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_launch_counts_are_replays_times_the_captured_delta(cuda):
    eng, step = _captured_decode_step(cuda)
    assert step.launches["kv_scatter"] == 1
    assert step.launches["paged_attention"] == eng.cfg.num_layers
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step()
        torch.cuda.synchronize()
    want = {k: 5 * step.launches.get(k, 0) for k in LAUNCHES}
    assert launch_counts() == want
    # and the card ran just those kernels: the profiler's count of each
    ran = ran_on_device(e for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA)
    assert ran == device_kernel_counts(want)


@pytest.mark.cuda
def test_cuda_replay_against_a_swapped_arena_raises(cuda):
    eng, step = _captured_decode_step(cuda)
    eng.cache.lib.buffers[0] = eng.cache.k_arena.clone()
    with pytest.raises(RuntimeError, match="arenas moved"):
        step()


@pytest.mark.cuda
def test_cuda_pair_kernels_match_plain(cuda):
    (ka, va), (kn, vn), pages, slots = _scatter_inputs()
    want_k, want_v = _bf16(ka), _bf16(va)
    rc_ref.kv_scatter_pair(want_k.view(*ka.shape[:3], -1),
                           want_v.view(*va.shape[:3], -1),
                           torch.from_numpy(pages), torch.from_numpy(slots),
                           _bf16(kn).view(*kn.shape[:2], -1),
                           _bf16(vn).view(*vn.shape[:2], -1))
    rc_ref.page_init_batched_pair(want_k, want_v, torch.tensor([1, 4]), 0.5)
    k, v = _bf16(ka, cuda), _bf16(va, cuda)
    reset_launches()
    rc_ops.kv_scatter_pair_inline(
        k, v, rc_ops.upload_index(pages, 6, "page", cuda),
        rc_ops.upload_index(slots, 4, "slot", cuda), _bf16(kn, cuda),
        _bf16(vn, cuda))
    rc_ops.pim_page_init_batched_pair(k, v, [1, 4], 0.5)
    torch.cuda.synchronize()
    assert torch.equal(k.cpu(), want_k) and torch.equal(v.cpu(), want_v)
    assert launch_counts()["kv_scatter"] == 1
    assert launch_counts()["page_init_batched"] == 1
    # a page list too long for the launch's parameters is uploaded
    n = rc_ops.INLINE_ROWS + 88
    arena = torch.randn((2, n + 12, 24), dtype=torch.bfloat16)
    dst = np.random.default_rng(3).permutation(n + 12)[:n]
    want = rc_ref.page_init_batched(arena.clone(), torch.from_numpy(dst),
                                    -1.0)
    got = rc_ops.pim_page_init_batched(arena.to(cuda), dst, -1.0)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
