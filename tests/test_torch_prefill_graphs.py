"""The prefill batch, the chunk step and the mixed round as steps of the
port's step cache, and the RowClone flat movers (``copy_2d``/``init_2d``)
on their bulk route.

On the CPU (the port runs its plain versions and captures nothing, but
keeps the cache's keys and counts), against the JAX engine on the same
inputs:

* ``stats["prefill_jit_traces"]`` after each step of the workloads of
  ``test_prefill.py::TestPrefillRetrace`` (a burst of six prompts over
  two buckets, then the same burst again; lengths 7, 8, 9 one at a
  time), each followed by two prompts at once (a batch bucket of its
  own), and of ``test_no_new_trace_per_chunk_count`` (prompts of 17, 25
  and 17 tokens in 8-token chunks) equals the JAX engine's retraces;
* a chunked workload with decode rows present (mixed rounds, K-blocks,
  sampled rows, a prompt fully covered by a shared prefix, so a chunk
  batch that writes no KV; then a long prompt's chunks beside one
  decode row whose table widens, so mixed keys that differ only there)
  on a dense and a pure-SSM model:
  ``stats["mixed_jit_traces"]`` and every other retrace counter equal
  JAX's, and so do the streams (teacher-forced, with the harness of
  ``test_torch_prefix.py``), every step's ``launches_by_kind`` delta,
  ``rng_ctr`` and the pages in use at the end.

On the card (``-m cuda``; JAX is imported only inside the CPU tests'
bodies, so these run with ``--noconftest`` where JAX is not installed):

* a chunked workload (mixed rounds, K-blocks, a no-write chunk, late
  arrivals, sampled rows) on dense, SSM and hybrid layouts: every token
  choice's logits with graphs on are bit-equal to those with graphs
  off, and so are the streams, the launch deltas and the kernel launch
  counts; every key met twice captured its graphs (two for a mixed
  key), and no key met once did;
* a replayed chunk half reads the arena as mutated after its capture;
* the profiler's count of each kernel the card ran in a replayed mixed
  round equals the launches the round counted (its two replays'
  recorded deltas and the eager token choice's);
* ``pim_copy`` / ``pim_init`` and the raw entry points equal their plain
  versions at odd byte counts, unaligned views, equal misalignments of
  source and destination (the bulk route's ragged head), and sizes that
  leave a ragged tail, in 1-, 2- and 4-byte dtypes.

Tolerances: none; every comparison here is exact (counts, streams,
bits; the card's logits against the same card's).
"""

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

TRACE_KEYS = ("jit_traces", "block_jit_traces", "prefill_jit_traces",
              "mixed_jit_traces")
# the chunked path of both engines: 4-token pages, 8-token chunks
CHUNKED = dict(page_size=4, num_pages=64, max_prefill_chunk=8,
               mixed_rounds=True, decode_block_rounds=4)
# the layouts of the card tests: (arch, reduced() overrides)
CARD_FAMILIES = {"dense": ("granite-3-8b", dict(num_layers=2)),
                 "ssm": ("mamba2-1.3b", dict(num_layers=2)),
                 "hybrid": ("jamba-1.5-large-398b",
                            dict(num_layers=4, attn_every=4))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the CUDA kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


# ------------------------------------------------------------------ #
# CPU: the prefill and chunk keys against the JAX engine's retraces
# ------------------------------------------------------------------ #


def _engines(**kw):
    """The JAX engine and the port's on the same 2-layer granite
    weights (``test_torch_prefix.build_model``), each with ``kw``; the
    port's with ``port_kw`` on top."""
    pytest.importorskip("jax")
    import test_torch_prefix as H
    from repro.serving import engine as JE

    jcfg, cfg, jparams, params = H.build_model()
    port_kw = kw.pop("port_kw", {})
    return ((JE.PagedEngine(jcfg, jparams, use_pallas=False, **kw),
             JE.Request),
            (E.PagedEngine(cfg, params, device="cpu", **kw, **port_kw),
             E.Request))


def _traces_per_step(pairs, steps):
    """Run ``steps`` (functions ``(engine, Request) -> None``) on both
    engines; the ``prefill_jit_traces`` after each, per engine."""
    out = []
    for eng, cls in pairs:
        seen = []
        for step in steps:
            step(eng, cls)
            seen.append(eng.stats["prefill_jit_traces"])
        eng.run()                   # drain, so the arena frees cleanly
        assert eng.cache.pages_in_use == 0
        out.append(seen)
    return out


@pytest.mark.parametrize("workload", ["burst_and_rerun", "growth_7_8_9"])
def test_prefill_traces_match_jax(workload):
    pairs = _engines(page_size=4, num_pages=128)
    vocab = pairs[1][0].cfg.vocab_size
    if workload == "burst_and_rerun":
        # lengths 5-8 share the 8-bucket (batch 4), 9 and 12 the
        # 16-bucket (batch 2); the same burst again compiles nothing;
        # then 5 and 6 alone: the 8-bucket at batch 2
        lengths = (5, 6, 7, 8, 9, 12) * 2 + (5, 6)
        groups = [range(0, 6), range(6, 12), range(12, 14)]
    else:
        # 7 and 8 share a bucket, 9 crosses it, then 7 and 8 together
        lengths = (7, 8, 9, 7, 8)
        groups = [range(0, 1), range(1, 2), range(2, 3), range(3, 5)]
    prompts = _prompts(vocab, lengths, 0)

    def batch(ids):
        def step(eng, cls):
            for i in ids:
                eng.submit(cls(i, prompts[i], max_new_tokens=1,
                               temperature=0.0))
            eng._prefill_round()
        return step

    jax_seen, port_seen = _traces_per_step(pairs, [batch(g)
                                                   for g in groups])
    assert port_seen == jax_seen
    assert port_seen == ([2, 2, 3] if workload == "burst_and_rerun"
                         else [1, 1, 2, 3])
    for key in ("jit_traces", "block_jit_traces", "mixed_jit_traces",
                "fused_prefill_dispatches"):
        assert pairs[1][0].stats[key] == pairs[0][0].stats[key], key


def test_chunk_traces_match_jax_and_not_the_chunk_count():
    # the JAX test drives its ticks without mixing: the port's engine
    # mixes only when built to
    pairs = _engines(page_size=4, num_pages=256, max_prefill_chunk=8,
                     port_kw=dict(mixed_rounds=False))
    prompts = _prompts(pairs[1][0].cfg.vocab_size, (17, 25, 17), 2)

    def chunked(i):
        def step(eng, cls):
            eng.submit(cls(i, prompts[i], max_new_tokens=1,
                           temperature=0.0))
            while eng.queue or eng._chunk_q:
                eng._prefill_tick()
        return step

    jax_seen, port_seen = _traces_per_step(pairs, [chunked(i)
                                                   for i in range(3)])
    assert port_seen == jax_seen
    assert port_seen[0] == port_seen[1] == port_seen[2]
    assert pairs[1][0].stats["prefill_chunks"] == \
        pairs[0][0].stats["prefill_chunks"]


# ------------------------------------------------------------------ #
# CPU: the mixed round's key against the JAX engine, teacher-forced
# ------------------------------------------------------------------ #


def _mixed_waves(vocab):
    """Two waves.  The first: a 16-token prompt, three more of 10-21
    tokens (odd ids sampled), and a sharer fully covered by the first
    prompt's pages (one chunk that writes no KV).  The second: an
    8-token prompt that decodes 24 tokens while a 64-token prompt
    streams in 8 chunks beside it, its table widening from 2 to 8 pages
    (mixed keys that differ only in the decode table's width)."""
    rng = np.random.default_rng(10)
    first = rng.integers(0, vocab, 16).astype(np.int32)
    wave = [lambda cls, p=first: cls(0, p, max_new_tokens=7,
                                     temperature=0.0)]
    for i, n in enumerate((13, 21, 10)):
        p = rng.integers(0, vocab, n).astype(np.int32)
        wave.append(lambda cls, r=i + 1, p=p, t=float(i % 2):
                    cls(r, p, max_new_tokens=6, temperature=t))
    wave.append(lambda cls, p=first: cls(
        9, p.copy(), max_new_tokens=5, temperature=0.0, share_with=0,
        shared_len=16))
    short, long = (rng.integers(0, vocab, n).astype(np.int32)
                   for n in (8, 64))
    return [wave, [lambda cls: cls(100, short, max_new_tokens=24,
                                   temperature=0.0),
                   lambda cls: cls(101, long, max_new_tokens=3,
                                   temperature=1.0)]]


@pytest.mark.parametrize("fam", ["dense", "ssm"])
def test_mixed_traces_match_jax(fam):
    pytest.importorskip("jax")
    import test_torch_prefix as H

    if fam == "dense":
        m = H.build_model()
    else:
        import test_torch_hybrid as HY
        m = HY.model("ssm")
    jeng, jrun, eng, run, calls = H.run_both(
        m, _mixed_waves(m[1].vocab_size), **CHUNKED)
    assert run["results"] == jrun["results"]
    assert run["deltas"] == jrun["deltas"]
    for key in TRACE_KEYS:
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.stats["mixed_jit_traces"] >= 2
    assert eng.stats["mixed_dispatches"] == jeng.stats["mixed_dispatches"]
    assert eng.rng_ctr == jeng.rng_ctr
    assert H.check_choices(eng, calls) >= 1
    assert eng.cache.pages_in_use == 0 == jeng.cache.pages_in_use
    if fam == "dense":
        # the covered sharer ran a chunk batch that writes no KV
        assert any(v is False for k in eng._steps._steps for v in k)


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
    import dataclasses

    arch, kw = CARD_FAMILIES[fam]
    cfg = reduced(ARCHS[arch], **kw)
    if cfg.ssm is not None:          # 8-token chunks: SSD chunks of 4
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk_size=4))
    gen = torch.Generator(device=cuda).manual_seed(0)
    return cfg, init_params(T.model_defs(cfg), gen, cuda, torch.bfloat16)


def _card_requests(cfg):
    """Requests 0-1 now, 2-4 after the first step: request 4 shares all
    of request 0's 16-token prompt (a chunk that writes no KV)."""
    prompts = _prompts(cfg.vocab_size, (16, 11, 26, 7), 3)
    reqs = [E.Request(i, p, max_new_tokens=9, temperature=float(i % 2))
            for i, p in enumerate(prompts)]
    reqs.append(E.Request(4, prompts[0].copy(), max_new_tokens=6,
                          temperature=0.0, share_with=0, shared_len=16))
    return reqs[:2], reqs[2:]


def _card_chunked_run(cfg, params, cuda, graphs, *, profile_mixed=False):
    """Serve :func:`_card_requests` step by step.  With
    ``profile_mixed``, profile the first mixed round that replays graphs
    captured before it and return the kernels it ran and counted."""
    eng = Recording(cfg, params, device=cuda, cuda_graphs=graphs,
                    **CHUNKED)
    first, late = _card_requests(cfg)
    for r in first:
        eng.submit(r)
    q = eng.cache.queue
    reset_launches()
    results, deltas, step, profiled = {}, [], 0, None
    while eng.has_work:
        rounds = (eng.decode_block_rounds
                  if eng.prefill_backlog_tokens() == 0 else 1)
        before = q.snapshot()
        misses = eng.stats["mixed_jit_traces"]
        graphs = eng._steps.captured
        watch = profile_mixed and profiled is None and graphs > 0
        if watch:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            counted = launch_counts()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                results.update(eng.run(max_rounds=rounds))
                torch.cuda.synchronize()
        else:
            results.update(eng.run(max_rounds=rounds))
        deltas.append(q.delta(before))
        # a replay: no new key and no capture in the round
        if (watch and deltas[-1].get("fused_mixed")
                and eng.stats["mixed_jit_traces"] == misses
                and eng._steps.captured == graphs):
            from torch.autograd import DeviceType

            ran = ran_on_device(e for e in prof.key_averages()
                                if e.device_type == DeviceType.CUDA)
            profiled = (ran, device_kernel_counts(
                {k: LAUNCHES[k] - counted[k] for k in LAUNCHES}))
        step += 1
        if step == 1:
            for r in late:
                eng.submit(r)
    torch.cuda.synchronize()
    return eng, results, deltas, launch_counts(), profiled


@pytest.mark.cuda
@pytest.mark.parametrize("fam", list(CARD_FAMILIES))
def test_cuda_replayed_chunk_and_mixed_logits_equal_uncaptured(cuda, fam):
    cfg, params = _card_model(fam, cuda)
    off = _card_chunked_run(cfg, params, cuda, graphs=False)
    on = _card_chunked_run(cfg, params, cuda, graphs=True)
    st = on[0].stats
    assert st["mixed_jit_traces"] >= 1 and st["prefill_jit_traces"] >= 1
    # captured on a key's second use: two graphs for a mixed key
    assert on[0]._steps.captured == on[0]._steps.due > 0
    assert off[0]._steps.captured == 0
    for key in TRACE_KEYS:
        assert on[0].stats[key] == off[0].stats[key], key
    assert on[1] == off[1]                    # streams
    assert on[2] == off[2]                    # launches_by_kind deltas
    assert on[3] == off[3]                    # kernel launches
    assert len(on[0].seen) == len(off[0].seen)
    for a, b in zip(on[0].seen, off[0].seen):
        assert torch.equal(a, b)
    for eng in (on[0], off[0]):
        assert eng.cache.pages_in_use == 0


@pytest.mark.cuda
def test_cuda_replayed_chunk_half_reads_the_mutated_arena(cuda):
    cfg, params = _card_model("dense", cuda)
    eng = E.PagedEngine(cfg, params, device=cuda, **CHUNKED)
    for i, p in enumerate(_prompts(cfg.vocab_size, (30, 30), 4)):
        eng.submit(E.Request(i, p, max_new_tokens=4, temperature=0.0))
    # chunk steps until one is captured (its key's second use): a
    # chunk's prefix is committed KV
    step = None
    while step is None:
        eng.run(max_rounds=1)
        step = next((s for k, (s,) in eng._steps._steps.items()
                     if k[:2] == ("prefill_jit_traces", "chunk")
                     and s.graph is not None), None)
    # the chunk's own slots lie past its prefix: a replay on the same
    # inputs rewrites them with the same values and reads the same
    before = step().clone()
    assert torch.equal(step(), before)
    eng.cache.k_arena.mul_(0.5)                  # in place: same address
    after = step().clone()
    assert not torch.equal(after, before)
    assert torch.equal(after, step.body(**step.inputs))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_replayed_mixed_round_ran_as_counted(cuda):
    cfg, params = _card_model("dense", cuda)
    eng, _, deltas, _, profiled = _card_chunked_run(
        cfg, params, cuda, graphs=True, profile_mixed=True)
    assert profiled is not None, "no replayed mixed round was profiled"
    ran, counted = profiled
    assert ran == counted
    assert counted["paged_split_kernel"] == cfg.num_layers
    assert counted["flash_(tc|simt)_kernel"] == cfg.num_layers


def _bytes_of(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16,
                                   torch.float32])
def test_cuda_flat_movers_match_plain(cuda, dtype):
    from repro_torch.kernels import _build

    es = torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator(device=cuda).manual_seed(7)
    base = torch.randint(-100, 100, ((5 << 20) // es + 64,),
                         generator=gen, device=cuda).to(dtype)
    # odd lengths, below and above the bulk route's size, ragged tails
    sizes = (1, 7, 1001, (1 << 20) // es + 3, (3 << 20) // es + 5)
    for n in sizes:
        for off in (0, 1, 3, 8):            # views off 16-byte alignment
            src = base[off:off + n]
            got = rc_ops.pim_copy(src)
            assert torch.equal(_bytes_of(got), _bytes_of(rc_ref.copy_2d(src)))
        for value in (0, -3, 2.5):
            got = rc_ops.pim_init((n,), value, dtype, device=cuda)
            want = rc_ref.init_2d((n,), value, dtype, cuda)
            assert torch.equal(_bytes_of(got), _bytes_of(want))
    # the raw entry points: source and destination off 16 bytes by the
    # same amount take the bulk route with a ragged head
    lib = _build.load("rowclone")
    raw = base.view(torch.uint8)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for nbytes in ((2 << 20) + 5, (4 << 20) + 13):
        for off in (1, 5, 8, 15):
            dst = torch.zeros(nbytes + 32, dtype=torch.uint8, device=cuda)
            assert lib.rc_copy_flat(raw.data_ptr() + off,
                                    dst.data_ptr() + off, nbytes,
                                    stream) == 0
            assert torch.equal(dst[off:off + nbytes], raw[off:off + nbytes])
            assert not dst[:off].any() and not dst[off + nbytes:].any()
            pattern = rc_ops.fill_pattern(-3, dtype)
            dst.zero_()
            assert lib.rc_fill_flat(dst.data_ptr() + off, nbytes, pattern,
                                    stream) == 0
            word = np.asarray([pattern], np.uint32).view(np.uint8)
            want = torch.from_numpy(np.resize(word, nbytes)).to(cuda)
            assert torch.equal(dst[off:off + nbytes], want)
            assert not dst[:off].any() and not dst[off + nbytes:].any()
    torch.cuda.synchronize()
