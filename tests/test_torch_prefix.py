"""The radix prefix cache of the port against the JAX package's.

Tree level: the port's ``RadixPrefixCache`` (a copy of the JAX
package's) and the JAX one run the same scripts side by side — the
cases of ``tests/test_prefix_cache.py`` and its property test against a
brute-force oracle — and must agree on every match, insert count,
eviction, indexed page list and refcount ledger.

Engine level: both engines serve the workloads of
``tests/test_prefix_cache.py`` on ``reduced(granite-3-8b,
num_layers=2)`` with the JAX weights converted: two prompts sharing
three pages, a hundred requests of one system prompt, twelve prompts
through a 16-page arena (LRU eviction), and a chunked prompt committed
chunk by chunk then hit in full.  Each wave of requests runs to the end
step by step, and ``clear_prefix()`` closes the run.  The JAX engine
runs first and every token choice it makes is recorded by its seed; the
port then takes each choice from that record (teacher forcing), so both
see the same inputs.  Held equal: the streams, every step's
``launches_by_kind`` delta (``clear_prefix`` included), ``saved_by_kind``,
the prefix counters of engine and cache, the indexed page ids after each
wave (the allocator is a copy, so ids are deterministic), 0 pages in use
and all-zero arenas after ``clear_prefix()``.  Held at tolerance: the
logits of every choice (``LOGIT_ATOL``, as in ``test_torch_chunked.py``),
and the port's own greedy choice must be the JAX token wherever the JAX
top-1/top-2 margin exceeds twice the row's logit difference.

The harness (:func:`run_both`, :func:`check_choices`) is shared with
``test_torch_ambit.py`` and ``test_torch_server.py``.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # pragma: no cover
    from _compat import given, settings, st

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.prefix_cache import RadixPrefixCache as JTree  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from repro_torch.serving.prefix_cache import RadixPrefixCache  # noqa: E402

LOGIT_ATOL = 0.1
PS = 4            # page size for the pure-trie tests
PREFIX_KEYS = ("prefix_hits", "prefix_hit_tokens", "prefix_evictions")


def build_model():
    """``reduced(granite-3-8b, num_layers=2)`` in both packages, the JAX
    weights from ``PRNGKey(0)`` and the port's converted bit for bit."""
    jcfg = jreduced(JARCHS["granite-3-8b"], num_layers=2)
    cfg = reduced(ARCHS["granite-3-8b"], num_layers=2)
    jparams = jinit(JT.model_defs(jcfg), jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def model():
    return build_model()


# ------------------------------------------------------------------ #
# The tree
# ------------------------------------------------------------------ #


def _trees():
    """The port's tree and the JAX one over fake pages, each with its
    own observable refcount ledger."""
    out = []
    for cls in (RadixPrefixCache, JTree):
        rc = {}

        def retain(p, rc=rc):
            rc[p] = rc.get(p, 0) + 1

        def release(p, rc=rc):
            rc[p] -= 1

        out.append((cls(PS, retain=retain, release=release), rc))
    return out


def _both(trees, fn, *args):
    """Apply one call to both trees; they must return the same."""
    got = [getattr(t, fn)(*args) for t, _ in trees]
    assert got[0] == got[1], (fn, args, got)
    return got[0]


def _same_state(trees):
    (a, rca), (b, rcb) = trees
    assert a.pages_indexed() == b.pages_indexed()
    assert a.stats == b.stats
    assert rca == rcb


def _case_full_page_prefix(trees):
    toks = [1, 2, 3, 4, 5, 6, 7, 8, 9]          # 2 full pages + tail
    assert _both(trees, "match", toks) == []
    assert _both(trees, "insert", toks, [10, 11, 12]) == 2
    assert _both(trees, "match", toks) == [10, 11]
    assert _both(trees, "match", [1, 2, 3, 4, 99, 0, 0, 0]) == [10]
    assert _both(trees, "match", [9, 9, 9, 9]) == []
    assert trees[0][1] == {10: 1, 11: 1}


def _case_first_committer(trees):
    _both(trees, "insert", [1, 2, 3, 4], [10])
    assert _both(trees, "insert", [1, 2, 3, 4, 5, 6, 7, 8], [20, 21]) == 1
    assert _both(trees, "match", [1, 2, 3, 4, 5, 6, 7, 8]) == [10, 21]
    assert trees[0][1] == {10: 1, 21: 1}


def _case_lru_leaves_first(trees):
    _both(trees, "insert", [1, 2, 3, 4, 5, 6, 7, 8], [10, 11])
    _both(trees, "insert", [9, 9, 9, 9], [12])
    _both(trees, "match", [1, 2, 3, 4, 5, 6, 7, 8])
    assert _both(trees, "evict_lru", 1) == 1
    assert sorted(trees[0][0].pages_indexed()) == [10, 11]
    assert _both(trees, "evict_lru", 1) == 1
    assert trees[0][0].pages_indexed() == [10]
    assert _both(trees, "evict_all") == 1
    assert all(v == 0 for v in trees[0][1].values())
    assert trees[0][0].n_nodes == 0


@pytest.mark.parametrize("case", [_case_full_page_prefix,
                                  _case_first_committer,
                                  _case_lru_leaves_first],
                         ids=lambda f: f.__name__[6:])
def test_radix_tree_cases_match_jax(case):
    trees = _trees()
    case(trees)
    _same_state(trees)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6),
       n_prompts=st.integers(min_value=1, max_value=10))
def test_match_is_longest_committed_prefix_as_jax(seed, n_prompts):
    """Against a brute-force oracle and the JAX tree: match() returns
    the longest full-page prefix shared with any committed prompt, with
    the right token content, both trees agree call for call, the LRU
    clocks drain the tree leaf by leaf in the same order, and every
    reference releases."""
    rng = np.random.default_rng(seed)
    trees = _trees()
    committed, content, next_page = [], {}, 0
    for _ in range(n_prompts):
        if committed and rng.random() < 0.6:
            base = list(committed[int(rng.integers(len(committed)))])
            keep = int(rng.integers(0, len(base) + 1))
            toks = base[:keep] + [int(t) for t in rng.integers(
                0, 4, int(rng.integers(0, 10)))]
        else:
            toks = [int(t) for t in rng.integers(0, 4,
                                                 int(rng.integers(1, 14)))]
        if not toks:
            continue
        exp = 0
        for c in committed:
            m = 0
            while ((m + 1) * PS <= min(len(c), len(toks))
                   and c[m * PS:(m + 1) * PS] == toks[m * PS:(m + 1) * PS]):
                m += 1
            exp = max(exp, m)
        got = _both(trees, "match", toks)
        assert len(got) == exp, (toks, committed)
        for j, page in enumerate(got):
            assert content[page] == tuple(toks[j * PS:(j + 1) * PS])
        n_full = len(toks) // PS
        pages = got + list(range(next_page, next_page + n_full - exp))
        next_page += n_full - exp
        for j in range(exp, n_full):
            content[pages[j]] = tuple(toks[j * PS:(j + 1) * PS])
        _both(trees, "insert", toks, pages)
        committed.append(toks)
        _same_state(trees)
    # drain leaf by leaf: the LRU clocks pick the same leaf every time
    while _both(trees, "evict_lru", 1):
        _same_state(trees)
    assert all(v == 0 for v in trees[0][1].values())


# ------------------------------------------------------------------ #
# The engines (harness shared with test_torch_ambit / test_torch_server)
# ------------------------------------------------------------------ #


class Forced(E.PagedEngine):
    """The port's engine with every token taken from the reference's
    choice of the same seed; records its own choices' inputs.  A seed
    the reference never drew is a block round after every row stopped
    (the port runs it masked; the JAX loop exits early)."""

    def __init__(self, *a, ref_calls, **kw):
        super().__init__(*a, **kw)
        self.ref_calls = ref_calls
        self.calls = []

    def _choose(self, logits, temps, seed, rowmap=None):
        self.calls.append((seed, logits.float().numpy(), np.asarray(temps)))
        ref = self.ref_calls.get(seed)
        if ref is None:
            return torch.argmax(logits, dim=-1)
        return torch.from_numpy(ref[2].astype(np.int64))


def drive(engine, waves, *, setup=None):
    """Serve ``waves`` (lists of functions ``cls -> Request``) one
    after another, each to the end, one step at a time as the serve loop
    steps (up to ``decode_block_rounds`` rounds when nothing waits for
    admission), then ``clear_prefix()``.  Returns the results, every
    step's launch delta, the indexed pages after each wave, the prefix
    counters of engine and cache before ``clear_prefix`` and the number
    of nodes it evicted."""
    if setup is not None:
        setup(engine)
    q = engine.cache.queue
    cls = E.Request if isinstance(engine, E.PagedEngine) else JE.Request
    results, deltas, indexed = {}, [], []
    for wave in waves:
        for make in wave:
            engine.submit(make(cls))
        while engine.has_work:
            rounds = (engine.decode_block_rounds
                      if engine.prefill_backlog_tokens() == 0 else 1)
            before = q.snapshot()
            results.update(engine.run(max_rounds=rounds))
            deltas.append(q.delta(before))
        indexed.append(list(engine.cache.prefix.pages_indexed())
                       if engine.cache.prefix is not None else [])
    counters = {"engine": {k: engine.stats[k] for k in PREFIX_KEYS},
                "cache": {k: engine.cache.stats[k] for k in PREFIX_KEYS}}
    before = q.snapshot()
    cleared = engine.cache.clear_prefix()
    deltas.append(q.delta(before))
    return dict(results=results, deltas=deltas, indexed=indexed,
                counters=counters, cleared=cleared)


@contextlib.contextmanager
def recording():
    """Record every token choice of the JAX engines built inside: yields
    a dict mapping each dispatch's seed to (logits, temps, tokens)."""
    calls = {}

    def record(logits, temps, seed, tokens):
        calls[tuple(int(w) for w in np.asarray(seed))] = (
            np.asarray(logits, np.float32), np.asarray(temps),
            np.asarray(tokens))

    orig = JE._select_tokens

    def select(logits, temps, seed, **kw):
        tokens = orig(logits, temps, seed, **kw)
        jax.debug.callback(record, logits, temps, seed, tokens)
        return tokens

    mp = pytest.MonkeyPatch()
    mp.setattr(JE, "_select_tokens", select)
    try:
        yield calls
    finally:
        mp.undo()


def run_both(model, waves, *, setup=None, **engine_kw):
    """The JAX engine, then the port teacher-forced by its record, on
    the same waves.  Returns ``(jax_engine, jax_run, port_engine,
    port_run, calls)``; ``calls`` maps each JAX seed to (logits, temps,
    tokens)."""
    jcfg, cfg, jparams, params = model
    with recording() as calls:
        jeng = JE.PagedEngine(jcfg, jparams, use_pallas=False, **engine_kw)
        jrun = drive(jeng, waves, setup=setup)
    eng = Forced(cfg, params, device="cpu", ref_calls=calls, **engine_kw)
    run = drive(eng, waves, setup=setup)
    return jeng, jrun, eng, run, calls


def check_choices(eng, calls):
    """Every choice the reference made was made by the port on logits
    within LOGIT_ATOL, with the same temperatures; the port's own greedy
    choice is the JAX token wherever the JAX margin exceeds twice the
    row's logit difference.  Returns the number of choices so held."""
    seen = {c[0] for c in eng.calls}
    assert set(calls) <= seen
    held = 0
    for seed, logits, temps in eng.calls:
        if seed not in calls:
            continue
        r_logits, r_temps, r_tokens = calls[seed]
        np.testing.assert_array_equal(temps, r_temps)
        np.testing.assert_allclose(logits, r_logits, atol=LOGIT_ATOL)
        for b in range(logits.shape[0]):
            if temps[b] != 0.0:
                continue
            d = float(np.abs(logits[b] - r_logits[b]).max())
            top2 = np.sort(r_logits[b])[-2:]
            if top2[1] - top2[0] > 2 * d:
                assert int(np.argmax(logits[b])) == int(r_tokens[b]), seed
                held += 1
    return held


def assert_same_run(jeng, jrun, eng, run, keys=PREFIX_KEYS):
    assert run["results"] == jrun["results"]
    assert run["deltas"] == jrun["deltas"]
    assert run["indexed"] == jrun["indexed"]
    assert run["counters"] == jrun["counters"]
    assert run["cleared"] == jrun["cleared"]
    q, jq = eng.cache.queue, jeng.cache.queue
    assert q.saved_by_kind == jq.saved_by_kind
    for k in keys:
        assert eng.cache.stats[k] == jeng.cache.stats[k], k
    for k in PREFIX_KEYS:
        assert eng.stats[k] == jeng.stats[k], k
    assert eng.cache.pages_in_use == 0 == jeng.cache.pages_in_use
    assert torch.count_nonzero(eng.cache.k_arena) == 0
    assert torch.count_nonzero(eng.cache.v_arena) == 0


def _req(rid, prompt, n, **kw):
    return lambda cls: cls(rid, prompt, max_new_tokens=n, temperature=0.0,
                           **kw)


def _workload(name, vocab):
    """(waves, engine kwargs) of ``tests/test_prefix_cache.py``'s
    engine cases."""
    rng = np.random.default_rng(0)
    if name == "radix":                  # two prompts sharing 12 of 16
        p0 = rng.integers(0, vocab, 16).astype(np.int32)
        p1 = p0.copy()
        p1[-4:] = rng.integers(0, vocab, 4)
        return ([[_req(0, p0, 3)], [_req(1, p1, 3)]],
                dict(page_size=4, num_pages=64, prefix_cache=True))
    if name == "dedupe":                 # 100 requests of one prompt
        sys_prompt = rng.integers(0, vocab, 8).astype(np.int32)
        return ([[_req(i, sys_prompt, 1)] for i in range(100)],
                dict(page_size=4, num_pages=64, prefix_cache=True))
    if name == "lru":                    # 12 x 2 pages through 16 pages
        prompts = [rng.integers(0, vocab, 8).astype(np.int32)
                   for _ in range(12)]
        return ([[_req(i, p, 1)] for i, p in enumerate(prompts)],
                dict(page_size=4, num_pages=16, prefix_cache=True))
    assert name == "chunked"             # committed by chunks, then hit
    prompt = rng.integers(0, vocab, 20).astype(np.int32)
    return ([[_req(0, prompt, 2)], [_req(1, prompt, 2)]],
            dict(page_size=4, num_pages=64, max_prefill_chunk=8,
                 prefix_cache=True))


_RUNS = {}


def _run(model, name):
    if name not in _RUNS:
        waves, kw = _workload(name, model[1].vocab_size)
        _RUNS[name] = run_both(model, waves, **kw)
    return _RUNS[name]


@pytest.mark.parametrize("name", ["radix", "dedupe", "lru", "chunked"])
def test_prefix_engine_matches_jax(model, name):
    jeng, jrun, eng, run, calls = _run(model, name)
    assert_same_run(jeng, jrun, eng, run)
    assert check_choices(eng, calls) >= 1
    st_ = eng.stats
    if name == "radix":
        assert st_["prefix_hits"] == 1 and st_["prefix_hit_tokens"] == 12
        assert eng.cache.queue.saved_by_kind["kv_write"] == 12
    elif name == "dedupe":
        assert st_["prefix_hits"] == 99
        assert st_["prefix_hit_tokens"] / 800 > 0.9
        assert run["indexed"][-1] and len(run["indexed"][-1]) == 2
    elif name == "lru":
        assert st_["prefix_evictions"] > 0
        assert max(len(p) for p in run["indexed"]) <= 16
    else:
        assert st_["prefix_hits"] == 1 and st_["prefix_hit_tokens"] == 20
        assert st_["decode_stall_rounds"] == 0
        assert run["results"][0] == run["results"][1]


def test_radix_matches_pairwise_oracle(model):
    """Radix-matched sharing against the pairwise ``share_with`` oracle
    on the port alone: the same streams and hit accounting."""
    _, cfg, _, params = model
    waves, kw = _workload("radix", cfg.vocab_size)
    (p0,), (p1,) = [[w(E.Request).prompt for w in wave] for wave in waves]
    pair = E.PagedEngine(cfg, params, page_size=4, num_pages=64,
                         device="cpu")
    pair.submit(E.Request(0, p0, max_new_tokens=3, temperature=0.0))
    pair.submit(E.Request(1, p1, max_new_tokens=3, temperature=0.0,
                          share_with=0, shared_len=12))
    res_pair = pair.run()
    radix = E.PagedEngine(cfg, params, device="cpu", **kw)
    res_radix = drive(radix, waves)["results"]
    assert res_radix == res_pair
    for k in ("prefix_hits", "prefix_hit_tokens"):
        assert radix.stats[k] == pair.stats[k]
    assert pair.cache.pages_in_use == 0 == radix.cache.pages_in_use


def test_pairwise_api_warns_deprecation_with_prefix_cache(model):
    _, cfg, _, params = model
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               8).astype(np.int32)
    eng = E.PagedEngine(cfg, params, page_size=4, num_pages=64,
                        prefix_cache=True, device="cpu")
    eng.submit(E.Request(0, prompt, max_new_tokens=2, temperature=0.0))
    eng.submit(E.Request(1, prompt, max_new_tokens=2, temperature=0.0,
                         share_with=0, shared_len=8))
    with pytest.warns(DeprecationWarning, match="pairwise"):
        res = eng.run()
    assert res[0] == res[1]


def test_engine_mirrors_cache_prefix_counters_after_evictions(model):
    """``engine.stats`` mirrors the cache's ``prefix_evictions`` beside
    its hits, as the JAX engine does; after an evicting run the two
    agree key for key."""
    _, jrun, _, run, _ = _run(model, "lru")
    assert run["counters"]["cache"]["prefix_evictions"] > 0
    assert run["counters"]["engine"] == run["counters"]["cache"]
    assert jrun["counters"]["engine"] == jrun["counters"]["cache"]
