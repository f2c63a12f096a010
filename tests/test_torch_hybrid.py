"""Paged SSM, hybrid and MoE serving of the port against the JAX engine.

Three layouts, the reduced configs of ``tests/test_hybrid.py`` (weights
from ``PRNGKey(0)``, converted bit for bit): mamba2 (2 layers, SSD chunk
size 4), jamba cut to one period (``num_layers=4, attn_every=4``: Mamba,
attention, MoE and MLP sublayers in one layer) and llama4-scout reduced
(attention + top-1 MoE with a shared expert).  Each runs three paths of
both engines on the same requests, the port teacher-forced by the JAX
engine's choices (the harness of ``test_torch_prefix.py``), each path
against the SAME path of the JAX engine (the JAX package's own streams
differ across its paths for these layouts):

* monolithic greedy: bucketed fused prefill, fused decode rounds;
* chunked: 8-token chunks, mixed rounds, 8-round decode blocks, odd
  ids sampled at temperature 1.0;
* the eager decode oracle (JAX: ``fused=False, fused_prefill=True``),
  whose round writes its state through the ``ssm_state_write`` kind.

Held equal: the streams, every step's ``launches_by_kind`` delta (the
state kinds and ``eager_ssm_layer`` among them), ``rng_ctr``, the cache
counters (``state_pages``, ``state_forks``, ``prefix_declined_ssm``), 0
pages and 0 state rows in use at the end, and zero KV and state arenas
(init-on-free).  Held at tolerance: the logits of every choice
(``LOGIT_ATOL`` = 0.1, as in the dense harness), and the port's own
greedy choice must be the JAX token wherever the JAX top-1/top-2 margin
exceeds twice the row's logit difference.

Also held against the JAX package: the state rows after a mid-flight
stop (at the reference's own eager-vs-fused bound, ``STATE_TOL`` with
more than 90% of the values within ``STATE_TIGHT``), copy-on-fork
isolation and the fork flushing a deferred state write, free zeroing the
row, the prefix decline, and the constructor's guards.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.kv_cache import PagedKVCache as JCache  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache  # noqa: E402
from test_torch_prefix import (PREFIX_KEYS, Forced,  # noqa: E402
                               assert_same_run, check_choices, recording,
                               run_both)
from test_torch_ssm import FAMILIES, chunk4  # noqa: E402

STATE_KEYS = ("state_pages", "state_forks", "prefix_declined_ssm")
# the reference's own bound between two of its paths' state rows
# (tests/test_multiround.py: rtol = atol = 0.3, > 90% within 2e-2)
STATE_TOL = 0.3
STATE_TIGHT = 2e-2
PATHS = {
    "monolithic": dict(page_size=4, num_pages=64),
    "chunked": dict(page_size=4, num_pages=64, max_prefill_chunk=8,
                    mixed_rounds=True, decode_block_rounds=8),
    "eager": dict(page_size=4, num_pages=64, fused=False),
}

_MODELS = {}


def model(fam):
    """(jax cfg, port cfg, jax params, port params) of a family."""
    if fam not in _MODELS:
        arch, kw = FAMILIES[fam]
        jcfg = chunk4(jreduced(JARCHS[arch], **kw))
        cfg = chunk4(reduced(ARCHS[arch], **kw))
        jparams = jinit(JT.model_defs(jcfg), jax.random.PRNGKey(0))
        params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
        _MODELS[fam] = (jcfg, cfg, jparams, params)
    return _MODELS[fam]


def _waves(path, vocab):
    """One wave of requests: 3 greedy ones of 2-11 tokens (6 new), or,
    for the chunked path, 4 of 5-20 tokens with odd ids sampled."""
    rng = np.random.default_rng(5)
    n, lo, hi = (4, 5, 21) if path == "chunked" else (3, 2, 12)
    wave = []
    for i in range(n):
        prompt = rng.integers(0, vocab, int(rng.integers(lo, hi))
                              ).astype(np.int32)
        temp = float(i % 2) if path == "chunked" else 0.0
        wave.append(lambda cls, i=i, p=prompt, t=temp: cls(
            i, p, max_new_tokens=6, temperature=t))
    return [wave]


def _zero(t):
    return int(torch.count_nonzero(t)) == 0


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_path_matches_jax(fam, path):
    m = model(fam)
    jeng, jrun, eng, run, calls = run_both(m, _waves(path, m[1].vocab_size),
                                           **PATHS[path])
    assert_same_run(jeng, jrun, eng, run, keys=PREFIX_KEYS + STATE_KEYS)
    assert eng.rng_ctr == jeng.rng_ctr
    assert check_choices(eng, calls) >= 1
    kinds = set().union(*run["deltas"])
    if path == "eager":
        assert "fused_decode" not in kinds
        assert ("eager_ssm_layer" in kinds) == (fam != "moe")
        assert ("ssm_state_write" in kinds) == (fam != "moe")
        assert ("eager_attn_layer" in kinds) == (fam != "ssm")
    if path == "chunked":
        assert {"fused_mixed", "fused_decode_block"} <= kinds
    st, jst = eng.cache.state, jeng.cache.state
    if fam == "moe":
        assert st is None and jst is None
    else:
        assert st.rows_in_use == 0 == jst.rows_in_use
        assert _zero(st.conv) and _zero(st.ssm)
        assert "state_init" in kinds and eng.cache.stats["state_pages"] == 0


def test_state_rows_mid_flight_match_jax():
    """Stop both engines after the same 7 rounds (chunks, mixed rounds,
    then a K-block): the live rows' state (mamba2, as the reference's
    own mid-flight test), at the reference's bound."""
    for fam in ("ssm",):
        jcfg, cfg, jparams, params = model(fam)
        kw = PATHS["chunked"]
        rng = np.random.default_rng(7)
        reqs = [(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32))
                for i, n in enumerate((13, 9, 6))]
        states = []
        with recording() as calls:
            jeng = JE.PagedEngine(jcfg, jparams, use_pallas=False, **kw)
            for i, p in reqs:
                jeng.submit(JE.Request(i, p, max_new_tokens=32,
                                       temperature=float(i % 2)))
            jeng.run(max_rounds=7)
            rids = sorted(jeng.active)
            conv, ssm = jeng.cache.state.gather(rids)
            states.append((np.asarray(conv.astype(jnp.float32)),
                           np.asarray(ssm)))
        eng = Forced(cfg, params, device="cpu", ref_calls=calls, **kw)
        for i, p in reqs:
            eng.submit(E.Request(i, p, max_new_tokens=32,
                                 temperature=float(i % 2)))
        eng.run(max_rounds=7)
        assert sorted(eng.active) == rids == [0, 1, 2]
        assert eng.stats["multi_round_blocks"] >= 1
        for r in rids:
            assert eng.active[r].out_tokens == jeng.active[r].out_tokens
        conv, ssm = eng.cache.state.gather(rids)
        states.append((conv.float().numpy(), ssm.numpy()))
        for got, ref in zip(states[1], states[0]):
            np.testing.assert_allclose(got, ref, rtol=STATE_TOL,
                                       atol=STATE_TOL)
            tight = np.abs(got - ref) <= STATE_TIGHT + STATE_TIGHT * np.abs(
                ref)
            assert tight.mean() > 0.9, (fam, tight.mean())


def _caches(fam, **kw):
    jcfg, cfg, _, _ = model(fam)
    return (JCache(jcfg, **kw), PagedKVCache(cfg, device="cpu", **kw))


def _fill(st, value):
    """(conv, ssm) of one row, every element ``value``."""
    if isinstance(st.conv, torch.Tensor):
        return (torch.full(st.conv.shape[:2] + (1,) + st.conv.shape[3:],
                           value, dtype=st.conv.dtype),
                torch.full(st.ssm.shape[:2] + (1,) + st.ssm.shape[3:],
                           value, dtype=st.ssm.dtype))
    return (jnp.full(st.conv.shape[:2] + (1,) + st.conv.shape[3:], value,
                     st.conv.dtype),
            jnp.full(st.ssm.shape[:2] + (1,) + st.ssm.shape[3:], value,
                     st.ssm.dtype))


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _rows(st, sid):
    return tuple(_np32(a) for a in st.gather([sid]))


def test_fork_and_free_match_jax():
    """The script of ``tests/test_hybrid.py``'s copy-on-fork class on
    both caches: a fork racing a deferred write flushes it first (2
    ``ssm_state_write`` then 2 ``state_copy`` launches), the fork is
    isolated from its source's later write, and a freed row is zero (and
    a new sequence on it starts from zero); every delta, row and counter
    equal."""
    seen = []
    for cache in _caches("ssm", num_pages=32, page_size=4, state_slots=8):
        st, q = cache.state, cache.queue
        out = {}
        cache.create(0, 4)
        st.write([0], *_fill(st, 3.0), flush=False)   # deferred
        base = q.snapshot()
        cache.fork(0, 1)
        out["fork_delta"] = q.delta(base)
        st.write([0], *_fill(st, 7.0))                # the source diverges
        out["rows"] = [_rows(st, s) for s in (0, 1)]
        slot = st.rows[0]
        base = q.snapshot()
        cache.free(0)
        out["free_delta"] = q.delta(base)
        out["freed_slot_abs"] = float(
            np.abs(_np32(st.conv[:, :, slot])).sum()
            + np.abs(_np32(st.ssm[:, :, slot])).sum())
        cache.create(9, 4)
        out["reused"] = _rows(st, 9)
        out["stats"] = {k: cache.stats[k] for k in STATE_KEYS}
        seen.append(out)
    jout, out = seen
    assert out["fork_delta"] == jout["fork_delta"] == {
        "ssm_state_write": 2, "state_copy": 2}
    assert out["free_delta"] == jout["free_delta"]
    for got, ref in zip(out["rows"], jout["rows"]):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    assert all((a == 3.0).all() for a in out["rows"][1])
    assert all((a == 7.0).all() for a in out["rows"][0])
    assert out["freed_slot_abs"] == 0.0 == jout["freed_slot_abs"]
    assert all((a == 0).all() for a in out["reused"])
    assert out["stats"] == jout["stats"]


def test_prefix_declined_like_jax():
    """A state family declines every prefix hit: the radix path (the
    same prompt twice on a prefix-cache engine, streams and counters as
    JAX's), ``commit_prefix`` indexing nothing and the pairwise path."""
    m = model("hybrid")
    prompt = np.random.default_rng(11).integers(
        0, m[1].vocab_size, 12).astype(np.int32)
    waves = [[lambda cls, i=i: cls(i, prompt, max_new_tokens=3,
                                   temperature=0.0)] for i in range(2)]
    jeng, jrun, eng, run, calls = run_both(m, waves, page_size=4,
                                           num_pages=64, prefix_cache=True)
    assert_same_run(jeng, jrun, eng, run, keys=PREFIX_KEYS + STATE_KEYS)
    assert run["results"][0] == run["results"][1]
    assert eng.stats["prefix_hits"] == 0
    assert eng.stats["prefix_declined_ssm"] == jeng.stats[
        "prefix_declined_ssm"] >= 1
    assert "kv_write" not in eng.cache.queue.saved_by_kind
    for kw, script in ((dict(prefix_cache=True), "commit"),
                       ({}, "pairwise")):
        got = []
        for cache in _caches("ssm", num_pages=32, page_size=4, **kw):
            if script == "commit":
                cache.create(0, 8, tokens=list(range(8)))
                got.append((cache.commit_prefix(0, list(range(8))),
                            cache.prefix.n_nodes))
            else:
                cache.create(0, 8)
                seq = cache.create(1, 8, share_with=0, shared_len=8)
                got.append((seq.shared_prefix_pages,
                            cache.stats["prefix_hits"]))
            got[-1] += (cache.stats["prefix_declined_ssm"],)
        assert got[0] == got[1] == (0, 0, 1), script


def test_guards_match_jax():
    """Chunk alignment at construction and in ``set_prefill_chunk``;
    ``mesh=`` with a state or MoE family, MLA and multi-group layouts
    refused (``ValueError``, the JAX engine's refusals)."""
    _, cfg, _, params = model("ssm")
    with pytest.raises(ValueError, match="chunk_size"):
        E.PagedEngine(cfg, params, device="cpu", max_prefill_chunk=6)
    eng = E.PagedEngine(cfg, params, device="cpu", max_prefill_chunk=8)
    with pytest.raises(ValueError, match="chunk_size"):
        eng.set_prefill_chunk(6)
    eng.set_prefill_chunk(12)
    assert eng.max_prefill_chunk == 12
    for fam in FAMILIES:
        _, cfg, _, params = model(fam)
        with pytest.raises(ValueError, match="dense-only"):
            E.PagedEngine(cfg, params, device="cpu", mesh=object())
    _, cfg, _, params = model("moe")
    with pytest.raises(ValueError, match="MLA"):
        E.PagedEngine(reduced(ARCHS["deepseek-v2-236b"]), params,
                      device="cpu")
    two = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, first_dense_layers=1))
    with pytest.raises(ValueError, match="single-group"):
        E.PagedEngine(two, params, device="cpu")
