"""Chunked prefill, mixed rounds, K-block decode and sampled decoding:
the port against the JAX package.

Kernel level: the prefix-KV mode of the flash-attention wrapper (on CPU
tensors, its plain version) against the JAX Pallas kernel in interpret
mode and the JAX reference, at 1e-5 for fp32 and 2e-2 for bf16 inputs
(see ``test_torch_attention.py``), with a committed prefix of length 0
among the rows, the prefix passed as a strided view of a gather as the
engine passes it.

Engine level: both engines serve one workload — six requests on
``reduced(granite-3-8b, num_layers=2)``, three submitted after the
second step so that chunks meet live decodes, greedy and sampled rows
at several temperatures, a sharer of a page-aligned prefix, a sharer
fully covered by its prefix, and one request with an EOS — under five
engine settings: monolithic, chunked, chunked with mixed rounds, and
both with K=8 decode blocks.  The JAX engine runs first; every token
choice it makes is recorded with its logits, temperatures, seed and row
map, keyed by the seed (unique per dispatch).  The port then runs with
each choice taken from the JAX record of the same seed (teacher
forcing), so both see the same inputs.  Held equal: the streams, the
per-step ``launches_by_kind`` deltas, the final ``rng_ctr``, the seeds
of every dispatch and their uniforms (bit for bit), 0 pages in use.
Held at tolerance: the logits of every choice (``LOGIT_ATOL``; the two
sides round to bf16 at different places, and at this init the attention
softmax is nearly one-hot, so one such difference at a near-tie moved
one row's logits by 0.096 in this workload).  The port's own choice
from its own logits must equal the JAX token wherever the row's logit
difference ``d`` (at most ``LOGIT_ATOL``) cannot change it: for a
greedy row, where the JAX top-1/top-2 margin exceeds ``2 d``; for a
sampled row, where moving every logit by at most ``d`` cannot carry
either boundary of the drawn token's CDF interval past ``u`` (at
temperature t the odds of the mass before a boundary change by at most
a factor ``exp(2 d / t)``), with ``BOUNDARY`` to spare for float32
sums.  On the JAX logits themselves the port's choice must equal the
JAX token except where ``u`` lies within ``BOUNDARY`` of a CDF boundary
(float32 cumulative sums in another order); those rows are counted.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.kernels.drange import ops as jdr  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.kernels.drange import ops as dr_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from test_torch_kernels import (ATTN_TOL, _f32, _j, _rand, _t,  # noqa: E402,F401
                                jx)

LOGIT_ATOL = 0.1
BOUNDARY = 1e-5
PAGE, CHUNK = 4, 8
LATE_AFTER = 2                          # steps before requests 3-5 arrive
SETTINGS = {
    "mono": dict(),
    "chunked": dict(max_prefill_chunk=CHUNK, mixed_rounds=False),
    "mixed": dict(max_prefill_chunk=CHUNK),
    "mixed_K8": dict(max_prefill_chunk=CHUNK, decode_block_rounds=8),
    "mono_K8": dict(decode_block_rounds=8),
}
# token 138 is request 2's fourth greedy token under this model
EOS = {2: 138}


# ------------------------------------------------------------------ #
# Flash attention, prefix-KV mode
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_prefix_mode_matches_jax(jx, dt):
    rng = np.random.default_rng(8)
    B, H, KVH, S, D, P, W = 3, 4, 2, 8, 32, 4, 3
    q = _rand(rng, (B, H, S, D))
    k, v = (_rand(rng, (B, KVH, S, D)) for _ in range(2))
    # the prefix as the engine gathers it: pages of a (P*2, P, KVH, D)
    # arena through a (B, W) block table, (B, W*P, KVH, D) transposed
    ka, va = (_rand(rng, (2 * W * P, P, KVH, D)) for _ in range(2))
    bt = rng.permutation(2 * W * P)[:B * W].reshape(B, W)
    lens = np.asarray([8, 3, 5], np.int32)
    plens = np.asarray([12, 0, 7], np.int32)
    kp, vp = (a[bt].reshape(B, W * P, KVH, D) for a in (ka, va))
    tk, tv = _t(ka, dt), _t(va, dt)
    tbt = torch.from_numpy(bt)
    got = fa_ops.attention(
        _t(q, dt), _t(k, dt), _t(v, dt), causal=True, lengths=_t(lens),
        k_prefix=tk[tbt].reshape(B, W * P, KVH, D).transpose(1, 2),
        v_prefix=tv[tbt].reshape(B, W * P, KVH, D).transpose(1, 2),
        prefix_lengths=_t(plens))
    args = (_j(jx, q, dt), _j(jx, k, dt), _j(jx, v, dt))
    kw = dict(causal=True, lengths=_j(jx, lens),
              k_prefix=_j(jx, kp.transpose(0, 2, 1, 3), dt),
              v_prefix=_j(jx, vp.transpose(0, 2, 1, 3), dt),
              prefix_lengths=_j(jx, plens))
    tol = ATTN_TOL[dt]
    for want in (jx.fa.flash_attention(*args, block_q=8, block_k=8,
                                       interpret=True, **kw),
                 jx.fa_ref.attention(*args, **kw)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


# ------------------------------------------------------------------ #
# Engines
# ------------------------------------------------------------------ #


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(JARCHS["granite-3-8b"], num_layers=2, num_kv_heads=2)
    cfg = reduced(ARCHS["granite-3-8b"], num_layers=2, num_kv_heads=2)
    jparams = jinit(JT.model_defs(jcfg), jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _requests(cls, vocab):
    """Requests 0-2 first, 3-5 after LATE_AFTER steps."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in (5, 40, 17, 23)]
    temps = (0.0, 0.1, 0.0, 1.0)
    # request 1 outlives the late sharers' admission in every setting
    reqs = [cls(i, p, max_new_tokens=16 if i == 1 else 10,
                temperature=temps[i],
                eos_token_id=EOS.get(i)) for i, p in enumerate(prompts)]
    sharer = np.concatenate([prompts[1][:32],
                             rng.integers(0, vocab, 4).astype(np.int32)])
    reqs.append(cls(4, sharer, max_new_tokens=10, temperature=0.05,
                    share_with=1, shared_len=32))
    # fully covered by request 1's prefix: one no-write chunk
    reqs.append(cls(5, prompts[1][:32].copy(), max_new_tokens=6,
                    temperature=0.0, share_with=1, shared_len=32))
    return reqs[:3], [reqs[3], reqs[4], reqs[5]]


def _drive(engine, vocab, cls):
    """Step the engine to the end as the serve loop does (one round a
    step, up to ``decode_block_rounds`` when nothing waits for
    admission); return the results and each step's launch delta."""
    first, late = _requests(cls, vocab)
    for r in first:
        engine.submit(r)
    q = engine.cache.queue
    results, deltas, steps = {}, [], 0
    while engine.has_work or late:
        rounds = (engine.decode_block_rounds
                  if engine.prefill_backlog_tokens() == 0 else 1)
        before = q.snapshot()
        results.update(engine.run(max_rounds=rounds))
        deltas.append(q.delta(before))
        steps += 1
        if steps == LATE_AFTER:
            for r in late:
                engine.submit(r)
            late = []
    return results, deltas


_REFERENCE = {}


def _reference(model, name):
    """The JAX engine's run under SETTINGS[name], with every token
    choice recorded by seed: (logits, temps, tokens, rowmap)."""
    if name in _REFERENCE:
        return _REFERENCE[name]
    jcfg, _, jparams, _ = model
    calls = {}

    def record(logits, temps, seed, tokens, rowmap, has_rowmap):
        calls[tuple(int(w) for w in np.asarray(seed))] = (
            np.asarray(logits, np.float32), np.asarray(temps),
            np.asarray(tokens), np.asarray(rowmap) if has_rowmap else None)

    orig = JE._select_tokens

    def select(logits, temps, seed, *, rowmap=None, **kw):
        tokens = orig(logits, temps, seed, rowmap=rowmap, **kw)
        rm = rowmap if rowmap is not None else jnp.zeros((0,), jnp.int32)
        jax.debug.callback(functools.partial(
            record, has_rowmap=rowmap is not None), logits, temps, seed,
            tokens, rm)
        return tokens

    mp = pytest.MonkeyPatch()
    mp.setattr(JE, "_select_tokens", select)
    try:
        eng = JE.PagedEngine(jcfg, jparams, page_size=PAGE, num_pages=64,
                             use_pallas=False, **SETTINGS[name])
        results, deltas = _drive(eng, jcfg.vocab_size, JE.Request)
    finally:
        mp.undo()
    _REFERENCE[name] = dict(results=results, deltas=deltas, calls=calls,
                            rng_ctr=eng.rng_ctr,
                            pages=eng.cache.pages_in_use)
    return _REFERENCE[name]


class _Forced(E.PagedEngine):
    """The port's engine with every token taken from the reference's
    choice of the same seed; records its own choices' inputs.  A seed
    the reference never drew is a block round after every row stopped
    (the port runs such a round masked; the JAX loop exits early)."""

    def __init__(self, *a, ref_calls, **kw):
        super().__init__(*a, **kw)
        self.ref_calls = ref_calls
        self.calls = []

    def _choose(self, logits, temps, seed, rowmap=None):
        self.calls.append((seed, logits.float().numpy(), np.asarray(temps),
                           None if rowmap is None else rowmap.numpy()))
        ref = self.ref_calls.get(seed)
        if ref is None:
            return torch.argmax(logits, dim=-1)
        return torch.from_numpy(ref[2].astype(np.int64))


_PORT = {}


def _port(model, name):
    if name not in _PORT:
        _, cfg, _, params = model
        ref = _reference(model, name)
        eng = _Forced(cfg, params, page_size=PAGE, num_pages=64,
                      device="cpu", ref_calls=ref["calls"],
                      **SETTINGS[name])
        results, deltas = _drive(eng, cfg.vocab_size, E.Request)
        _PORT[name] = (eng, results, deltas)
    return _PORT[name]


def _cdf(logits, temp):
    z = logits.astype(np.float64) / (temp if temp > 0 else 1.0)
    p = np.exp(z - z.max())
    return np.cumsum(p / p.sum())


def _sure_sampled(cum, u, tok, temp, d):
    """Can no move of every logit by at most ``d`` carry a boundary of
    token ``tok``'s CDF interval past ``u``?"""
    r = np.exp(2 * d / temp)
    lo = cum[tok - 1] if tok > 0 else 0.0
    hi = cum[tok]
    lo_max = lo * r / (lo * r + (1 - lo))
    hi_min = hi / (hi + (1 - hi) * r)
    return lo_max + BOUNDARY < u < hi_min - BOUNDARY


@pytest.mark.parametrize("name", list(SETTINGS))
def test_streams_and_draws_match_jax(model, name):
    ref = _reference(model, name)
    eng, results, _ = _port(model, name)
    assert results == ref["results"]
    # the EOS stopped request 2 in the reference, and the port followed
    stream = ref["results"][2]
    assert stream[-1] == EOS[2] and len(stream) < 10, stream
    seen = {c[0] for c in eng.calls}
    assert set(ref["calls"]) <= seen
    if "K8" not in name:
        assert seen == set(ref["calls"])
    checks = {"greedy": 0, "sampled": 0, "boundary_rows": 0}
    for seed, logits, temps, rowmap in eng.calls:
        if seed not in ref["calls"]:
            continue
        r_logits, r_temps, r_tokens, r_rowmap = ref["calls"][seed]
        np.testing.assert_array_equal(temps, r_temps)
        assert (rowmap is None) == (r_rowmap is None)
        if rowmap is not None:
            np.testing.assert_array_equal(rowmap, r_rowmap)
        np.testing.assert_allclose(logits, r_logits, atol=LOGIT_ATOL)
        B = logits.shape[0]
        u = dr_ops.pim_random_uniform(seed, B, 1, "cpu")[:, 0].numpy()
        ju = np.asarray(jdr.pim_random_uniform(
            jnp.asarray(seed, jnp.uint32), B, 1))[:, 0]
        np.testing.assert_array_equal(u.view(np.uint32), ju.view(np.uint32))
        if rowmap is not None:
            u = u[rowmap]
        own = E._select_tokens(torch.from_numpy(logits), temps, seed,
                               rowmap=None if rowmap is None
                               else torch.from_numpy(rowmap)).numpy()
        on_ref = E._select_tokens(torch.from_numpy(r_logits), temps, seed,
                                  rowmap=None if rowmap is None
                                  else torch.from_numpy(rowmap)).numpy()
        for b in range(B):
            tok = int(r_tokens[b])
            d = float(np.abs(logits[b] - r_logits[b]).max())
            if temps[b] == 0.0:
                assert on_ref[b] == tok
                top2 = np.sort(r_logits[b])[-2:]
                if top2[1] - top2[0] > 2 * d:
                    assert own[b] == tok, (seed, b)
                    checks["greedy"] += 1
                continue
            cum = _cdf(r_logits[b], temps[b])
            if np.abs(cum - u[b]).min() < BOUNDARY:
                checks["boundary_rows"] += 1
            else:
                assert on_ref[b] == tok, (seed, b)
            if _sure_sampled(cum, u[b], tok, temps[b], d):
                assert own[b] == tok, (seed, b)
                checks["sampled"] += 1
    print(name, checks)
    assert checks["greedy"] >= 10 and checks["sampled"] >= 5, checks


@pytest.mark.parametrize("name", list(SETTINGS))
def test_launches_seed_stream_and_pages_match_jax(model, name):
    ref = _reference(model, name)
    eng, _, deltas = _port(model, name)
    assert deltas == ref["deltas"]
    assert eng.rng_ctr == ref["rng_ctr"]
    if "mixed" in name:
        assert {"fused_mixed": 1} in deltas
    if "K8" in name:
        assert any(d.get("fused_decode_block") for d in deltas)
        assert eng.stats["multi_round_blocks"] > 0
    if name != "mono":
        assert eng.stats["prefill_chunks" if "mono" not in name
                         else "multi_round_blocks"] > 0
    assert eng.cache.pages_in_use == 0 == ref["pages"]
    assert torch.count_nonzero(eng.cache.k_arena) == 0
    assert torch.count_nonzero(eng.cache.v_arena) == 0


def test_prefill_budget_api_matches_jax(model):
    """``prefill_backlog_tokens`` step by step, and ``set_prefill_chunk``
    retargeting the budget mid-run, as in the JAX engine."""
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (19, 11)]
    engines = (JE.PagedEngine(jcfg, jparams, page_size=PAGE, num_pages=64,
                              use_pallas=False, max_prefill_chunk=CHUNK),
               E.PagedEngine(cfg, params, page_size=PAGE, num_pages=64,
                             device="cpu", max_prefill_chunk=CHUNK))
    backlog = []
    for eng, cls in zip(engines, (JE.Request, E.Request)):
        for i, p in enumerate(prompts):
            eng.submit(cls(i, p, max_new_tokens=3, temperature=0.0))
        seen = [eng.prefill_backlog_tokens()]
        while eng.has_work:
            eng.step()
            if len(seen) == 2:
                eng.set_prefill_chunk(4)
            seen.append(eng.prefill_backlog_tokens())
        backlog.append((seen, eng.stats["prefill_chunks"]))
    assert backlog[0] == backlog[1]
    assert backlog[1][0][0] == 30 and backlog[1][0][-1] == 0
    for bad in (0, -2):
        with pytest.raises(ValueError):
            engines[1].set_prefill_chunk(bad)
    with pytest.raises(ValueError):
        E.PagedEngine(cfg, params, device="cpu").set_prefill_chunk(8)
