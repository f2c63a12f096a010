"""The port's serving engine against the JAX package's, end to end.

Both engines serve the same four greedy requests (ragged prompts of 5
to 40 tokens, one sharing another's page-aligned prefix, 8 new tokens
each) from the same weights (the JAX ``init_params``, converted), with
a CoW fork of a live sequence and its free in between rounds.  The JAX
engine runs first and its logits are recorded at every token choice;
the port then runs with every choice taken from the JAX stream (teacher
forcing), so both see the same inputs all the way.  Where the JAX
top-1/top-2 margin exceeds ``MARGIN`` the port's own argmax must be the
JAX token.  ``MARGIN`` is twice ``LOGIT_ATOL``, the bf16 tolerance the
logits themselves are held to: within it, no smaller margin can flip
the argmax.  The reduced model's logits lie close together (|logit| < 1,
rounded to bf16, so spaced 2**-8 apart), and about a quarter of the
choices clear the margin; the logits themselves are compared at every
choice.
"""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402
from repro_torch.serving.engine import PagedEngine, Request  # noqa: E402

LOGIT_ATOL = 5e-2
MARGIN = 2 * LOGIT_ATOL
PAGE = 4
FORK_AFTER, FREE_AFTER = 2, 4          # rounds
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(JARCHS["granite-3-8b"], num_layers=2, num_kv_heads=2)
    cfg = reduced(ARCHS["granite-3-8b"], num_layers=2, num_kv_heads=2)
    jparams = jinit(JT.model_defs(jcfg), jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in (5, 40, 17)]
    sharer = np.concatenate([prompts[1][:32],
                             rng.integers(0, vocab, 4).astype(np.int32)])
    reqs = [cls(i, p, max_new_tokens=8, temperature=0.0)
            for i, p in enumerate(prompts)]
    reqs.append(cls(3, sharer, max_new_tokens=8, temperature=0.0,
                    share_with=1, shared_len=32))
    return reqs


def _drive(engine, requests):
    """Step the engine to the end, forking request 0's sequence after
    round FORK_AFTER and freeing the fork after round FREE_AFTER; return
    the results and each round's launch delta."""
    for r in requests:
        engine.submit(r)
    q = engine.cache.queue
    results, deltas, rounds = {}, [], 0
    while engine.has_work:
        before = q.snapshot()
        results.update(engine.step())
        deltas.append(q.delta(before))
        rounds += 1
        before = q.snapshot()
        if rounds == FORK_AFTER:
            engine.cache.fork(0, 100)
        elif rounds == FREE_AFTER:
            engine.cache.free(100)
        if rounds in (FORK_AFTER, FREE_AFTER):
            deltas.append(q.delta(before))
    return results, deltas


@pytest.fixture(scope="module")
def reference(model):
    """The JAX engine's run, with the logits of every token choice."""
    jcfg, _, jparams, _ = model
    calls = []

    def record(logits):
        calls.append(np.asarray(logits, np.float32))

    orig = JE._select_tokens

    def select(logits, temps, seed, **kw):
        jax.debug.callback(record, logits)
        return orig(logits, temps, seed, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(JE, "_select_tokens", select)
    try:
        eng = JE.PagedEngine(jcfg, jparams, page_size=PAGE, num_pages=64,
                             use_pallas=False)
        results, deltas = _drive(eng, _requests(JE.Request, jcfg.vocab_size))
    finally:
        mp.undo()
    return results, deltas, calls, eng.cache.pages_in_use


class _Forced(PagedEngine):
    """The port's engine with every token taken from the reference's
    recorded choices (call by call, row by row); records its own logits."""

    def __init__(self, *a, ref_calls, **kw):
        super().__init__(*a, **kw)
        self.ref_calls = ref_calls
        self.logits = []

    def _choose(self, logits, temps, seed, rowmap=None):
        ref = self.ref_calls[len(self.logits)]
        self.logits.append(logits.float().numpy())
        return torch.from_numpy(np.argmax(ref, axis=-1))


def _run_port(model, ref_calls, fused=True):
    _, cfg, _, params = model
    eng = _Forced(cfg, params, page_size=PAGE, num_pages=64, device="cpu",
                  fused=fused, ref_calls=ref_calls)
    results, deltas = _drive(eng, _requests(Request, cfg.vocab_size))
    return eng, results, deltas


def test_greedy_streams_match_jax(model, reference):
    ref_results, _, ref_calls, _ = reference
    eng, results, _ = _run_port(model, ref_calls)
    assert results == ref_results
    assert len(eng.logits) == len(ref_calls)
    checked = total = 0
    for ours, ref in zip(eng.logits, ref_calls):
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=LOGIT_ATOL)
        top2 = np.sort(ref, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > MARGIN
        np.testing.assert_array_equal(np.argmax(ours, -1)[sure],
                                      np.argmax(ref, -1)[sure])
        checked += int(sure.sum())
        total += sure.size
    assert checked >= total // 4, (checked, total)


def test_launch_deltas_and_pages_match_jax(model, reference):
    _, ref_deltas, ref_calls, ref_pages = reference
    eng, _, deltas = _run_port(model, ref_calls)
    assert deltas == ref_deltas
    # one fused launch per decode round, as the JAX dispatch pins say
    assert {"fused_decode": 1} in deltas
    assert eng.cache.pages_in_use == 0 == ref_pages
    assert torch.count_nonzero(eng.cache.k_arena) == 0


def test_eager_oracle_agrees_with_fused(model, reference):
    _, _, ref_calls, _ = reference
    fused, f_results, _ = _run_port(model, ref_calls)
    eager, e_results, e_deltas = _run_port(model, ref_calls, fused=False)
    assert e_results == f_results
    for a, b in zip(eager.logits, fused.logits):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    assert {"eager_attn_layer": 2, "kv_write": 2} in e_deltas
    assert eager.cache.pages_in_use == 0


def test_eos_stops_a_request(model):
    _, cfg, _, params = model
    prompt = np.arange(1, 9, dtype=np.int32)
    free = PagedEngine(cfg, params, page_size=PAGE, device="cpu")
    free.submit(Request(0, prompt, max_new_tokens=4, temperature=0.0))
    stream = free.run()[0]
    eng = PagedEngine(cfg, params, page_size=PAGE, device="cpu")
    eos = stream[1]
    eng.submit(Request(0, prompt, max_new_tokens=4, temperature=0.0,
                       eos_token_id=eos))
    assert eng.run()[0] == stream[:stream.index(eos) + 1]
    assert eng.cache.pages_in_use == 0


def test_engine_refuses_what_is_not_ported(model):
    _, cfg, _, params = model
    for kw in (dict(prefix_cache=True), dict(mesh=object()),
               dict(lib=object()), dict(fused_prefill=False),
               dict(record_trace=True), dict(compressed_collectives=True)):
        with pytest.raises(NotImplementedError):
            PagedEngine(cfg, params, device="cpu", **kw)
    ssm = reduced(ARCHS["mamba2-1.3b"])
    with pytest.raises(NotImplementedError):
        PagedEngine(ssm, params, device="cpu")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
