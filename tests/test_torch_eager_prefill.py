"""The eager prefill oracle (``PagedEngine(fused_prefill=False)``) and
vlm serving of the port against the JAX package's engine.

The eager oracle runs each request's prompt through the dense reference
forward into a fresh dense cache, writes its KV through the op queue
(one ``kv_write`` flush: the ``kv_scatter`` kernel) and, on Mamba
layers, its final state through the ``ssm_state_write`` kind (the
``state_scatter`` kernel), then chooses the first token with one draw
per request.  Both engines serve the same requests from the same
weights (the JAX ``init_params``, converted); the JAX engine runs first
and every token choice it makes is recorded by its seed, and the port
takes each choice from that record (teacher forcing, the harness of
``test_torch_prefix.py``).  Held equal: the streams, every step's
``launches_by_kind`` delta, ``rng_ctr`` (a sampled request advances the
seed stream once, as in JAX), every seed JAX drew, and 0 pages and 0
state rows in use at the end; the logits of every choice are held at
``LOGIT_ATOL`` and the port's own greedy choice must be the JAX token
where the JAX margin allows.

Cases: reduced granite-3-8b, greedy and sampled; a 2-layer mamba2
(the state write); reduced llava-next-34b served text-only as the JAX
engine serves it, fused and eager; the dense greedy check of the JAX
package's ``tests/test_serving.py`` (the dense prefill and decode
against the paged engine, fused and eager); and MLA, refused by both
engines with ``ValueError``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.configs import ARCHS, ParallelConfig, reduced  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from test_torch_prefix import check_choices, run_both  # noqa: E402

PAGE = 4


def _model(arch, **kw):
    jcfg, cfg = jreduced(JARCHS[arch], **kw), reduced(ARCHS[arch], **kw)
    jparams = jinit(JT.model_defs(jcfg), jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def granite():
    return _model("granite-3-8b", num_layers=2)


def _waves(vocab, temperature):
    """Two waves: three ragged prompts, one sharing another's first two
    pages; then two more while nothing else runs."""
    rng = np.random.default_rng(3)
    p = [rng.integers(0, vocab, n).astype(np.int32) for n in (6, 13, 9)]
    sharer = np.concatenate([p[1][:8], rng.integers(0, vocab, 3)
                             .astype(np.int32)])

    def req(rid, prompt, n, **kw):
        return lambda cls: cls(rid, prompt, max_new_tokens=n,
                               temperature=temperature(rid), **kw)

    first = [req(0, p[0], 5), req(1, p[1], 4), req(2, p[2], 3),
             req(3, sharer, 4, share_with=1, shared_len=8)]
    second = [req(4, rng.integers(0, vocab, 11).astype(np.int32), 4),
              req(5, rng.integers(0, vocab, 4).astype(np.int32), 2)]
    return [first, second]


def _check_same(jeng, jrun, eng, run, calls):
    assert run["results"] == jrun["results"]
    assert run["deltas"] == jrun["deltas"]
    assert eng.rng_ctr == jeng.rng_ctr
    assert eng.stats["prefills"] == jeng.stats["prefills"]
    assert eng.cache.pages_in_use == 0 == jeng.cache.pages_in_use
    st = eng.cache.state
    assert st is None or st.rows_in_use == 0
    return check_choices(eng, calls)


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_eager_granite_matches_jax(granite, sampled):
    """The eager oracle on reduced granite-3-8b: greedy, then odd ids
    sampled at temperature 1.0 (each draws once, at its own seed).  The
    prefill steps' deltas hold ``kv_write`` (two a request, one per
    arena, the shared request's KV past its shared pages) and no
    ``fused_prefill``."""
    temp = (lambda rid: float(rid % 2)) if sampled else (lambda rid: 0.0)
    waves = _waves(granite[1].vocab_size, temp)
    jeng, jrun, eng, run, calls = run_both(
        granite, waves, page_size=PAGE, num_pages=64, fused_prefill=False)
    _check_same(jeng, jrun, eng, run, calls)
    first = run["deltas"][0]
    assert first.get("kv_write") == 8 and "fused_prefill" not in first
    assert eng.stats["fused_prefill_dispatches"] == 0
    assert len(calls) == jeng.rng_ctr


def test_eager_mamba2_matches_jax():
    """A 2-layer mamba2: the prompt's final state through the
    ``ssm_state_write`` kind (``eager_ssm_layer`` counted once per Mamba
    layer a request) and no KV write; the state arena ends with no row
    in use."""
    model = _model("mamba2-1.3b", num_layers=2)
    waves = _waves(model[1].vocab_size, lambda rid: 0.0)
    jeng, jrun, eng, run, calls = run_both(
        model, waves, page_size=PAGE, num_pages=64, fused_prefill=False)
    _check_same(jeng, jrun, eng, run, calls)
    first = run["deltas"][0]
    assert first.get("eager_ssm_layer") == 4 * 2
    assert first.get("ssm_state_write") == 4 * 2
    assert "kv_write" not in first


@pytest.mark.parametrize("fused_prefill", [True, False],
                         ids=["fused", "eager"])
def test_llava_served_as_jax(fused_prefill):
    """reduced llava-next-34b (2 layers; its patch projection unused)
    served text-only through the dense layout, as the JAX engine serves
    it: streams, deltas, ``rng_ctr`` and 0 pages at the end."""
    model = _model("llava-next-34b", num_layers=2)
    assert "patch_proj" in model[3]
    waves = _waves(model[1].vocab_size, lambda rid: float(rid == 2))
    jeng, jrun, eng, run, calls = run_both(
        model, waves, page_size=PAGE, num_pages=64,
        fused_prefill=fused_prefill)
    _check_same(jeng, jrun, eng, run, calls)


def _greedy_dense(cfg, params, prompt, new):
    """The JAX package's ``greedy_dense``: the dense prefill, then one
    dense decode a token."""
    pcfg = ParallelConfig(attention_impl="naive", remat="none")
    n = len(prompt)
    cache = T.init_cache(cfg, 1, n + new + 1, device="cpu")
    lg, cache, _ = T.forward(cfg, pcfg, params,
                             {"tokens": torch.from_numpy(prompt)[None]},
                             mode="prefill", cache=cache,
                             lengths=torch.tensor([n], dtype=torch.int32))
    out = [int(torch.argmax(lg[0, 0]))]
    for t in range(new - 1):
        pos = n + t
        lg, cache = T.forward(cfg, pcfg, params,
                              {"tokens": torch.tensor([[out[-1]]])},
                              mode="decode", cache=cache, write_pos=pos,
                              lengths=torch.tensor([pos + 1],
                                                   dtype=torch.int32))
        out.append(int(torch.argmax(lg[0, 0])))
    return out


@pytest.mark.parametrize("fused_prefill", [True, False],
                         ids=["fused", "eager"])
def test_engine_matches_dense_greedy(granite, fused_prefill):
    """The JAX package's ``test_matches_dense_greedy`` on the port: the
    dense forward's greedy stream equals the paged engine's."""
    _, cfg, _, params = granite
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 12).astype(np.int32)
    ref = _greedy_dense(cfg, params, prompt, 5)
    eng = E.PagedEngine(cfg, params, page_size=PAGE, num_pages=64,
                        device="cpu", fused_prefill=fused_prefill)
    eng.submit(E.Request(0, prompt, max_new_tokens=5, temperature=0.0))
    assert eng.run()[0] == ref
    assert eng.cache.pages_in_use == 0


def test_mla_is_refused_as_jax_refuses_it():
    """MLA stays refused, with or without the eager oracle, with the JAX
    engine's ``ValueError``."""
    jcfg, cfg = (jreduced(JARCHS["deepseek-v2-236b"]),
                 reduced(ARCHS["deepseek-v2-236b"]))
    for fused_prefill in (True, False):
        with pytest.raises(ValueError, match="MLA"):
            JE.PagedEngine(jcfg, {}, fused_prefill=fused_prefill)
        with pytest.raises(ValueError, match="MLA"):
            E.PagedEngine(cfg, {}, device="cpu",
                          fused_prefill=fused_prefill)
