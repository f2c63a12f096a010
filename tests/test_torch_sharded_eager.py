"""The eager prefill oracle (``PagedEngine(fused_prefill=False)``) under
a tensor-parallel mesh, against the JAX engine's eager path.

The model and main workload of ``test_torch_sharded.py``
(``reduced(granite-3-8b, num_layers=2)``, the JAX ``init_params``
weights, three greedy prompts).  The JAX engine serves it with
``fused_prefill=False`` (the dense forward on global arrays); the port
runs the dense forward on each rank's slices (``transformer.forward
(tp=)``: local heads, the row-parallel sums and the vocab-parallel
embedding and logits of the fused steps), its dense cache the rank's
KV-head slice, which the ``kv_write`` flush puts in the rank's arenas.

* World 1 (this process, a one-rank gloo group): bit for bit with the
  host-local eager engine (streams, logits, arenas, launch deltas), and
  the JAX engine's streams.
* Worlds 2 and 4 (spawned gloo ranks), teacher-forced by the JAX eager
  engine's choices: every choice's logits within ``LOGIT_ATOL`` and the
  margin rule (``test_torch_sharded.py``'s constants and checks), the
  JAX streams, every rank's logits and streams the same; the K/V
  arenas gathered over the ranks equal world 1's, layer 0 bit for bit
  and layer 1 within ``ARENA_ATOL``; every step's launch delta equal to
  the JAX eager engine's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_ranks as R  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_local_mesh, process_group, run_ranks)
from test_torch_sharded import (RANK_TIMEOUT, _check_arenas,  # noqa: E402,F401
                                _check_choices, model)

EAGER = dict(fused_prefill=False)
_WORLDS: dict = {}


@pytest.fixture(scope="module")
def jax_eager(model):
    """The JAX engine's eager path on the main workload: streams, the
    logits of every choice and every step's launch delta."""
    jcfg, _, jparams, _, _ = model
    calls = []
    orig = JE._select_tokens

    def select(logits, temps, seed, **kw):
        jax.debug.callback(lambda l: calls.append(np.asarray(l, np.float32)),
                           logits)
        return orig(logits, temps, seed, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(JE, "_select_tokens", select)
    try:
        eng = JE.PagedEngine(jcfg, jparams, page_size=R.PAGE, num_pages=64,
                             **EAGER)
        for i, p in enumerate(R.prompts(jcfg.vocab_size)):
            eng.submit(JE.Request(i, p, max_new_tokens=6, temperature=0.0))
        q = eng.cache.queue
        results, deltas = {}, []
        while eng.has_work:
            before = q.snapshot()
            results.update(eng.run(max_rounds=1))
            deltas.append(q.delta(before))
    finally:
        mp.undo()
    return {"results": results, "logits": calls, "deltas": deltas,
            "tokens": [np.argmax(c, -1) for c in calls]}


@pytest.fixture(scope="module")
def world1(model, jax_eager):
    """The port's host-local and mesh-1 eager runs, forced by the JAX
    choices, in this process."""
    _, cfg, _, _, params = model
    host = R.serve(cfg, params, "main", ref_tokens=jax_eager["tokens"],
                   **EAGER)
    with process_group("gloo"):
        mesh = make_local_mesh(model=1)
        sharded = R.serve(cfg, params, "main", mesh=mesh,
                          ref_tokens=jax_eager["tokens"], **EAGER)
    return host, sharded


def _world(model, jax_eager, world):
    if world not in _WORLDS:
        _, cfg, _, np_params, _ = model
        _WORLDS[world] = run_ranks(
            R.sharded_eager, world, backend="gloo", timeout=RANK_TIMEOUT,
            args=(cfg, np_params, jax_eager["tokens"]))
    return _WORLDS[world]


def test_eager_mesh1_bit_identical_to_host_local(model, jax_eager, world1):
    host, sharded = world1
    assert sharded["results"] == host["results"] == jax_eager["results"]
    for a, b in zip(sharded["logits"], host["logits"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(sharded["arenas"], host["arenas"]):
        assert torch.equal(a, b)
    assert sharded["deltas"] == host["deltas"] == jax_eager["deltas"]


@pytest.mark.parametrize("world", [2, 4])
def test_eager_streams_match_jax_under_margin(model, jax_eager, world):
    ranks = _world(model, jax_eager, world)
    assert _check_choices(ranks[0]["logits"], jax_eager["logits"]) >= 1
    assert ranks[0]["results"] == jax_eager["results"]
    for r in ranks[1:]:
        assert r["results"] == ranks[0]["results"]
        for a, b in zip(r["logits"], ranks[0]["logits"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_eager_arenas_and_launch_deltas(model, jax_eager, world1, world):
    ranks = _world(model, jax_eager, world)
    _check_arenas(ranks[0]["arenas"], world1[0]["arenas"])
    for r in ranks:
        assert r["deltas"] == jax_eager["deltas"]
        assert r["pages_in_use"] == 0
