"""Tensor-parallel serving of the port against the JAX package's.

The model is ``reduced(granite-3-8b, num_layers=2)`` (4/4 heads, d_ff
256, vocab 512) with the JAX ``init_params`` weights converted, the
model ``tests/test_sharded.py`` serves.

World 1 runs in this process over a one-rank gloo group: the mesh path
(vocab-parallel embedding and logits summed with exact zeros, the
row-parallel sums an identity at one rank) must give the host-local
engine's streams and arenas bit for bit, and the JAX engine's mesh-1
streams.

Worlds 2 and 4 run as spawned ranks over gloo
(``launch.mesh.run_ranks``, each run under its own time limit), every
rank teacher-forced by a reference's choices so all runs see the same
inputs: the JAX host-local engine's for the main workload, the port's
host-local engine's for the chunked (chunks of 8, mixed rounds,
4-round blocks) and prefix-cache workloads.  The row-parallel sums add
bf16 partials where the host-local engine rounds one contraction, so
logits are held at ``LOGIT_ATOL`` and each rank's own greedy choice
must be the reference token wherever the reference's top-1/top-2
margin exceeds ``MARGIN`` (the margin rule); every rank's logits and
streams must be the same.  The arenas, read mid-run and gathered over
the ranks, must equal the host-local engine's (forced alike): layer 0
bit for bit (the embedding sum is exact and each head's projection is
the host-local one), layer 1 within ``ARENA_ATOL`` (it reads layer 0's
reordered sums).  Each fused step counts one dispatch, attributed to
``kv/shard0`` ... ``kv/shard{N-1}``, each of which carries the JAX
engine's launch counts.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_ranks as R  # noqa: E402
from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.launch.mesh import make_local_mesh as jmesh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.launch.mesh import (make_local_mesh, process_group,  # noqa: E402
                                     run_ranks)
from repro_torch.models.params import from_jax_params  # noqa: E402
from repro_torch.serving.engine import PagedEngine, Request  # noqa: E402

# the reduced model's logits lie below 1, where bf16 spacing is 2**-8;
# the host-local port is within one such step of JAX, the sharded runs
# within about eight (0.032 at world 4: each row-parallel sum rounds
# its bf16 partials), and this allows about thirteen
LOGIT_ATOL = 0.05
MARGIN = 2 * LOGIT_ATOL
# choices of the main workload whose JAX top-1/top-2 gap exceeds MARGIN
MARGIN_DECIDED = 3
# the chunked and prefix workloads run more rounds over longer prompts,
# and at random init the attention softmax is nearly one-hot, so a
# reordered sum moves a row's weights further (0.08 measured at world
# 2); as tests/test_torch_prefix.py holds its longer runs
LONG_LOGIT_ATOL = 0.1
# layer 1's K/V reads layer 0's residual stream, whose attention-out and
# MLP-down sums add bf16 partials in another order: |k| < 8 here, bf16
# spacing 2**-5 in [4, 8), 0.125 (four steps) measured, and this allows
# eight
ARENA_ATOL = 0.25
# the int8 logit sum: one quantization in, one out (absmax / 254 each)
COMPRESSED_ATOL = LOGIT_ATOL + 0.02
RANK_TIMEOUT = 150.0
_WORLDS: dict = {}


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(JARCHS["granite-3-8b"], num_layers=2)
    cfg = reduced(ARCHS["granite-3-8b"], num_layers=2)
    jparams = jinit(JT.model_defs(jcfg), jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, np_params, from_jax_params(np_params, "cpu")


def _jax_run(jcfg, jparams, mesh=None):
    """The JAX engine on the main workload: streams, the logits of every
    choice (host-local only) and the owner breakdown."""
    calls = []
    orig = JE._select_tokens

    def select(logits, temps, seed, **kw):
        jax.debug.callback(lambda l: calls.append(np.asarray(l, np.float32)),
                           logits)
        return orig(logits, temps, seed, **kw)

    mp = pytest.MonkeyPatch()
    if mesh is None:
        mp.setattr(JE, "_select_tokens", select)
    try:
        eng = JE.PagedEngine(jcfg, jparams, page_size=R.PAGE, num_pages=64,
                             mesh=mesh)
        for i, p in enumerate(R.prompts(jcfg.vocab_size)):
            eng.submit(JE.Request(i, p, max_new_tokens=6, temperature=0.0))
        results = eng.run()
    finally:
        mp.undo()
    return results, calls, eng.cache.queue.snapshot(by_owner=True)


@pytest.fixture(scope="module")
def refs(model):
    """The references: JAX host-local on the main workload, the port's
    host-local engine on the others; and the port's host-local runs
    forced alike (for the arenas and launch deltas)."""
    jcfg, cfg, jparams, _, params = model
    jresults, jcalls, jowners = _jax_run(jcfg, jparams)
    tokens = {"main": [np.argmax(c, -1) for c in jcalls]}
    host = {}
    for name in ("chunked", "prefix"):
        free = R.serve(cfg, params, name, snap=False)
        tokens[name] = free["tokens"]
        host[name] = free
    host["main"] = R.serve(cfg, params, "main", ref_tokens=tokens["main"])
    for name in ("chunked", "prefix"):
        host[name] = R.serve(cfg, params, name, ref_tokens=tokens[name])
    return {"tokens": tokens, "jax_results": jresults, "jax_calls": jcalls,
            "jax_owners": jowners, "host": host}


def _world(model, refs, world):
    if world not in _WORLDS:
        _, cfg, _, np_params, _ = model
        bad = reduced(ARCHS["granite-3-8b"], num_layers=1, num_heads=3,
                      num_kv_heads=3)
        _WORLDS[world] = run_ranks(
            R.sharded_serving, world, backend="gloo", timeout=RANK_TIMEOUT,
            args=(cfg, np_params, refs["tokens"], bad))
    return _WORLDS[world]


def _check_choices(ours, ref_logits, atol=LOGIT_ATOL):
    """Logits at ``atol``, and the margin rule at twice it; returns the
    count of choices the margin decided."""
    assert len(ours) == len(ref_logits)
    sure_n = 0
    for a, b in zip(ours, ref_logits):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=atol)
        top2 = np.sort(b, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * atol
        np.testing.assert_array_equal(np.argmax(a, -1)[sure],
                                      np.argmax(b, -1)[sure])
        sure_n += int(sure.sum())
    return sure_n


def _check_arenas(ranked, host):
    for ours, ref in zip(ranked, host):
        assert ours.shape == ref.shape
        assert torch.equal(ours[0], ref[0]), "layer 0 K/V differ"
        torch.testing.assert_close(ours.float(), ref.float(), rtol=0,
                                   atol=ARENA_ATOL)


# ------------------------------- world 1 ------------------------------- #


@pytest.fixture(scope="module")
def world1(model):
    """Host-local and mesh-1 runs of the port, free-running, in this
    process (a one-rank gloo group)."""
    _, cfg, _, _, params = model
    host = R.serve(cfg, params, "main", snap=True)
    with process_group("gloo"):
        mesh = make_local_mesh(model=1)
        sharded = R.serve(cfg, params, "main", mesh=mesh)
        comp = R.serve(cfg, params, "main", mesh=mesh, snap=False,
                       compressed_collectives=True)
        disp = R.dispatches(cfg, params, mesh)
    return host, sharded, comp, disp


def test_mesh1_bit_identical_to_host_local_and_jax_mesh1(model, world1):
    jcfg, _, jparams, _, _ = model
    host, sharded, _, _ = world1
    assert sharded["results"] == host["results"]
    for a, b in zip(sharded["logits"], host["logits"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(sharded["arenas"], host["arenas"]):
        assert torch.equal(a, b)
    assert sharded["deltas"] == host["deltas"]
    jresults, _, _ = _jax_run(jcfg, jparams, mesh=jmesh(model=1))
    assert sharded["results"] == jresults


def test_mesh1_compressed_same_greedy_streams(model, refs, world1):
    host, _, comp, _ = world1
    assert comp["results"] == host["results"]
    _check_choices(comp["logits"], host["logits"], atol=COMPRESSED_ATOL)


def test_mesh1_owner_is_kv_and_one_dispatch_a_step(model, refs, world1):
    _, sharded, _, disp = world1
    owners = sharded["owners"]
    assert set(owners) == {"kv"}
    assert owners == refs["jax_owners"]
    assert disp["prefill"] == {"fused_prefill": 1}
    assert disp["decode"] == {"fused_decode": 1}
    assert disp["block"] == {"fused_decode_block": 4}
    assert sum(disp["block"].values()) / disp["block_tokens"] < 1.0


def test_mesh_refusals(model):
    """The JAX engine's refusals: compressed collectives without a mesh,
    SSM or MoE layouts, a mesh without a ``model`` axis (the eager
    prefill oracle under a mesh: ``test_torch_sharded_eager.py``)."""
    _, cfg, _, _, params = model
    with pytest.raises(ValueError, match="mesh"):
        PagedEngine(cfg, params, device="cpu", compressed_collectives=True)
    with process_group("gloo"):
        mesh = make_local_mesh(model=1)
        for arch in ("mamba2-1.3b", "llama4-scout-17b-a16e"):
            with pytest.raises(ValueError, match="dense-only"):
                PagedEngine(reduced(ARCHS[arch]), params, device="cpu",
                            mesh=mesh)

        class NoModel:
            shape = {"data": 1}
        with pytest.raises(ValueError, match="'model' axis"):
            PagedEngine(cfg, params, device="cpu", mesh=NoModel())


# ---------------------------- worlds 2 and 4 --------------------------- #


@pytest.mark.parametrize("world", [2, 4])
def test_streams_match_jax_under_margin_and_across_ranks(model, refs, world):
    ranks = _world(model, refs, world)
    checked = _check_choices(ranks[0]["main"]["logits"], refs["jax_calls"])
    assert checked == MARGIN_DECIDED, checked
    assert ranks[0]["main"]["results"] == refs["jax_results"]
    for r in ranks[1:]:
        for name in ("main", "chunked", "prefix", "compressed"):
            assert r[name]["results"] == ranks[0][name]["results"]
            for a, b in zip(r[name]["logits"], ranks[0][name]["logits"]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_arena_slices_match_host_heads(model, refs, world):
    ranks = _world(model, refs, world)
    _check_arenas(ranks[0]["main"]["arenas"], refs["host"]["main"]["arenas"])


@pytest.mark.parametrize("world", [2, 4])
def test_one_dispatch_a_step_and_owner_per_shard(model, refs, world):
    ranks = _world(model, refs, world)
    want = {k: v for k, v in refs["jax_owners"]["kv"].items() if v}
    for r in ranks:
        assert r["main"]["deltas"] == refs["host"]["main"]["deltas"]
        assert r["main"]["owners"] == {f"kv/shard{i}": want
                                       for i in range(world)}
        d = r["dispatch"]
        assert d["prefill"] == {"fused_prefill": 1}
        assert d["decode"] == {"fused_decode": 1}
        assert d["block"] == {"fused_decode_block": 4}
        assert sum(d["block"].values()) / d["block_tokens"] < 1.0


def test_compressed_logits_and_non_divisible_refusal_world2(model, refs):
    ranks = _world(model, refs, 2)
    _check_choices(ranks[0]["compressed"]["logits"], refs["jax_calls"],
                   atol=COMPRESSED_ATOL)
    for r in ranks:
        assert "not divisible" in r["refusal"]
        assert "num_heads" in r["refusal"]


@pytest.mark.parametrize("name", ["chunked", "prefix"])
def test_chunked_mixed_and_prefix_runs_world2(model, refs, name):
    ranks = _world(model, refs, 2)
    host = refs["host"][name]
    ours = ranks[0][name]
    _check_choices(ours["logits"], host["logits"], atol=LONG_LOGIT_ATOL)
    assert ours["deltas"] == host["deltas"]
    assert ours["stats"] == host["stats"]
    assert ours["pages_in_use"] == 0 == host["pages_in_use"]
    _check_arenas(ours["arenas"], host["arenas"])
    if name == "chunked":
        assert ours["stats"]["mixed_dispatches"] > 0
        assert ours["stats"]["multi_round_blocks"] > 0
    else:
        assert ours["stats"]["prefix_hits"] > 0
        assert any("page_zero_scan" in d for d in ours["deltas"])
