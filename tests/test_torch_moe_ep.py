"""Expert-parallel MoE of the port against the JAX package's.

``_local_moe`` is the JAX package's ``shard_map`` body: routing, the
capacity-bounded cumsum dispatch over one rank's experts, the batched
expert FFN and the weighted scatter-add, then the sum over ``model``.
It runs here on ``reduced(llama4-scout-17b-a16e)`` widths (8 experts,
d_model 128, expert d_ff 128, top-2 routing so two choices of a token
rank within an expert), with inputs made from a seed with numpy:

* ``model_axis=None`` (one shard holding every expert) against the JAX
  function on the same inputs, with ample capacity and with a capacity
  that drops tokens (the dispatch table must drop the same ones);
* at world 2 over gloo (spawned ranks, each under a time limit), each
  rank on its four experts: the sum over the ranks equals JAX's
  single-shard body, since every expert sees the same tokens at the
  same ranks whichever rank holds it (float32 and bfloat16 sums);
* ``moe_layer`` under a mesh-1 ``sharding_env`` and at world 2 against
  the dense oracle with ample capacity, as ``tests/test_models.py``
  holds the JAX layer.

Tolerances: the expert FFN runs in bf16 (outputs |y| < 1, spacing
2**-8 there) and the two packages' float32 scatter-adds sum in other
orders, so outputs are held at ``ATOL``; the bf16 sum over ranks rounds
each rank's partial once more (``BF16_ATOL``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks as R  # noqa: E402
from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro_torch.configs import ARCHS, ParallelConfig, reduced  # noqa: E402
from repro_torch.distributed.sharding import sharding_env  # noqa: E402
from repro_torch.launch.mesh import (make_local_mesh, process_group,  # noqa: E402
                                     run_ranks)
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.layers import cast  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402

ATOL = 2e-2
BF16_ATOL = 3e-2
AUX_RTOL = 1e-5
TOKENS = (2, 16)
_RANKS: dict = {}


def _top2(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            top_k=2))


@pytest.fixture(scope="module")
def moe():
    jcfg = _top2(jreduced(JARCHS["llama4-scout-17b-a16e"]))
    cfg = _top2(reduced(ARCHS["llama4-scout-17b-a16e"]))
    jp = jinit(JM.moe_defs(jcfg), jax.random.PRNGKey(3))
    np_p = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(TOKENS + (cfg.d_model,)).astype(np.float32))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    x_np = np.asarray(jx)
    return jcfg, cfg, jp, np_p, jx, x_np


def _jax_local(jcfg, jp, jx, capacity, psum_dtype=jnp.float32):
    m = jcfg.moe
    from repro.models.layers import cast as jcast
    y, aux = JM._local_moe(jx, jp["router"].astype(jnp.float32),
                           jcast(jp["w_gate"]), jcast(jp["w_up"]),
                           jcast(jp["w_down"]), top_k=m.top_k,
                           num_experts=m.num_experts, capacity=capacity,
                           activation=jcfg.activation, model_axis=None,
                           psum_dtype=psum_dtype)
    return np.asarray(y, np.float32), float(aux)


def _port_local(cfg, np_p, x_np, capacity):
    p = from_jax_params(np_p, "cpu")
    x = from_jax_params(x_np, "cpu")
    m = cfg.moe
    y, aux = M._local_moe(x, p["router"].float(), cast(p["w_gate"]),
                          cast(p["w_up"]), cast(p["w_down"]), top_k=m.top_k,
                          num_experts=m.num_experts, capacity=capacity,
                          activation=cfg.activation)
    return y.float().numpy(), float(aux)


@pytest.mark.parametrize("capacity", [32, 3])
def test_local_moe_one_shard_matches_jax(moe, capacity):
    """Ample capacity (32: no drops) and 3 (drops): same table, same
    outputs, same aux."""
    jcfg, cfg, jp, np_p, jx, x_np = moe
    ref, ref_aux = _jax_local(jcfg, jp, jx, capacity)
    ours, aux = _port_local(cfg, np_p, x_np, capacity)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    assert aux == pytest.approx(ref_aux, rel=AUX_RTOL)
    # a dropped token's output row is exactly zero in both
    np.testing.assert_array_equal(ours == 0, ref == 0)


def test_top_k_ties_break_to_lower_expert():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    _, top_e = M._top_k(probs, 2)
    _, jtop = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop))


def _world2(moe):
    if not _RANKS:
        _, cfg, _, np_p, _, x_np = moe
        _RANKS[2] = run_ranks(R.moe_ranks, 2, backend="gloo", timeout=120.0,
                              args=(cfg, np_p, x_np, (32, 3)))
    return _RANKS[2]


@pytest.mark.parametrize("capacity", [32, 3])
def test_world2_sum_equals_jax_single_shard(moe, capacity):
    jcfg, _, jp, _, jx, _ = moe
    ref, ref_aux = _jax_local(jcfg, jp, jx, capacity)
    ranks = _world2(moe)
    for r in ranks:
        y, aux = r[("f32", capacity)]
        np.testing.assert_allclose(y.numpy(), ref, atol=ATOL, rtol=0)
        assert aux == pytest.approx(ref_aux, rel=AUX_RTOL)
    torch.testing.assert_close(ranks[0][("f32", capacity)][0],
                               ranks[1][("f32", capacity)][0], rtol=0, atol=0)


def test_world2_bf16_sum(moe):
    jcfg, _, jp, _, jx, _ = moe
    ref, _ = _jax_local(jcfg, jp, jx, 32, psum_dtype=jnp.bfloat16)
    for r in _world2(moe):
        np.testing.assert_allclose(r[("bf16", 32)][0].numpy(), ref,
                                   atol=BF16_ATOL, rtol=0)


def _dense(cfg, np_p, x_np):
    big = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    p = from_jax_params(np_p, "cpu")
    x = from_jax_params(x_np, "cpu")
    y, aux = M.moe_layer(big, ParallelConfig(moe_impl="dense"), p, x)
    return big, p, x, y.float(), float(aux)


def test_moe_layer_mesh1_matches_dense_oracle_and_jax(moe):
    jcfg, cfg, jp, np_p, jx, x_np = moe
    big, p, x, dense, dense_aux = _dense(cfg, np_p, x_np)
    with process_group("gloo"):
        with sharding_env(make_local_mesh(model=1), fsdp=False):
            ep, ep_aux = M.moe_layer(big, ParallelConfig(), p, x)
    torch.testing.assert_close(ep.float(), dense, rtol=3e-2, atol=3e-2)
    assert ep_aux == pytest.approx(dense_aux, rel=1e-3)
    # the JAX layer under its own mesh-1 env, on the same inputs
    from repro.distributed.sharding import sharding_env as jenv
    from repro.launch.mesh import make_local_mesh as jmesh
    from repro.configs.base import ParallelConfig as JPC
    jbig = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=8.0))
    with jenv(jmesh(data=1, model=1), fsdp=False):
        jy, jaux = JM.moe_layer(jbig, JPC(moe_impl="shard_map"), jp, jx)
    np.testing.assert_allclose(ep.float().numpy(), np.asarray(jy, np.float32),
                               atol=ATOL, rtol=0)
    assert ep_aux == pytest.approx(float(jaux), rel=AUX_RTOL)


def test_moe_layer_world2_matches_dense_oracle(moe):
    _, cfg, _, np_p, _, x_np = moe
    _, _, _, dense, dense_aux = _dense(cfg, np_p, x_np)
    for r in _world2(moe):
        y, aux = r["layer"]
        torch.testing.assert_close(y, dense, rtol=3e-2, atol=3e-2)
        assert aux == pytest.approx(dense_aux, rel=1e-3)


def test_non_divisible_mesh_takes_the_dense_form(moe):
    """Eight experts over a 3-way ``model`` axis: the dense form (the
    JAX layer's fallback), checked through a mesh stub (``moe_layer``
    reads only the mesh's shape before choosing)."""
    _, cfg, _, np_p, _, x_np = moe
    big, p, x, dense, _ = _dense(cfg, np_p, x_np)

    class Three:
        shape = {"data": 1, "model": 3}

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    with sharding_env(Three(), fsdp=False):
        y, _ = M.moe_layer(big, ParallelConfig(), p, x)
    torch.testing.assert_close(y.float(), dense, rtol=0, atol=0)
