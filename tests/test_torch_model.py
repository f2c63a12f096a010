"""The port's model pieces against the JAX package's, on the reduced
GQA granite model (2 layers, 4 query heads over 2 kv heads).

Weights come from the JAX ``init_params`` through ``from_jax_params``
(torch cannot reproduce ``jax.random``).  Both packages compute in bf16
from fp32 masters, rounding at the same places, but their matmuls sum
in different orders, so results agree to bf16 tolerance: 2e-2
relative for single layers (a few bf16 roundings of O(1) values) and
atol 5e-2 on logits, whose magnitude here is below 2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS, ParallelConfig as JPCFG  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import layers as JL, transformer as JT  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.configs import ARCHS, ParallelConfig, reduced  # noqa: E402
from repro_torch.models import layers as L, transformer as T  # noqa: E402
from repro_torch.models.params import (from_jax_params, init_params,  # noqa: E402
                                       numpy_to_torch, param_count,
                                       torch_to_numpy, tree_leaves)
from repro_torch.serving import engine as E  # noqa: E402

LOGIT_ATOL = 5e-2
LAYER_TOL = 2e-2


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(JARCHS["granite-3-8b"], num_layers=2, num_kv_heads=2)
    cfg = reduced(ARCHS["granite-3-8b"], num_layers=2, num_kv_heads=2)
    jparams = jinit(JT.model_defs(jcfg), jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


def _bf16(rng, shape):
    return jnp.asarray(rng.normal(size=shape), jnp.bfloat16)


def test_config_copy_matches_jax():
    assert sorted(ARCHS) == sorted(JARCHS)
    for name, jcfg in JARCHS.items():
        assert repr(ARCHS[name]) == repr(jcfg)


def test_model_defs_match_jax(model):
    jcfg, cfg, _, _ = model
    jleaves = jax.tree_util.tree_flatten_with_path(
        JT.model_defs(jcfg), is_leaf=lambda x: hasattr(x, "laxes"))[0]
    ours = list(tree_leaves(T.model_defs(cfg)))
    assert [d.shape for _, d in ours] == [d.shape for _, d in jleaves]
    assert [d.init for _, d in ours] == [d.init for _, d in jleaves]
    assert param_count(T.model_defs(cfg)) == JP.param_count(
        JT.model_defs(jcfg))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_from_jax_params_round_trips_bits(model, dtype):
    _, _, jparams, _ = model
    np_tree = jax.tree.map(lambda a: np.asarray(a.astype(dtype)), jparams)
    params = from_jax_params(np_tree, "cpu")
    jl = jax.tree_util.tree_leaves(np_tree)
    tl = [t for _, t in tree_leaves(params)]
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        back = torch_to_numpy(t)
        want = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        assert back.dtype == want.dtype and back.shape == want.shape
        np.testing.assert_array_equal(back, want)


def test_init_params_follows_the_defs():
    cfg = reduced(ARCHS["granite-3-8b"], num_layers=2, num_kv_heads=2)
    defs = T.model_defs(cfg)
    gen = torch.Generator().manual_seed(0)
    params = init_params(defs, gen, "cpu", torch.bfloat16)
    for (path, d), (_, t) in zip(tree_leaves(defs), tree_leaves(params)):
        assert tuple(t.shape) == d.shape and t.dtype == torch.bfloat16, path
    assert torch.all(params["final_norm"] == 1)
    std = params["embed"]["tok"].float().std().item()
    assert 0.015 < std < 0.025          # the "normal" scheme: 0.02
    again = init_params(defs, torch.Generator().manual_seed(0), "cpu",
                        torch.bfloat16)
    assert torch.equal(again["group0"]["0_attn"]["attn"]["wq"],
                       params["group0"]["0_attn"]["attn"]["wq"])


def test_entry_points_need_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        numpy_to_torch(np.zeros(2, np.float32))


def test_norm_rope_mlp_match_jax():
    rng = np.random.default_rng(0)
    x = _bf16(rng, (2, 5, 64))
    scale = _bf16(rng, (64,))
    np.testing.assert_allclose(
        _f32(L.rmsnorm(numpy_to_torch(np.asarray(x), "cpu"),
                       numpy_to_torch(np.asarray(scale), "cpu"), 1e-6)),
        _f32(JL.rmsnorm(x, scale, 1e-6)), rtol=LAYER_TOL, atol=LAYER_TOL)
    pos = np.arange(10, dtype=np.int32).reshape(2, 5)
    s, c = L.rope_sincos(torch.from_numpy(pos), 32, 10_000.0)
    js, jc = JL.rope_sincos(jnp.asarray(pos), 32, 10_000.0)
    np.testing.assert_allclose(_f32(s), _f32(js), atol=1e-5)
    np.testing.assert_allclose(_f32(c), _f32(jc), atol=1e-5)
    q = _bf16(rng, (2, 5, 4, 32))
    np.testing.assert_allclose(
        _f32(L.apply_rope(numpy_to_torch(np.asarray(q), "cpu"), s, c)),
        _f32(JL.apply_rope(q, js, jc)), rtol=LAYER_TOL, atol=LAYER_TOL)
    p = {k: _bf16(rng, shp) * 0.1 for k, shp in
         (("up", (64, 96)), ("gate", (64, 96)), ("down", (96, 64)))}
    tp = {k: numpy_to_torch(np.asarray(v), "cpu") for k, v in p.items()}
    np.testing.assert_allclose(
        _f32(L.mlp(tp, numpy_to_torch(np.asarray(x), "cpu"), "swiglu")),
        _f32(JL.mlp(p, x, "swiglu")), rtol=LAYER_TOL, atol=LAYER_TOL)


def test_one_decoder_layer_matches_jax(model):
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(1)
    B, S = 2, 7
    x = _bf16(rng, (B, S, cfg.d_model))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    js, jc = JL.rope_sincos(jnp.asarray(pos), cfg.head_dim, cfg.rope_theta)
    s, c = L.rope_sincos(torch.from_numpy(pos.copy()), cfg.head_dim,
                         cfg.rope_theta)
    from repro.kernels.flash_attention import ref as jfa
    from repro_torch.kernels.flash_attention import ref as fa

    def jattend(q, k, v):
        o = jfa.attention(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                          v.transpose(0, 2, 1, 3), causal=True)
        return o.transpose(0, 2, 1, 3)

    def attend(q, k, v):
        return fa.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True).transpose(1, 2)

    jl = jax.tree.map(lambda a: a[0], jparams["group0"])
    tl = E._layer(params["group0"], 0)
    jy, jy_kv = JE._run_kinds(jcfg, JPCFG(), ("attn", "mlp"), jl, x, js, jc,
                              jattend, None, None, None)[:2]
    y, kv = E._run_kinds(cfg, tl, numpy_to_torch(np.asarray(x), "cpu"), s, c,
                         attend)
    np.testing.assert_allclose(_f32(y), _f32(jy), rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    for a, b in zip(kv, jy_kv):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=LAYER_TOL,
                                   atol=LAYER_TOL)


def test_prefill_forward_logits_match_jax(model):
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    lens = np.asarray([16, 9], np.int32)
    jlogits, jk, _, _, _ = JE._prefill_forward(
        jcfg, JPCFG(attention_impl="naive", remat="none"), jparams,
        jnp.asarray(toks), jnp.asarray(lens), use_pallas=False)
    logits, k, _ = E._prefill_forward(cfg, ParallelConfig(), params,
                                      torch.from_numpy(toks),
                                      torch.from_numpy(lens))
    assert logits.dtype == torch.float32 and logits.shape == jlogits.shape
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), atol=LOGIT_ATOL)
    np.testing.assert_allclose(_f32(k), _f32(jk), atol=LAYER_TOL * 5,
                               rtol=LAYER_TOL)
