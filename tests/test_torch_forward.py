"""The port's unified forward (``models/transformer.py``) and attention
(``models/attention.py``) against the JAX package's, at ``reduced()``
sizes on the CPU.

Weights come from the JAX ``init_params`` through ``from_jax_params``;
inputs are made from a seed with numpy and handed to both packages.

* ``forward(mode="train")`` logits for every family: dense (granite),
  moe with a leading dense layer (llama4-scout), moe with MLA
  (deepseek), ssm (mamba2), hybrid (jamba, one period), vlm with patch
  embeds (llava) and encdec with frames (seamless).  Both packages run
  with their compute dtype set to float32 (each ``layers.COMPUTE_DTYPE``
  patched for the test), so the comparison isolates the algorithm:
  logits agree to 1e-3 (float32 sums in other orders; measured below
  1e-4).  In bf16 the two frameworks' matmuls round their sums in other
  orders, and at encdec's residual magnitude (~60, where a bf16 step is
  0.25) a one-step difference reaches the logits as up to 0.08;
* prefill and then decode against the full forward, in bf16 (the
  oracle of the JAX package's ``tests/test_models.py``, at its 3e-2),
  the prefill logits also against JAX's prefill at 3e-2, and the
  absorbed MLA decode (8e-2, as there: it reorders bf16 matmuls);
* the tiled ``chunked_attention`` forward and ``naive_attention``
  against JAX's, and ``cache_spec`` against JAX's shapes and dtypes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS, ParallelConfig as JPCFG  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import attention as JA, layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro_torch.configs import ARCHS, ParallelConfig, reduced  # noqa: E402
from repro_torch.models import attention as A, layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import from_jax_params, tree_leaves  # noqa: E402

TOL = 3e-2
MLA_TOL = 8e-2
F32_TOL = 1e-3
KW = dict(remat="none", attention_impl="naive", moe_impl="dense")
JP, P = JPCFG(**KW), ParallelConfig(**KW)
# family -> (arch, reduced() overrides)
FAMILIES = {
    "dense": ("granite-3-8b", dict(num_layers=2)),
    "moe": ("llama4-scout-17b-a16e", dict(num_layers=2)),
    "mla": ("deepseek-v2-236b", dict(num_layers=2)),
    "ssm": ("mamba2-1.3b", dict(num_layers=2)),
    "hybrid": ("jamba-1.5-large-398b", dict(num_layers=4, attn_every=4)),
    "vlm": ("llava-next-34b", dict(num_layers=2)),
    "encdec": ("seamless-m4t-medium", {}),
}


def _model(family, seed=0):
    arch, kw = FAMILIES[family]
    jcfg, cfg = jreduced(JARCHS[arch], **kw), reduced(ARCHS[arch], **kw)
    if cfg.moe is not None and family == "moe":
        # a leading dense layer: the two-group layout
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, first_dense_layers=1))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, first_dense_layers=1))
    jparams = jinit(JT.model_defs(jcfg), jax.random.PRNGKey(seed))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _batch(cfg, B, S, seed=1):
    """numpy inputs: tokens, and the stub frontends' embeddings."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    fd = cfg.frontend_dim or cfg.d_model
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patch_tokens, fd)).astype(np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.normal(size=(B, 8, fd)).astype(np.float32)
    return b


def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_logits_match_jax(family, monkeypatch):
    """``forward(mode="train")`` on weights carried across, both packages
    computing in float32: logits and the MoE aux loss within 1e-3 of
    JAX's, and the parameter trees leaf for leaf (``from_jax_params``
    carries the frontends' and the MLA leaves)."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    jcfg, cfg, jparams, params = _model(family)
    assert [p for p, _ in tree_leaves(T.model_defs(cfg))] == \
        [p for p, _ in tree_leaves(params)]
    jb, tb = _both(_batch(cfg, 2, 12))
    want, jaux = JT.forward(jcfg, JP, jparams, jb, mode="train")
    got, aux = T.forward(cfg, P, params, tb, mode="train")
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == torch.float32
    _close(got, want, tol=F32_TOL, what=family)
    _close(aux, jaux, tol=F32_TOL, what=f"{family} aux")


@pytest.mark.parametrize("family", ["dense", "hybrid", "encdec"])
def test_prefill_then_decode_matches_full_forward(family):
    """Prefill 8 tokens into a zeroed cache, then decode 2 one at a time:
    each step's logits equal the full forward's at that position (the
    JAX package's oracle), and the prefill logits equal JAX's prefill."""
    jcfg, cfg, jparams, params = _model(family)
    B, S, MAX = 2, 8, 16
    full = _batch(cfg, B, S + 2)
    extra = {k: torch.from_numpy(v) for k, v in full.items()
             if k != "tokens"}
    toks = torch.from_numpy(full["tokens"])
    ref, _ = T.forward(cfg, P, params, {"tokens": toks, **extra},
                       mode="train")
    enc = 8 if cfg.family == "encdec" else 0
    cache = T.init_cache(cfg, B, MAX, enc_len=enc, device="cpu")
    lens = torch.full((B,), S, dtype=torch.int32)
    lg, cache, _ = T.forward(cfg, P, params, {"tokens": toks[:, :S], **extra},
                             mode="prefill", cache=cache, lengths=lens)
    _close(lg[:, 0], ref[:, S - 1].numpy(), what="prefill")
    jcache = JT.init_cache(jcfg, B, MAX, enc_len=enc)
    jextra = {k: jnp.asarray(v) for k, v in full.items() if k != "tokens"}
    jlg, _, _ = JT.forward(jcfg, JP, jparams,
                           {"tokens": jnp.asarray(full["tokens"][:, :S]),
                            **jextra}, mode="prefill", cache=jcache,
                           lengths=jnp.full((B,), S, jnp.int32))
    _close(lg, jlg, what="prefill vs JAX")
    for t in range(2):
        pos = S + t
        lg, cache = T.forward(cfg, P, params,
                              {"tokens": toks[:, pos:pos + 1]},
                              mode="decode", cache=cache, write_pos=pos,
                              lengths=torch.full((B,), pos + 1,
                                                 dtype=torch.int32))
        _close(lg[:, 0], ref[:, pos].numpy(), what=f"decode {t}")


def test_mla_absorbed_decode_matches_full_forward():
    """deepseek's MLA: prefill expands the latent, decode runs absorbed
    against the (c_kv, k_rope) cache; the decode logits equal the full
    forward's within 8e-2 (it reorders bf16 matmuls) and JAX's absorbed
    decode within 3e-2."""
    jcfg, cfg, jparams, params = _model("mla")
    B, S, MAX = 2, 8, 16
    toks_np = _batch(cfg, B, S + 1)["tokens"]
    toks = torch.from_numpy(toks_np)
    ref, _ = T.forward(cfg, P, params, {"tokens": toks}, mode="train")
    cache = T.init_cache(cfg, B, MAX, device="cpu")
    assert cache["group0"]["0_mla"][0].shape == (1, B, MAX,
                                                 cfg.mla.kv_lora_rank)
    lens = torch.full((B,), S, dtype=torch.int32)
    lg, cache, _ = T.forward(cfg, P, params, {"tokens": toks[:, :S]},
                             mode="prefill", cache=cache, lengths=lens)
    _close(lg[:, 0], ref[:, S - 1].numpy(), what="prefill")
    lg, _ = T.forward(cfg, P, params, {"tokens": toks[:, S:S + 1]},
                      mode="decode", cache=cache, write_pos=S,
                      lengths=lens + 1)
    _close(lg[:, 0], ref[:, S].numpy(), tol=MLA_TOL, what="decode")
    jcache = JT.init_cache(jcfg, B, MAX)
    _, jcache, _ = JT.forward(jcfg, JP, jparams,
                              {"tokens": jnp.asarray(toks_np[:, :S])},
                              mode="prefill", cache=jcache,
                              lengths=jnp.full((B,), S, jnp.int32))
    jlg, _ = JT.forward(jcfg, JP, jparams,
                        {"tokens": jnp.asarray(toks_np[:, S:S + 1])},
                        mode="decode", cache=jcache,
                        write_pos=jnp.asarray(S),
                        lengths=jnp.full((B,), S + 1, jnp.int32))
    _close(lg, jlg, what="decode vs JAX")


def test_attention_paths_match_jax():
    """The tiled forward (4 x 8 tiles, a ragged last tile, per-row
    lengths, a q offset, causal and not) and the naive path against
    JAX's on one float32 input; decode attention at per-row lengths."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 11, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 19, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 19, 2, 16)).astype(np.float32)
    lens = np.asarray([19, 13], np.int32)
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lens))
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, k, v, lens))
    for causal, off in ((True, 8), (False, 0)):
        want = JA.chunked_attention(jq, jk, jv, causal=causal, chunk_q=4,
                                    chunk_k=8, q_offset=off, lengths=jl)
        got = A.chunked_attention(tq, tk, tv, causal=causal, chunk_q=4,
                                  chunk_k=8, q_offset=off, lengths=tl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        naive = A.naive_attention(tq, tk, tv, causal=causal, lengths=tl,
                                  q_offset=off)
        np.testing.assert_allclose(naive.numpy(), np.asarray(
            JA.naive_attention(jq, jk, jv, causal=causal, lengths=jl,
                               q_offset=off)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), naive.numpy(), rtol=1e-5,
                                   atol=1e-5)
    got = A.decode_attention(tq[:, :1], tk, tv, tl)
    want = JA.decode_attention(jq[:, :1], jk, jv, jl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cache_spec_matches_jax():
    """Every family's cache spec (groups, keys, shapes, dtypes) equals
    the JAX package's; ``init_cache`` allocates it zeroed on the device
    asked for, and without a card refuses the default device."""
    for family in sorted(FAMILIES):
        jcfg, cfg = (jreduced(JARCHS[FAMILIES[family][0]]),
                     reduced(ARCHS[FAMILIES[family][0]]))
        want = JT.cache_spec(jcfg, 2, 16, enc_len=8)
        got = T.cache_spec(cfg, 2, 16, enc_len=8)
        mine = [(f"{p}/{i}", tuple(s.shape), str(s.dtype).split(".")[-1])
                for p, pair in tree_leaves(got) for i, s in enumerate(pair)]
        assert mine == _jax_flat(want), family
        cache = T.init_cache(cfg, 2, 16, enc_len=8, device="cpu")
        for _, pair in tree_leaves(cache):
            assert all(t.device.type == "cpu" and not t.any() for t in pair)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            T.init_cache(cfg, 1, 4)


def _jax_flat(spec):
    """(path/index, shape, dtype name) of a JAX cache spec's leaves."""
    out = []
    for g in sorted(spec):
        for key in sorted(spec[g]):
            for i, s in enumerate(spec[g][key]):
                out.append((f"{g}/{key}/{i}", tuple(s.shape), str(s.dtype)))
    return out
