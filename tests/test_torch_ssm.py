"""The port's Mamba-2 layer, dense MoE, parameter trees and state-arena
ops against the JAX package.

Layer level (the reduced configs of ``tests/test_hybrid.py``: mamba2
with SSD chunk size 4, jamba cut to one 4-layer period, llama4-scout
reduced), inputs from numpy seeds, JAX weights converted bit for bit:
``_causal_conv`` with and without a carried window, ``_ssd_chunked``
over several chunks with a pad and an ``init`` state, ``ssm_layer``
decode and prefill, ``ssm_layer_paged`` on a batch whose ``lengths`` stop short of
the padded length (the state must pass the pad unchanged), and
``_dense_moe`` at top-2 (jamba) and top-1 with a shared expert (scout),
whose inputs must route to the same experts as JAX's.  Tolerances, all
on values of order 1:

* bf16 outputs: ``BF16_TOL`` (2**-6, two steps of bf16's 2**-8
  relative spacing: both packages round the same bf16 products, but
  XLA on the CPU may keep a fused chain in float32 and round once);
* float32 outputs (the SSD scan, its state): ``F32_TOL``; the two
  packages sum the same terms in another order (and cumsum differently).

Parameter trees: ``model_defs`` of the three families leaf for leaf
(path, shape, axes, init) and ``from_jax_params`` bit for bit.

Kernel level: ``state_scatter_inline``, ``pim_state_copy`` and
``pim_state_init`` (the plain versions a CPU tensor runs) bit for bit
against the JAX package's reference and its Pallas kernel in interpret
mode, a lone ``-0.0`` and an in-place pad duplicate included, and the
empty batch as a no-op.  The CUDA kernel has no CPU mode: its test needs
the card and skips here.  JAX is imported in fixtures only, so that
test also runs where JAX is not installed (``--noconftest -m cuda``).
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, ParallelConfig, reduced  # noqa: E402
from repro_torch.core.pim_queue import PimOpQueue  # noqa: E402
from repro_torch.core.op_registry import StateWriteBatch  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launches  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ss_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as ss_ref  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import (from_jax_params,  # noqa: E402
                                       numpy_to_torch, torch_to_numpy,
                                       tree_leaves)

BF16_TOL = 2 ** -6
F32_TOL = 1e-4
FAMILIES = {"ssm": ("mamba2-1.3b", dict(num_layers=2)),
            "hybrid": ("jamba-1.5-large-398b",
                       dict(num_layers=4, attn_every=4)),
            "moe": ("llama4-scout-17b-a16e", dict(num_layers=2))}


def chunk4(cfg):
    """SSD chunk size 4, so chunked prefill at multiples of 4 is legal
    (``tests/test_hybrid.py``)."""
    if cfg.ssm is None:
        return cfg
    return dataclasses.replace(cfg,
                               ssm=dataclasses.replace(cfg.ssm, chunk_size=4))


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import ARCHS as JARCHS, ParallelConfig as JPCFG
    from repro.configs import reduced as jreduced
    from repro.kernels.ssm_scan import ops as jss
    from repro.models import moe as JM
    from repro.models import ssm as JS
    from repro.models import transformer as JT
    from repro.models.params import init_params as jinit
    return types.SimpleNamespace(jax=jax, jnp=jnp, ARCHS=JARCHS,
                                 PCFG=JPCFG, reduced=jreduced, ss=jss,
                                 M=JM, S=JS, T=JT, init=jinit)


@pytest.fixture(scope="module")
def models(jx):
    """family -> (jax cfg, port cfg, jax params, port params)."""
    out = {}
    for fam, (arch, kw) in FAMILIES.items():
        jcfg = chunk4(jx.reduced(jx.ARCHS[arch], **kw))
        cfg = chunk4(reduced(ARCHS[arch], **kw))
        jparams = jx.init(jx.T.model_defs(jcfg), jx.jax.random.PRNGKey(0))
        params = from_jax_params(jx.jax.tree.map(np.asarray, jparams),
                                 "cpu")
        out[fam] = (jcfg, cfg, jparams, params)
    return out


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _bf16(jx, x):
    """One numpy array as a JAX bf16 array and the same bits in torch."""
    j = jx.jnp.asarray(x, jx.jnp.bfloat16)
    return j, numpy_to_torch(np.asarray(j), "cpu")


def _bits(a):
    """An array's bits as the signed integer of its width (torch bf16
    tensors come back from ``torch_to_numpy`` as int16 already)."""
    a = torch_to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _mamba_params(jx, models, fam="ssm"):
    """Layer 0's Mamba parameters of ``fam`` in both packages."""
    jcfg, cfg, jparams, params = models[fam]
    key = next(k for k in jparams["group0"] if k.endswith("_mamba"))
    jp = jx.jax.tree.map(lambda a: a[0], jparams["group0"][key]["ssm"])
    tp = {k: v[0] for k, v in params["group0"][key]["ssm"].items()}
    return jcfg, cfg, jp, tp


# ------------------------------------------------------------------ #
# The Mamba-2 layer
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("window", [False, True])
def test_causal_conv_matches_jax(jx, models, window):
    jcfg, cfg, jp, tp = _mamba_params(jx, models)
    rng = np.random.default_rng(1)
    ch = tp["conv_w"].shape[1]
    W = tp["conv_w"].shape[0]
    jxbc, xbc = _bf16(jx, rng.standard_normal((3, 7, ch)))
    jw, w = _bf16(jx, rng.standard_normal((W, ch)) * 0.5)
    b = rng.standard_normal(ch).astype(np.float32)
    jstate = state = None
    if window:
        jstate, state = _bf16(jx, rng.standard_normal((3, W - 1, ch)))
    jout, jnew = jx.S._causal_conv(jxbc, jw, jx.jnp.asarray(b), jstate)
    out, new = S._causal_conv(xbc, w, torch.from_numpy(b), state)
    _close(out, jout, BF16_TOL)
    # the window is data movement: bit for bit
    np.testing.assert_array_equal(_f32(new), _f32(jnew))


def test_ssd_chunked_matches_jax(jx):
    """Three chunks of 4 with a pad of 2, from a carried state."""
    rng = np.random.default_rng(2)
    b, s, h, p, n, Q = 2, 10, 3, 4, 5, 4
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, h).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32)
    jy, jst = jx.S._ssd_chunked(*(jx.jnp.asarray(a) for a in
                                  (x, dt, A, B, C)), Q,
                                init=jx.jnp.asarray(init))
    y, st = S._ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B, C)),
                           Q, init=torch.from_numpy(init))
    assert tuple(y.shape) == (b, s, h, p) and tuple(st.shape) == (b, h, p, n)
    _close(y, jy, F32_TOL)
    _close(st, jst, F32_TOL)


def test_ssm_layer_decode_and_prefill_match_jax(jx, models):
    """``mode="decode"`` from a carried cache, and ``mode="prefill"``
    over 9 tokens (three chunks of 4, a pad of 3) from zero state."""
    jcfg, cfg, jp, tp = _mamba_params(jx, models)
    rng = np.random.default_rng(3)
    jh, h = _bf16(jx, rng.standard_normal((2, 9, cfg.d_model)))
    jout, (jc, js) = jx.S.ssm_layer(jcfg, jx.PCFG(), jp, jh, mode="prefill")
    out, (c, s) = S.ssm_layer(cfg, ParallelConfig(), tp, h, mode="prefill")
    _close(out, jout, BF16_TOL)
    np.testing.assert_array_equal(_f32(c), _f32(jc))
    _close(s, js, F32_TOL)
    jh, h = _bf16(jx, rng.standard_normal((3, 1, cfg.d_model)))
    conv_shape = (3, cfg.ssm.conv_width - 1,
                  cfg.ssm.expand * cfg.d_model + 2 * cfg.ssm.state_dim)
    jconv, conv = _bf16(jx, rng.standard_normal(conv_shape))
    nh = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    ssm0 = rng.standard_normal((3, nh, cfg.ssm.head_dim,
                                cfg.ssm.state_dim)).astype(np.float32)
    jout, (jc, js) = jx.S.ssm_layer(jcfg, jx.PCFG(), jp, jh, mode="decode",
                                    cache=(jconv, jx.jnp.asarray(ssm0)))
    out, (c, s) = S.ssm_layer(cfg, ParallelConfig(), tp, h, mode="decode",
                              cache=(conv, torch.from_numpy(ssm0)))
    _close(out, jout, BF16_TOL)
    np.testing.assert_array_equal(_f32(c), _f32(jc))
    _close(s, js, F32_TOL)


def test_ssm_layer_paged_matches_jax(jx, models):
    """A padded batch of 3 rows of lengths (9, 4, 1) over 12 positions
    from carried state: output, conv window and final state match, and
    each row's state equals an unpadded run of its own length (the pad
    tail leaves it unchanged)."""
    jcfg, cfg, jp, tp = _mamba_params(jx, models)
    rng = np.random.default_rng(4)
    lens = np.asarray([9, 4, 1], np.int32)
    jh, h = _bf16(jx, rng.standard_normal((3, 12, cfg.d_model)))
    ch = cfg.ssm.expand * cfg.d_model + 2 * cfg.ssm.state_dim
    jconv, conv = _bf16(jx, rng.standard_normal(
        (3, cfg.ssm.conv_width - 1, ch)))
    nh = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    ssm0 = rng.standard_normal((3, nh, cfg.ssm.head_dim,
                                cfg.ssm.state_dim)).astype(np.float32)
    jout, (jc, js) = jx.S.ssm_layer_paged(
        jcfg, jx.PCFG(), jp, jh, lengths=jx.jnp.asarray(lens),
        conv_state=jconv, ssm_state=jx.jnp.asarray(ssm0))
    out, (c, s) = S.ssm_layer_paged(
        cfg, ParallelConfig(), tp, h, lengths=torch.from_numpy(lens),
        conv_state=conv, ssm_state=torch.from_numpy(ssm0))
    for r, n in enumerate(lens):
        _close(out[r, :n], jout[r, :n], BF16_TOL)
    np.testing.assert_array_equal(_f32(c), _f32(jc))
    _close(s, js, F32_TOL)
    for r, n in enumerate(lens):
        _, (c1, s1) = S.ssm_layer_paged(
            cfg, ParallelConfig(), tp, h[r:r + 1, :n],
            lengths=torch.tensor([int(n)]), conv_state=conv[r:r + 1],
            ssm_state=torch.from_numpy(ssm0[r:r + 1]))
        np.testing.assert_array_equal(_f32(c1[0]), _f32(c[r]))
        _close(s1[0], s[r], F32_TOL)


# ------------------------------------------------------------------ #
# Dense MoE
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("fam", ["hybrid", "moe"])
def test_dense_moe_matches_jax(jx, models, fam):
    """jamba's 8-expert top-2 and scout's 8-expert top-1 with a shared
    expert; the tokens route to the same experts as in JAX (checked
    first: a flipped expert would show as a large output difference)."""
    jcfg, cfg, jparams, params = models[fam]
    key = next(k for k in jparams["group0"] if k.endswith("_moe"))
    jp = jx.jax.tree.map(lambda a: a[0], jparams["group0"][key]["moe"])
    tp = {k: v[0] for k, v in params["group0"][key]["moe"].items()}
    rng = np.random.default_rng(5)
    jh, h = _bf16(jx, rng.standard_normal((2, 6, cfg.d_model)))
    jlogits = jx.jnp.einsum("td,de->te", jh.reshape(12, -1).astype(
        jx.jnp.float32), jp["router"].astype(jx.jnp.float32))
    _, jtop_e = jx.jax.lax.top_k(jx.jax.nn.softmax(jlogits, axis=-1),
                                 cfg.moe.top_k)
    _, _, top_e = M.route(cfg, tp["router"], h.reshape(12, -1))
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
    jout, jaux = jx.M.moe_layer(jcfg, jx.PCFG(moe_impl="dense"), jp, jh)
    out, aux = M.moe_layer(cfg, ParallelConfig(), tp, h)
    assert out.dtype == torch.bfloat16
    _close(out, jout, BF16_TOL)
    _close(aux, jaux, F32_TOL)


# ------------------------------------------------------------------ #
# Parameter trees
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_from_jax_params_carries_every_leaf(jx, models, fam):
    """The port's tree has the JAX tree's leaves (path, shape, axes,
    init), the family's new leaves among them, and the converted
    parameters keep their bits."""
    jcfg, cfg, jparams, params = models[fam]
    jdefs = list(tree_leaves(jx.T.model_defs(jcfg)))
    defs = list(tree_leaves(T.model_defs(cfg)))
    assert [p for p, _ in defs] == [p for p, _ in jdefs]
    for (_, d), (_, jd) in zip(defs, jdefs):
        assert (d.shape, d.laxes, d.init) == (tuple(jd.shape),
                                              tuple(jd.laxes), jd.init)
    names = {p.split("/")[-1] for p, _ in defs}
    want = {"ssm": {"in_proj", "conv_w", "conv_b", "a_log", "dt_bias",
                    "d_skip", "out_norm", "out_proj"},
            "hybrid": {"in_proj", "a_log", "router", "w_gate", "w_up",
                       "w_down", "wq"},
            "moe": {"router", "w_gate", "w_up", "w_down", "shared_gate",
                    "shared_up", "shared_down"}}[fam]
    assert want <= names
    jflat = dict(tree_leaves(jparams))
    for path, t in tree_leaves(params):
        np.testing.assert_array_equal(torch_to_numpy(t),
                                      np.asarray(jflat[path]))


# ------------------------------------------------------------------ #
# State-arena ops
# ------------------------------------------------------------------ #


def _state_arena(rng, dtype):
    a = rng.standard_normal((2, 2, 6, 4, 3)).astype(np.float32)
    a[1, 0, 2, 3, 1] = -0.0
    return a.astype(dtype) if dtype != "bfloat16" else a


def test_state_ops_match_jax_ref_and_pallas(jx):
    """Scatter (with a pad row duplicating row 0 in place, and a lone
    ``-0.0`` in the payload), copy and init, on f32 and bf16 arenas, bit
    for bit against the JAX reference and its Pallas kernel in
    interpret mode; an empty batch changes nothing and launches
    nothing."""
    jnp = jx.jnp
    rng = np.random.default_rng(7)
    for dtype, jdt, tdt in (("float32", jnp.float32, torch.float32),
                            ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        ja = jnp.asarray(_state_arena(rng, dtype), jdt)
        new = rng.standard_normal((2, 2, 3, 4, 3)).astype(np.float32)
        new[0, 1, 1, 0, 0] = -0.0
        new[:, :, 2] = new[:, :, 0]
        rows = np.asarray([4, 1, 4], np.int32)
        jnew = jnp.asarray(new, jdt)
        results = {
            "ref": jx.ss.state_scatter_inline(ja, jnp.asarray(rows), jnew),
            "pallas": jx.ss.state_scatter_inline(
                ja, jnp.asarray(rows), jnew, use_pallas=True,
                interpret=True)}
        port = numpy_to_torch(np.asarray(ja), "cpu")
        ss_ops.state_scatter_inline(port, torch.from_numpy(rows),
                                    numpy_to_torch(np.asarray(jnew), "cpu"))
        src, dst = np.asarray([0, 2], np.int32), np.asarray([5, 3], np.int32)
        for name, kw in (("ref", {}),
                         ("pallas", dict(use_pallas=True, interpret=True))):
            want = results[name]
            np.testing.assert_array_equal(_bits(port), _bits(want),
                                          err_msg=name)
            want_copy = jx.ss.pim_state_copy(jnp.copy(want), jnp.asarray(src),
                                             jnp.asarray(dst), **kw)
            want_init = jx.ss.pim_state_init(jnp.copy(want), jnp.asarray(dst),
                                             0.0, **kw)
            got = ss_ops.pim_state_copy(port.clone(), src, dst)
            np.testing.assert_array_equal(_bits(got), _bits(want_copy))
            got = ss_ops.pim_state_init(port.clone(), dst, 0.0)
            np.testing.assert_array_equal(_bits(got), _bits(want_init))
        assert port.dtype == tdt
        # empty batches: no change, no launch (the CPU runs no kernel, so
        # the counts stay 0 either way; the arena's bits are the check)
        reset_launches()
        before = port.clone()
        ss_ops.state_scatter_inline(port, torch.zeros(0, dtype=torch.int32),
                                    torch.zeros((2, 2, 0, 4, 3), dtype=tdt))
        ss_ops.pim_state_copy(port, [], [])
        ss_ops.pim_state_init(port, [], 0.0)
        np.testing.assert_array_equal(_bits(port), _bits(before))
        assert not any(launch_counts().values())


def test_state_write_needs_a_bound_arena():
    """A generic queue's ``ssm_state_write`` flush refuses (no state
    arena is bound), as the JAX registry's default does."""
    q = PimOpQueue()
    q.enqueue("ssm_state_write", StateWriteBatch(
        [0], torch.zeros(1, 1, 1, 2), torch.zeros(1, 1, 1, 2)))
    with pytest.raises(RuntimeError, match="no bound"):
        q.flush(torch.zeros(1), torch.zeros(1))


# ------------------------------------------------------------------ #
# The CUDA kernel against its plain version (the card only; run with
# ``python -m pytest -m cuda --noconftest tests/test_torch_ssm.py``)
# ------------------------------------------------------------------ #


@pytest.mark.cuda
def test_cuda_state_scatter_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    cuda = torch.device("cuda")
    rng = np.random.default_rng(8)
    # 16-byte rows (the word path) and 6-byte rows (the byte path)
    for tail, dtype in (((4, 3), torch.float32), ((3,), torch.bfloat16)):
        arena = torch.from_numpy(rng.standard_normal(
            (2, 2, 6) + tail).astype(np.float32)).to(dtype)
        new = torch.from_numpy(rng.standard_normal(
            (2, 2, 3) + tail).astype(np.float32)).to(dtype)
        new[:, :, 2] = new[:, :, 0]
        new[0, 1, 1].view(-1)[0] = -0.0
        rows = torch.tensor([4, 1, 4], dtype=torch.int32)
        want = ss_ref.state_scatter(arena.clone().view(4, 6, -1), rows,
                                    new.reshape(4, 3, -1))
        reset_launches()
        got = ss_ops.state_scatter_inline(arena.to(cuda), rows.to(cuda),
                                          new.to(cuda))
        torch.cuda.synchronize()
        assert launch_counts()["state_scatter"] == 1
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(got.cpu().view(4, 6, -1).view(bits),
                           want.view(bits))
