"""The port's training path against the JAX package's, on the CPU:
the flash attention's custom VJP, the fused LM head, both optimizers,
gradient clipping, the schedule and one train step of the dense, ssm and
moe families.

Inputs are made from a seed with numpy and handed to both packages;
weights come from the JAX ``init_params`` through ``from_jax_params``.
Model-level comparisons run both packages in float32 (each
``layers.COMPUTE_DTYPE`` patched), as ``test_torch_forward.py`` does,
so they measure the algorithms: float32 sums in other orders.

One train step is compared with AdamW's ``eps`` at 1e-3.  At the
default 1e-8 the first update is ``sign(g)`` wherever ``|g| >> 1e-8``,
so a gradient element that sits at float32 noise in both packages (a
few in 10^4 at these sizes) flips its parameter by 2 * lr; with 1e-3
the update is a smooth function of the gradient, and every parameter
can be held to a float32 tolerance.  The optimizers themselves are held
at their default ``eps`` against JAX given the same gradients.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import ARCHS as JARCHS, OptimizerConfig as JOCFG  # noqa: E402
from repro.configs import ParallelConfig as JPCFG, reduced as jreduced  # noqa: E402
from repro.models import attention as JA, layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.lm_head import fused_xent as jfused_xent  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import ARCHS, OptimizerConfig, ParallelConfig, reduced  # noqa: E402
from repro_torch.models import attention as A, layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.lm_head import IGNORE, fused_xent  # noqa: E402
from repro_torch.models.params import (from_jax_params, init_params,  # noqa: E402
                                       tree_leaves, tree_map)
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training.train_step import make_loss_fn, make_train_step  # noqa: E402

# float32 tiles summed in other orders: measured below 1e-6
GRAD_TOL = 1e-5
# bf16 inputs and outputs: one bf16 step (2**-8 relative) either way
BF16_TOL = 1e-2


def _np(t):
    return t.detach().float().numpy()


# --------------------------------------------------------------------- #
# chunked_attention: the custom VJP
# --------------------------------------------------------------------- #


def _forward_without_vjp(q, k, v, *, causal, chunk_q, chunk_k,
                         q_offset=0, lengths=None):
    """``chunked_attention``'s forward as it stood before its VJP was
    ported (the inference forward's), kept to hold the new one to it
    bit for bit."""
    b, sq, h, dh = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    scale = dh ** -0.5
    cq, ck = min(chunk_q, sq), min(chunk_k, sk)
    pq, pk = (-sq) % cq, (-sk) % ck
    if lengths is None:
        bias = torch.zeros((b, sk), dtype=torch.float32)
    else:
        bias = torch.where(torch.arange(sk)[None, :]
                           < lengths[:, None].long(), 0.0, -1e30)
    bias = F.pad(bias, (0, pk), value=-1e30)
    SQ, SK = sq + pq, sk + pk
    qf = F.pad(q, (0, 0, 0, 0, 0, pq)).float().transpose(1, 2).reshape(
        b, kvh, g, SQ, dh)
    kf = F.pad(k, (0, 0, 0, 0, 0, pk)).float().transpose(1, 2)
    vf = F.pad(v, (0, 0, 0, 0, 0, pk)).float().transpose(1, 2)
    m = torch.full((b, kvh, g, SQ, 1), -1e30)
    l = torch.zeros((b, kvh, g, SQ, 1))
    acc = torch.zeros((b, kvh, g, SQ, dh))
    for i, j in A._tile_pairs(SQ // cq, SK // ck, causal, cq, ck, q_offset):
        qs, ks = slice(i * cq, (i + 1) * cq), slice(j * ck, (j + 1) * ck)
        s = torch.einsum("bkgqd,bkcd->bkgqc", qf[:, :, :, qs], kf[:, :, ks])
        mask = bias[:, None, None, None, ks]
        if causal:
            qpos = q_offset + i * cq + torch.arange(cq)
            kpos = j * ck + torch.arange(ck)
            mask = mask + torch.where(kpos[None, :] <= qpos[:, None], 0.0,
                                      -1e30)
        s = s * scale + mask
        m_prev, l_prev = m[:, :, :, qs], l[:, :, :, qs]
        m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m_prev - m_new)
        l[:, :, :, qs] = alpha * l_prev + p.sum(dim=-1, keepdim=True)
        acc[:, :, :, qs] = alpha * acc[:, :, :, qs] + torch.einsum(
            "bkgqc,bkcd->bkgqd", p, vf[:, :, ks])
        m[:, :, :, qs] = m_new
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.reshape(b, h, SQ, dh).transpose(1, 2)[:, :sq].to(q.dtype)


# (b, sq, sk, h, kvh, dh, causal, q_offset, lengths?, chunks, dtype)
ATTN_CASES = {
    # GQA 4/2, causal at a q offset, ragged lengths, 11 and 19 not
    # multiples of their tiles (4, 8)
    "causal_gqa_lengths_offset": (2, 11, 19, 4, 2, 16, True, 8, True,
                                  (4, 8), "float32"),
    # MQA (4 heads over 1), causal, no lengths, 13 over tiles of 4
    "causal_mqa_ragged": (2, 13, 13, 4, 1, 8, True, 0, False, (4, 4),
                          "float32"),
    # not causal, lengths, bf16 operands as the training path gives them
    "noncausal_lengths_bf16": (1, 10, 23, 2, 2, 8, False, 0, True, (8, 8),
                               "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_grads_match_jax(case):
    """The forward equals the inference forward (``_forward_without_vjp``)
    bit for bit and JAX's within 1e-5; dq, dk, dv of a random cotangent
    equal JAX's custom VJP within GRAD_TOL (float32) or BF16_TOL (bf16
    operands, outputs rounded to bf16)."""
    b, sq, sk, h, kvh, dh, causal, off, with_len, (cq, ck), dt = \
        ATTN_CASES[case]
    rng = np.random.default_rng(3)
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            ((b, sq, h, dh), (b, sk, kvh, dh), (b, sk, kvh, dh),
             (b, sq, h, dh))]
    lens = (rng.integers(sk // 2, sk + 1, b).astype(np.int32)
            if with_len else None)
    kw = dict(causal=causal, chunk_q=cq, chunk_k=ck, q_offset=off)
    tdt, jdt = getattr(torch, dt), getattr(jnp, dt)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in arrs[:3])
    tl = None if lens is None else torch.from_numpy(lens)
    out = A.chunked_attention(tq, tk, tv, lengths=tl, **kw)
    old = _forward_without_vjp(tq.detach(), tk.detach(), tv.detach(),
                               lengths=tl, **kw)
    assert out.dtype == tdt and torch.equal(out.detach(), old)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(arrs[3]).to(tdt))
    jl = None if lens is None else jnp.asarray(lens)
    want, vjp = jax.vjp(
        lambda q, k, v: JA.chunked_attention(q, k, v, lengths=jl, **kw),
        *(jnp.asarray(a, jdt) for a in arrs[:3]))
    jgrads = vjp(jnp.asarray(arrs[3], jdt))
    tol = GRAD_TOL if dt == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(out), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    for name, got, ref in zip("qkv", grads, jgrads):
        assert got.dtype == tdt, name
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol, err_msg=f"d{name}")


# --------------------------------------------------------------------- #
# fused_xent
# --------------------------------------------------------------------- #


def test_fused_xent_matches_jax():
    """Value, count, dx and dW against the JAX custom VJP: 13 positions
    in chunks of 4 (three chunks and a remainder of 1) and a chunk wider
    than the sequence, with IGNORE labels; the loss within 1e-5
    relative, the gradients within GRAD_TOL; bf16 ``x`` gets a bf16 dx
    (within BF16_TOL) and a float32 table's dW stays float32."""
    rng = np.random.default_rng(4)
    for b, s, d, V, chunk, dt in ((2, 13, 8, 37, 4, "float32"),
                                  (3, 9, 16, 50, 512, "float32"),
                                  (2, 12, 8, 29, 5, "bfloat16")):
        x = rng.normal(size=(b, s, d)).astype(np.float32)
        W = rng.normal(size=(V, d)).astype(np.float32)
        lab = rng.integers(0, V, (b, s)).astype(np.int32)
        lab[0, 0] = lab[-1, -1] = IGNORE
        tx = torch.from_numpy(x).to(getattr(torch, dt)).requires_grad_()
        tW = torch.from_numpy(W).requires_grad_()
        nll, cnt = fused_xent(tx, tW, torch.from_numpy(lab), chunk)
        dx, dW = torch.autograd.grad(nll * 0.7, (tx, tW))
        (jn, jc), vjp = jax.vjp(
            lambda x, W: jfused_xent(x, W, jnp.asarray(lab), chunk),
            jnp.asarray(x, getattr(jnp, dt)), jnp.asarray(W))
        jdx, jdW = vjp((jnp.float32(0.7), np.zeros((), jax.dtypes.float0)))
        assert cnt.dtype == torch.int32 and int(cnt) == int(jc) == \
            b * s - 2
        np.testing.assert_allclose(float(nll.detach()), float(jn), rtol=1e-5)
        tol = GRAD_TOL if dt == "float32" else BF16_TOL
        assert dx.dtype == tx.dtype and dW.dtype == torch.float32
        np.testing.assert_allclose(_np(dx), np.asarray(jdx, np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(dW), np.asarray(jdW), rtol=tol,
                                   atol=tol)


# --------------------------------------------------------------------- #
# optimizers, clipping, schedule
# --------------------------------------------------------------------- #


def _opt_tree(rng):
    """A tree with 1-D, 2-D and stacked 3-D float32 leaves."""
    return {"norm": rng.normal(size=(6,)).astype(np.float32),
            "w": rng.normal(size=(5, 7)).astype(np.float32),
            "stack": {"up": rng.normal(size=(3, 4, 6)).astype(np.float32)}}


def _grads_seq(rng, n):
    return [{"norm": rng.normal(size=(6,)).astype(np.float32) * 0.1,
             "w": rng.normal(size=(5, 7)).astype(np.float32) * 0.1,
             "stack": {"up": rng.normal(size=(3, 4, 6)).astype(np.float32)
                       * 0.1}} for _ in range(n)]


def _close_trees(got, want, rtol, atol, what):
    jl = jax.tree.leaves(want)
    tl = [t for _, t in tree_leaves(got)]
    assert len(jl) == len(tl), what
    for (path, t), j in zip(tree_leaves(got), jl):
        np.testing.assert_allclose(_np(t), np.asarray(j, np.float32),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(state_dtype):
    """Three AdamW steps given JAX's own gradients: params within 1e-6
    (float32 arithmetic in the reference's order; pow and sqrt may part
    by an ulp) and the moments in their state dtype, bf16 moments
    within one bf16 step (2**-7 relative: a one-ulp float32 difference
    can round either way)."""
    rng = np.random.default_rng(5)
    p0, gs = _opt_tree(rng), _grads_seq(rng, 3)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, p0)
    jopt = JO.adamw_init(jp, getattr(jnp, state_dtype))
    tp = from_jax_params(p0, "cpu")
    topt = O.adamw_init(tp, getattr(torch, state_dtype))
    for g in gs:
        jp, jopt = JO.adamw_update(jp, jax.tree.map(jnp.asarray, g), jopt,
                                   JOCFG(**ocfg), getattr(jnp, state_dtype))
        tp, topt = O.adamw_update(tp, from_jax_params(g, "cpu"), topt,
                                  OptimizerConfig(**ocfg))
    assert int(topt["step"]) == int(jopt["step"]) == 3
    assert topt["step"].dtype == torch.int32
    _close_trees(tp, jp, 1e-6, 1e-6, "params")
    stol = 1e-6 if state_dtype == "float32" else 2 ** -7
    for k in ("m", "v"):
        assert all(t.dtype == getattr(torch, state_dtype)
                   for _, t in tree_leaves(topt[k]))
        _close_trees(topt[k], jopt[k], stol, 1e-7, k)


def test_adafactor_update_matches_jax():
    """Three Adafactor steps given JAX's gradients: factored moments for
    the 2-D and stacked leaves, full for the 1-D one; params and
    moments within 1e-5 relative (row and column means summed in other
    orders)."""
    rng = np.random.default_rng(6)
    p0, gs = _opt_tree(rng), _grads_seq(rng, 3)
    ocfg = dict(name="adafactor", lr=1e-2, warmup_steps=2, total_steps=10)
    jp = jax.tree.map(jnp.asarray, p0)
    jopt = JO.adafactor_init(jp)
    tp = from_jax_params(p0, "cpu")
    topt = O.adafactor_init(tp)
    for g in gs:
        jp, jopt = JO.adafactor_update(jp, jax.tree.map(jnp.asarray, g),
                                       jopt, JOCFG(**ocfg))
        tp, topt = O.adafactor_update(tp, from_jax_params(g, "cpu"), topt,
                                      OptimizerConfig(**ocfg))
    assert sorted(topt["fac"]["w"]) == ["vc", "vr"]
    assert sorted(topt["fac"]["norm"]) == ["v"]
    assert tuple(topt["fac"]["stack"]["up"]["vc"].shape) == (3, 6)
    _close_trees(tp, jp, 1e-5, 1e-6, "params")
    _close_trees(topt["fac"], jopt["fac"], 1e-5, 1e-9, "fac")


def test_clip_and_lr_schedule_match_jax():
    """``lr_schedule`` at every step of warmup, decay and past the end
    within 1e-6 relative (cos in float32); ``clip_by_global_norm`` on
    gradients above and below the limit: the norm within 1e-6
    relative, the clipped leaves within 1e-6, and a bf16 leaf kept
    bf16."""
    ocfg = dict(lr=3e-4, warmup_steps=5, total_steps=40)
    jf, tf = JO.lr_schedule(JOCFG(**ocfg)), O.lr_schedule(
        OptimizerConfig(**ocfg))
    for s in range(0, 45):
        want = float(jf(jnp.asarray(s, jnp.int32)))
        got = float(tf(torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s
    rng = np.random.default_rng(7)
    for scale in (10.0, 0.01):
        g = {k: v * scale for k, v in _grads_seq(rng, 1)[0].items()
             if k != "stack"}
        g["h"] = rng.normal(size=(4,)).astype(np.float32) * scale
        jg = jax.tree.map(jnp.asarray, g)
        jg["h"] = jg["h"].astype(jnp.bfloat16)
        tg = from_jax_params(jax.tree.map(np.asarray, jg), "cpu")
        jc, jn = JO.clip_by_global_norm(jg, 1.0)
        tc, tn = O.clip_by_global_norm(tg, 1.0)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        assert tc["h"].dtype == torch.bfloat16
        _close_trees(tc, jc, 1e-6, 1e-6, f"clip x{scale}")


# --------------------------------------------------------------------- #
# one train step per family
# --------------------------------------------------------------------- #


TRAIN_FAMILIES = {
    "dense": ("stablelm-3b", dict(num_layers=2)),
    "ssm": ("mamba2-1.3b", dict(num_layers=2)),
    "moe": ("llama4-scout-17b-a16e", dict(num_layers=2)),
}
PK = dict(remat="full", attention_impl="chunked", attention_chunk=8,
          moe_impl="dense")
OK_ = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-3)
# a step-1 update moves a parameter by at most about lr(1) = 5e-4; the
# packages' updates agree within 1% of that (measured 2.8e-6, moe)
UPDATE_ATOL = 5e-6


def _train_model(family):
    arch, kw = TRAIN_FAMILIES[family]
    jcfg, cfg = jreduced(JARCHS[arch], **kw), reduced(ARCHS[arch], **kw)
    if family == "ssm":     # SSD chunks of 8 over 20 positions: ragged
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(
            jcfg.ssm, chunk_size=8))
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk_size=8))
    jparams = jinit(JT.model_defs(jcfg), jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, from_jax_params(
        jax.tree.map(np.asarray, jparams), "cpu")


def _tokens(cfg, B=2, S=20, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = np.roll(tok, -1, 1)
    lab[:, -1] = IGNORE
    return {"tokens": tok, "labels": lab}


@pytest.mark.parametrize("family", sorted(TRAIN_FAMILIES))
def test_train_step_matches_jax(family, monkeypatch):
    """One ``make_train_step`` step (remat full, chunked attention in
    tiles of 8 over 20 positions, AdamW) from weights carried across,
    both packages in float32: loss and aux within 1e-5 relative,
    grad_norm within 2e-4 relative and every updated parameter within
    UPDATE_ATOL (the module docstring says why eps is 1e-3 here).  The
    token table's gradient passes the first RMSNorm's backward, whose
    two terms nearly cancel at the embeddings' rms of 0.02: it agrees
    with JAX's to ~1e-4 relative (measured 6e-5 on its norm, moe), not
    to float32's 1e-7, and the global norm, hence the clip, with it."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    jcfg, cfg, jparams, params = _train_model(family)
    batch = _tokens(cfg)
    ji, js = jmake_train_step(jcfg, JPCFG(**PK), JOCFG(**OK_))
    jstate, jm = jax.jit(js)(ji(jparams),
                             jax.tree.map(jnp.asarray, batch))
    ti, ts = make_train_step(cfg, ParallelConfig(**PK),
                             OptimizerConfig(**OK_))
    state, m = ts(ti(params), {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    for k in ("loss", "aux", "tokens"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                            abs=1e-6), k
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=2e-4)
    if family == "moe":
        assert float(m["aux"]) > 0
    _close_trees(state["params"], jstate["params"], 0, UPDATE_ATOL, family)
    assert int(state["opt"]["step"]) == 1


def test_microbatches_two_equal_one(monkeypatch):
    """Two microbatches (float32 gradient accumulation / 2) against one
    batch of 4 on the port, and against JAX's two: metrics within 1e-5
    relative (grad_norm against JAX's within 2e-4, as one step's),
    updated params within UPDATE_ATOL."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    jcfg, cfg, jparams, params = _train_model("dense")
    batch = _tokens(cfg, B=4, S=12, seed=2)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for mb in (1, 2):
        ti, ts = make_train_step(cfg, ParallelConfig(**PK, microbatches=mb),
                                 OptimizerConfig(**OK_))
        out[mb] = ts(ti(tree_map(torch.clone, params)), tb)
    ji, js = jmake_train_step(jcfg, JPCFG(**PK, microbatches=2),
                              JOCFG(**OK_))
    jstate, jm = jax.jit(js)(ji(jparams), jax.tree.map(jnp.asarray, batch))
    for k in ("loss", "grad_norm"):     # equal microbatches of 22 labels
        assert float(out[2][1][k]) == pytest.approx(float(out[1][1][k]),
                                                    rel=1e-5), k
    # the microbatches' metrics are averaged, as JAX averages them
    assert float(out[2][1]["tokens"]) == float(jm["tokens"]) == 22.0
    for k in ("loss", "grad_norm"):
        assert float(out[2][1][k]) == pytest.approx(
            float(jm[k]), rel=2e-4 if k == "grad_norm" else 1e-5), k
    for (path, a), (_, b) in zip(tree_leaves(out[2][0]["params"]),
                                 tree_leaves(out[1][0]["params"])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=UPDATE_ATOL,
                                   err_msg=path)
    _close_trees(out[2][0]["params"], jstate["params"], 0, UPDATE_ATOL,
                 "vs JAX")


REMAT_FAMILIES = {
    "hybrid": ("jamba-1.5-large-398b", dict(num_layers=4, attn_every=4)),
    "mla": ("deepseek-v2-236b", dict(num_layers=2)),
    "vlm": ("llava-next-34b", dict(num_layers=2)),
    "encdec": ("seamless-m4t-medium", {}),
}


def test_remat_modes_give_equal_values():
    """``forward(mode="features")`` differentiates for the hybrid (Mamba,
    attention, MoE and MLP sublayers), MLA, vlm (patch embeds) and
    encdec (frames) families; remat "full", "dots" and "none" give the
    same loss and gradients bit for bit, and the backward recomputes
    the projections (``aten.mm``) under "full" only."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                CountMM.n += 1
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(8)
    for family, (arch, kw) in REMAT_FAMILIES.items():
        cfg = reduced(ARCHS[arch], **kw)
        params = init_params(T.model_defs(cfg),
                             torch.Generator().manual_seed(8), "cpu")
        batch = {k: torch.from_numpy(v) for k, v in
                 _tokens(cfg, B=2, S=12, seed=9).items()}
        fd = cfg.frontend_dim or cfg.d_model
        if family == "vlm":
            batch["patch_embeds"] = torch.from_numpy(rng.normal(
                size=(2, cfg.num_patch_tokens, fd)).astype(np.float32))
            batch["labels"] = torch.cat([torch.full(
                (2, cfg.num_patch_tokens), IGNORE, dtype=torch.int32),
                batch["labels"]], dim=1)
        if family == "encdec":
            batch["frames"] = torch.from_numpy(rng.normal(
                size=(2, 8, fd)).astype(np.float32))
        res, mms = {}, {}
        for remat in ("none", "full", "dots"):
            pc = ParallelConfig(remat=remat, attention_impl="chunked",
                                attention_chunk=4, moe_impl="dense")
            alias = tree_map(lambda t: t.detach().requires_grad_(), params)
            total, _ = make_loss_fn(cfg, pc)(alias, batch)
            CountMM.n = 0
            with CountMM():
                grads = torch.autograd.grad(
                    total, [t for _, t in tree_leaves(alias)],
                    allow_unused=True)
            res[remat], mms[remat] = (total, grads), CountMM.n
        assert torch.isfinite(res["none"][0]), family
        for remat in ("full", "dots"):
            assert torch.equal(res[remat][0], res["none"][0]), (family,
                                                                remat)
            for a, b in zip(res[remat][1], res["none"][1]):
                assert (a is None) == (b is None), family
                assert a is None or torch.equal(a, b), (family, remat)
        assert mms["dots"] == mms["none"] < mms["full"], (family, mms)
