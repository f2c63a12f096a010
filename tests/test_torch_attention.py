"""The port's attention kernels against the JAX package's.

The plain PyTorch versions (what the port runs on CPU tensors) of paged
decode attention and flash attention, held against the JAX Pallas
kernels in interpret mode and the JAX references on the same numpy
inputs: at atol = rtol = 1e-5 for fp32 inputs (both sides compute in
fp32; only the summation order differs) and at 2e-2 for bf16 inputs
(the outputs are rounded to bf16, whose spacing is 2**-8 relative, and
the two sides round at different places).  Helpers and inputs come from
``test_torch_kernels.py``; the card-only tests of these kernels live
there too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from test_torch_kernels import (ATTN_TOL, _f32, _flash_inputs, _j,  # noqa: E402,F401
                                _paged_inputs, _rand, _t, jx)


# ------------------------------------------------------------------ #
# Paged decode attention
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("self_token", [True, False])
def test_paged_attention_matches_jax(jx, dt, self_token):
    q, ka, va, bt, lens, ks, vs = _paged_inputs(self_token=self_token)
    tol = ATTN_TOL[dt]
    kw = dict(k_self=_t(ks, dt), v_self=_t(vs, dt)) if self_token else {}
    o, m, l = pa_ops.paged_attention(
        _t(q, dt), _t(ka, dt), _t(va, dt), _t(bt), _t(lens),
        return_lse=True, **kw)
    jk = dict(k_self=_j(jx, ks, dt), v_self=_j(jx, vs, dt)) \
        if self_token else {}
    args = (_j(jx, q, dt), _j(jx, ka, dt), _j(jx, va, dt), _j(jx, bt),
            _j(jx, lens))
    for want in (jx.pa.paged_attention(*args, interpret=True,
                                       return_lse=True, **jk),
                 jx.pa_ref.paged_attention(*args, return_lse=True, **jk)):
        np.testing.assert_allclose(_f32(o), _f32(want[0]), atol=tol, rtol=tol)
        np.testing.assert_allclose(_f32(l), _f32(want[2]), atol=tol, rtol=tol)
        # m is a max of scores: compare where the row saw a key
        seen = _f32(want[2]) > 0
        np.testing.assert_allclose(_f32(m)[seen], _f32(want[1])[seen],
                                   atol=tol, rtol=tol)
    if not self_token:
        np.testing.assert_array_equal(_f32(o)[3], 0.0)
        np.testing.assert_array_equal(_f32(l)[3], 0.0)


# ------------------------------------------------------------------ #
# Flash attention (prefill)
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["causal_lengths", "causal", "full"])
def test_flash_attention_matches_jax(jx, dt, mode):
    q, k, v, lens = _flash_inputs()
    causal = mode != "full"
    use_lens = mode == "causal_lengths"
    got = fa_ops.attention(_t(q, dt), _t(k, dt), _t(v, dt), causal=causal,
                           lengths=_t(lens) if use_lens else None)
    jl = _j(jx, lens) if use_lens else None
    args = (_j(jx, q, dt), _j(jx, k, dt), _j(jx, v, dt))
    tol = ATTN_TOL[dt]
    for want in (jx.fa.flash_attention(*args, causal=causal, lengths=jl,
                                       block_q=8, block_k=8, interpret=True),
                 jx.fa_ref.attention(*args, causal=causal, lengths=jl)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_flash_attention_prefix_mode_matches_jax_ref(jx):
    rng = np.random.default_rng(5)
    B, H, KVH, S, Sp, D = 2, 4, 2, 8, 12, 32
    q = _rand(rng, (B, H, S, D))
    k, v = (_rand(rng, (B, KVH, S, D)) for _ in range(2))
    kp, vp = (_rand(rng, (B, KVH, Sp, D)) for _ in range(2))
    lens = np.asarray([8, 3], np.int32)
    plens = np.asarray([12, 0], np.int32)
    got = fa_ref.attention(_t(q), _t(k), _t(v), lengths=_t(lens),
                           k_prefix=_t(kp), v_prefix=_t(vp),
                           prefix_lengths=_t(plens))
    want = jx.fa_ref.attention(*(_j(jx, a) for a in (q, k, v)),
                               lengths=_j(jx, lens), k_prefix=_j(jx, kp),
                               v_prefix=_j(jx, vp),
                               prefix_lengths=_j(jx, plens))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=1e-5)


def test_flash_attention_row_without_keys_is_zero():
    # the port's contract (the JAX reference averages v instead; the
    # serving path never forms such a row)
    q, k, v, _ = _flash_inputs()
    lens = np.asarray([20, 0, 5], np.int32)
    got = fa_ops.attention(_t(q), _t(k), _t(v), causal=False,
                           lengths=_t(lens))
    np.testing.assert_array_equal(_f32(got)[1], 0.0)
