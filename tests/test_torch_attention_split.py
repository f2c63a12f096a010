"""The arithmetic of the two attention kernels' Hopper designs.

Paged decode attention splits each sequence into partitions, takes each
partition's softmax statistics and weighted sum alone, and merges them
in fp32 with the current token.  Its plain split-and-merge version
(``paged_attention_split``, used by the tests only) is held against the
JAX package's Pallas kernel (interpret mode) with ``return_lse``: o, m
and l, at atol = rtol = 1e-5 for fp32 inputs (both sides fp32; only the
summation order differs) and 2e-2 for bf16 inputs (outputs rounded to
bf16, spacing 2**-8 relative).  Partitions that cut a page, partitions
past a row's length, and query groups of 4, 5 and 8 heads are covered.

Flash attention's bf16 route rounds the softmax weights P to bf16 for
the tensor cores' P.V product.  The plain version with that rounding
(``round_p=True``) is held against the JAX kernel within the same 2e-2,
in the plain, ``lengths`` and prefix-KV modes.

The ``cuda``-marked tests hold each CUDA kernel against its plain
version on the card at the edges of its tiling; they skip without a
card (``python -m pytest --noconftest -m cuda
tests/test_torch_attention_split.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pa_ref  # noqa: E402
from test_torch_kernels import (ATTN_TOL, _f32, _j, _rand, _t,  # noqa: E402,F401
                                cuda, jx)

# the card against the plain version in fp32: sums of up to ~700 terms
# taken in another order (relative rounding ~ 700 * 2**-24)
CARD_F32_TOL = 1e-4


def _paged_case(rng, G, *, S, W, lens, KVH=2, D=32, P=None):
    """q, arenas, a block table of distinct pages, lengths, self K/V."""
    B = len(lens)
    P = P or B * W + 3
    H = G * KVH
    pages = rng.permutation(P)[:B * W].reshape(B, W).astype(np.int32)
    return dict(q=_rand(rng, (B, H, D)), ka=_rand(rng, (P, S, KVH, D)),
                va=_rand(rng, (P, S, KVH, D)), bt=pages,
                lens=np.asarray(lens, np.int32),
                ks=_rand(rng, (B, KVH, D)), vs=_rand(rng, (B, KVH, D)))


# ------------------------------------------------------------------ #
# Paged decode attention: split and merge
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("G", [4, 5, 8])
def test_split_paged_attention_matches_jax(jx, G):
    rng = np.random.default_rng(20 + G)
    # page size 4, 6 pages a row (24 tokens): a full row, a row of one
    # token, rows ending mid-page and at a page boundary, an empty row
    c = _paged_case(rng, G, S=4, W=6, lens=[24, 1, 13, 8, 0])
    for dt in ("float32", "bfloat16"):
        tol = ATTN_TOL[dt]
        for self_token in (True, False):
            jk = dict(k_self=_j(jx, c["ks"], dt),
                      v_self=_j(jx, c["vs"], dt)) if self_token else {}
            tk = dict(k_self=_t(c["ks"], dt),
                      v_self=_t(c["vs"], dt)) if self_token else {}
            want = jx.pa.paged_attention(
                _j(jx, c["q"], dt), _j(jx, c["ka"], dt), _j(jx, c["va"], dt),
                _j(jx, c["bt"]), _j(jx, c["lens"]), interpret=True,
                return_lse=True, **jk)
            seen = _f32(want[2]) > 0
            # 6 cuts pages of 4; 8 ends on a page boundary and divides the
            # full row; 64 is one partition
            for part in (6, 8, 64):
                o, m, l = pa_ref.paged_attention_split(
                    _t(c["q"], dt), _t(c["ka"], dt), _t(c["va"], dt),
                    _t(c["bt"]), _t(c["lens"]), part=part, **tk)
                np.testing.assert_allclose(_f32(o), _f32(want[0]), atol=tol,
                                           rtol=tol)
                np.testing.assert_allclose(_f32(l), _f32(want[2]), atol=tol,
                                           rtol=tol)
                np.testing.assert_allclose(_f32(m)[seen], _f32(want[1])[seen],
                                           atol=tol, rtol=tol)
                if not self_token:
                    # the empty row: no key, o = 0, l = 0, m = -1e30
                    np.testing.assert_array_equal(_f32(o)[4], 0.0)
                    np.testing.assert_array_equal(_f32(l)[4], 0.0)
                    np.testing.assert_array_equal(_f32(m)[4],
                                                  np.float32(-1e30))


def test_partitions_come_from_host_shapes():
    # the grid's partition count depends on the block table's width only
    assert pa_ops.PARTITION_TOKENS % 64 == 0
    part = pa_ops.PARTITION_TOKENS
    assert pa_ops.num_partitions(128, 16) == -(-2048 // part)
    assert pa_ops.num_partitions(1, 16) == 1
    assert pa_ops.num_partitions(0, 16) == 1
    # one page past a whole number of partitions: one more partition
    assert pa_ops.num_partitions(part // 16 + 1, 16) == 2
    # on CPU tensors the wrapper runs the plain version and launches
    # nothing; the split version agrees with it
    rng = np.random.default_rng(9)
    c = _paged_case(rng, 4, S=16, W=20, lens=[320, 256, 1, 0])
    args = (_t(c["q"]), _t(c["ka"]), _t(c["va"]), _t(c["bt"]), _t(c["lens"]))
    kw = dict(k_self=_t(c["ks"]), v_self=_t(c["vs"]))
    reset_launches()
    got = pa_ops.paged_attention(*args, return_lse=True, **kw)
    assert LAUNCHES["paged_attention"] == 0
    split = pa_ref.paged_attention_split(*args, part=pa_ops.PARTITION_TOKENS,
                                         **kw)
    for g, s in zip(got, split):
        np.testing.assert_allclose(_f32(g), _f32(s), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ #
# Flash attention: P rounded to bf16 for P.V
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("mode", ["plain", "lengths", "prefix"])
def test_flash_p_rounded_matches_jax(jx, mode):
    rng = np.random.default_rng({"plain": 30, "lengths": 31,
                                 "prefix": 32}[mode])
    B, H, KVH, S, Sp, D = 3, 4, 2, 40, 24, 32
    dt = "bfloat16"
    q = _rand(rng, (B, H, S, D))
    k, v = (_rand(rng, (B, KVH, S, D)) for _ in range(2))
    kw, jkw = {}, {}
    if mode != "plain":
        lens = np.asarray([40, 1, 23], np.int32)
        kw["lengths"], jkw["lengths"] = _t(lens), _j(jx, lens)
    if mode == "prefix":
        kp, vp = (_rand(rng, (B, KVH, Sp, D)) for _ in range(2))
        plens = np.asarray([0, 24, 13], np.int32)
        kw.update(k_prefix=_t(kp, dt), v_prefix=_t(vp, dt),
                  prefix_lengths=_t(plens))
        jkw.update(k_prefix=_j(jx, kp, dt), v_prefix=_j(jx, vp, dt),
                   prefix_lengths=_j(jx, plens))
    got = fa_ref.attention(_t(q, dt), _t(k, dt), _t(v, dt), causal=True,
                           round_p=True, **kw)
    args = (_j(jx, q, dt), _j(jx, k, dt), _j(jx, v, dt))
    wants = [jx.fa_ref.attention(*args, causal=True, **jkw),
             jx.fa.flash_attention(*args, causal=True, block_q=8, block_k=8,
                                   interpret=True, **jkw)]
    tol = ATTN_TOL[dt]
    for want in wants:
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


# ------------------------------------------------------------------ #
# The CUDA kernels at the edges of their tiling (the card only)
# ------------------------------------------------------------------ #


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_cuda_paged_split_edges(cuda, dt):
    tol = ATTN_TOL[dt] if dt == "bfloat16" else CARD_F32_TOL
    rng = np.random.default_rng(40)
    # page size 24: the partitions (a multiple of 64 tokens) end inside
    # pages; a row whose only key is the current token, a row of one,
    # exact multiples of the partition, and rows past several partitions
    part = pa_ops.PARTITION_TOKENS
    lens = [0, 1, part, 2 * part, 300, 700]
    for G in (4, 5, 8, 32):
        for D in (32, 64, 128, 256):
            c = _paged_case(rng, G, S=24, W=32, lens=lens, KVH=2, D=D)

            def run(dev):
                return pa_ops.paged_attention(
                    _t(c["q"], dt, dev), _t(c["ka"], dt, dev),
                    _t(c["va"], dt, dev), _t(c["bt"], device=dev),
                    _t(c["lens"], device=dev), k_self=_t(c["ks"], dt, dev),
                    v_self=_t(c["vs"], dt, dev), return_lse=True)

            want = run("cpu")
            reset_launches()
            got = run(cuda)
            again = run(cuda)
            torch.cuda.synchronize()
            assert LAUNCHES["paged_attention"] == 2
            for g, a, w in zip(got, again, want):
                np.testing.assert_allclose(_f32(g), _f32(w), atol=tol,
                                           rtol=tol, err_msg=f"G={G} D={D}")
                # the merge tickets were reset: the second call agrees
                assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
def test_cuda_flash_edges(cuda, D):
    rng = np.random.default_rng(50 + D)
    B = 4
    for H, KVH in ((32, 8), (64, 8), (40, 8)):
        q = _rand(rng, (B, H, 100, D))            # not a multiple of 64
        k, v = (_rand(rng, (B, KVH, 100, D)) for _ in range(2))
        lens = np.asarray([100, 1, 64, 77], np.int32)
        kp, vp = (_rand(rng, (B, 150, KVH, D)) for _ in range(2))
        # 0, all of Sp, a prefix that ends mid-tile, one tile exactly
        plens = np.asarray([0, 150, 100, 64], np.int32)
        cases = [
            ("bfloat16", dict(causal=True, lengths=lens)),
            ("bfloat16", dict(causal=False)),
            ("bfloat16", dict(causal=True, sk=70)),       # Sk < Sq
            ("bfloat16", dict(causal=True, lengths=lens, prefix=True)),
            ("float32", dict(causal=True, lengths=lens, prefix=True)),
        ]
        for dt, case in cases:
            sk = case.get("sk", 100)

            def run(dev, dt=dt, case=case, sk=sk):
                kw = dict(causal=case["causal"])
                if "lengths" in case:
                    kw["lengths"] = _t(case["lengths"], device=dev)
                if case.get("prefix"):
                    # the engine's layout: a transposed view of a gather
                    kw.update(k_prefix=_t(kp, dt, dev).transpose(1, 2),
                              v_prefix=_t(vp, dt, dev).transpose(1, 2),
                              prefix_lengths=_t(plens, device=dev))
                return fa_ops.attention(
                    _t(q, dt, dev), _t(k[:, :, :sk], dt, dev),
                    _t(v[:, :, :sk], dt, dev), **kw)

            want, got = run("cpu"), run(cuda)
            torch.cuda.synchronize()
            tol = ATTN_TOL[dt] if dt == "bfloat16" else CARD_F32_TOL
            np.testing.assert_allclose(
                _f32(got), _f32(want), atol=tol, rtol=tol,
                err_msg=f"H={H} KVH={KVH} D={D} {dt} {case}")
