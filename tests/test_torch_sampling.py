"""D-RaNGe sampling in the port against the JAX package.

Bit for bit: the ``random_u32`` words and the uniforms drawn from them
(the port's plain version, what it runs on the CPU, against the JAX
reference and Pallas kernel in interpret mode), the engine's seed
stream across a uint32 wraparound, and ``TorchLib.rand``/``rand_u32``
with their stats against ``TpuLib``'s.  The sampled token choice is
held against the JAX ``_select_tokens`` on identical logits: equal
tokens, except where a row's uniform lies within ``BOUNDARY`` of a CDF
boundary (the two sides sum the float32 probabilities in different
orders); such rows are counted.  The CUDA kernels of this slice (the
generator, and flash attention's prefix-KV mode) are held against their
plain versions on the card only.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.pimolib import TorchLib  # noqa: E402
from repro_torch.kernels.drange import ops as dr_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from test_torch_kernels import _f32, _rand, _t  # noqa: E402

BOUNDARY = 1e-5
# seed ^ 0x9E3779B9 == 0xFFFFFFF9: the second word wraps at counter 7
WRAP_SEED = 0x61C88640


@pytest.fixture(scope="module")
def jx():
    """The JAX package.  Imported here, not at the top, so the card-only
    tests below also run where JAX is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.pimolib import TpuLib
    from repro.kernels.drange import drange, ops, ref
    from repro.serving import engine
    return types.SimpleNamespace(jnp=jnp, TpuLib=TpuLib, drange=drange,
                                 dr=ops, ref=ref, E=engine)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("seed,shape", [
    ((0, 0x9E3779B9), (8, 1)),
    ((0xFFFFFFF0, 0xFFFFFFFF), (33, 7)),
    ((WRAP_SEED + 9, 2), (256, 16)),
])
def test_random_u32_bit_exact_with_jax(jx, seed, shape):
    got = dr_ops.pim_random_u32(seed, *shape, device="cpu")
    assert got.dtype == torch.uint32 and tuple(got.shape) == shape
    jseed = jx.jnp.asarray(seed, jx.jnp.uint32)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jx.ref.random_u32(jseed, *shape)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jx.drange.random_u32(jseed, *shape, block_rows=8, interpret=True)))


def test_uniforms_and_seed_stream_bit_exact_with_jax(jx):
    """The engine's seed of dispatch n is ``rng_seed + n`` on both
    words with uint32 wraparound, and its uniforms are the JAX ones."""
    jnp = jx.jnp
    jseed0 = jnp.asarray([WRAP_SEED, WRAP_SEED ^ 0x9E3779B9], jnp.uint32)
    eng = E.PagedEngine.__new__(E.PagedEngine)
    eng.rng_seed = (WRAP_SEED, (WRAP_SEED ^ 0x9E3779B9) & E.MASK32)
    for ctr in range(20):
        # the JAX engine's expression: self.rng_seed + jnp.uint32(ctr)
        jseed = jseed0 + jnp.uint32(ctr)
        seed = eng._seed(ctr)
        assert seed == tuple(int(w) for w in np.asarray(jseed))
        got = dr_ops.pim_random_uniform(seed, 8, 3, device="cpu").numpy()
        want = np.asarray(jx.dr.pim_random_uniform(jseed, 8, 3))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    assert eng._seed(7)[1] == 0            # the wrap happened


def test_torchlib_rand_matches_tpulib(jx):
    jnp = jx.jnp
    lib, jlib = TorchLib(device="cpu"), jx.TpuLib()
    for n_bits in (100, 37, 64):
        bits, rec = lib.rand(n_bits)
        jbits, jrec = jlib.rand(n_bits)
        np.testing.assert_array_equal(bits, jbits)
        assert (rec.op, rec.n_ops, rec.launches) == \
            (jrec.op, jrec.n_ops, jrec.launches)
    bits, _ = lib.rand(40, seed=(5, 6))
    jbits, _ = jlib.rand(40, seed=jnp.asarray([5, 6], jnp.uint32))
    np.testing.assert_array_equal(bits, jbits)
    words = lib.rand_u32((7, 8), 3, 4)
    np.testing.assert_array_equal(words.numpy(), np.asarray(
        jlib.rand_u32(jnp.asarray([7, 8], jnp.uint32), 3, 4)))
    assert lib.stats["rand_bits"] == jlib.stats["rand_bits"]
    assert lib.queue.launches_by_kind["drange_rand"] == \
        jlib.queue.launches_by_kind["drange_rand"] == 5


def _boundary_rows(logits, temps, u):
    """Rows whose uniform lies within BOUNDARY of a CDF boundary."""
    rows = set()
    for b, t in enumerate(temps):
        if t == 0.0:
            continue
        z = logits[b].astype(np.float64) / (t if t > 0 else 1.0)
        with np.errstate(invalid="ignore"):     # the all -inf row
            p = np.exp(z - z.max())
        if np.abs(np.cumsum(p / p.sum()) - u[b]).min() < BOUNDARY:
            rows.add(b)
    return rows


@pytest.mark.parametrize("rowmap", [False, True])
def test_select_tokens_matches_jax_on_identical_logits(jx, rowmap):
    jnp = jx.jnp
    rng = np.random.default_rng(3)
    B, V = 8, 512
    temps = np.asarray([0.0, 1.0, 0.5, 0.0, 2.0, 0.1, 1.0, -1.0],
                       np.float32)
    rm = np.asarray([0, 1, 2, 3, 4, 5, 0, 0]) if rowmap else None
    checked = near = 0
    for trial in range(12):
        logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
        # an all -inf row: every draw falls through to index 0, as
        # jnp.argmax of an all-false row gives
        logits[3 if trial % 2 else 7] = -np.inf
        seed = (trial, 0x9E3779B9 ^ trial)
        jseed = jnp.asarray(seed, jnp.uint32)
        want = np.asarray(jx.E._select_tokens(
            jnp.asarray(logits), jnp.asarray(temps), jseed,
            use_pallas=False, interpret=True,
            rowmap=None if rm is None else jnp.asarray(rm)))
        got = E._select_tokens(
            torch.from_numpy(logits), temps, seed,
            rowmap=None if rm is None else torch.from_numpy(rm)).numpy()
        u = dr_ops.pim_random_uniform(seed, B, 1, "cpu")[:, 0].numpy()
        if rm is not None:
            u = u[rm]
        skip = _boundary_rows(logits, temps, u)
        near += len(skip)
        for b in range(B):
            if b not in skip:
                assert got[b] == want[b], (trial, b)
                checked += 1
    print({"checked": checked, "near_boundary": near})
    assert checked >= 12 * B - 4
    # an all-greedy batch skips the draw and is the argmax
    logits = torch.from_numpy(rng.normal(size=(B, V)).astype(np.float32))
    np.testing.assert_array_equal(
        E._select_tokens(logits, np.zeros(B, np.float32), (1, 2)).numpy(),
        np.argmax(logits.numpy(), -1))


# ------------------------------------------------------------------ #
# CUDA kernels against their plain versions (the card only; run with
# ``python -m pytest -m cuda --noconftest tests/test_torch_sampling.py``)
# ------------------------------------------------------------------ #


@pytest.mark.cuda
def test_cuda_random_u32_matches_plain(cuda):
    for seed, shape in (((1, 2), (8, 1)), ((0xFFFFFFFF, 7), (4096, 256))):
        got = dr_ops.pim_random_u32(seed, *shape, device=cuda)
        want = dr_ops.pim_random_u32(seed, *shape, device="cpu")
        torch.cuda.synchronize()
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_flash_prefix_mode_matches_plain(cuda):
    rng = np.random.default_rng(9)
    B, H, KVH, S, Sp, D = 4, 8, 2, 70, 130, 128
    q = _rand(rng, (B, H, S, D))
    k, v = (_rand(rng, (B, KVH, S, D)) for _ in range(2))
    kp, vp = (_rand(rng, (B, Sp, KVH, D)) for _ in range(2))
    lens = np.asarray([70, 1, 33, 64], np.int32)
    plens = np.asarray([0, 16, 129, 130], np.int32)

    def run(dev):
        return fa_ops.attention(
            _t(q, "bfloat16", dev), _t(k, "bfloat16", dev),
            _t(v, "bfloat16", dev), causal=True, lengths=_t(lens, device=dev),
            k_prefix=_t(kp, "bfloat16", dev).transpose(1, 2),
            v_prefix=_t(vp, "bfloat16", dev).transpose(1, 2),
            prefix_lengths=_t(plens, device=dev))

    want, got = run("cpu"), run(cuda)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)
