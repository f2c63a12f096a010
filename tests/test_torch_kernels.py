"""The port's kernels against the JAX package's, at tiny shapes.

Each kernel's plain PyTorch version (what the port runs on a CPU
tensor) is held against the JAX Pallas kernel in interpret mode and the
JAX reference, on the same numpy inputs: here the RowClone data movers,
bit for bit; the attention kernels in ``test_torch_attention.py``,
which shares this file's helpers.

The CUDA kernels have no CPU mode; the tests that hold each of the four
against its plain version need the card and skip without one.

The suite runs under ``pytest-xdist --dist loadfile``, which hands out
files largest first.  Every ``test_torch_*`` file holds at most 13 tests
so that it queues behind ``test_prefill.py`` and leaves the schedule of
the larger, older files as it was: one of their tests depends on the
session ``rng`` state left by the file that ran before it.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts, reset_launches  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pa_ref  # noqa: E402
from repro_torch.kernels.rowclone import ops as rc_ops  # noqa: E402
from repro_torch.kernels.rowclone import ref as rc_ref  # noqa: E402
from repro_torch.models.params import torch_to_numpy  # noqa: E402

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels.  Imported here, not at the top, so the
    card-only tests below also run where JAX is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention, ref as fa_r
    from repro.kernels.paged_attention import paged_attention, ref as pa_r
    from repro.kernels.rowclone import ref as rc_r, rowclone
    return types.SimpleNamespace(
        jnp=jnp, fa=flash_attention, fa_ref=fa_r, pa=paged_attention,
        pa_ref=pa_r, rc=rowclone, rc_ref=rc_r,
        dtypes={"float32": jnp.float32, "bfloat16": jnp.bfloat16})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rand(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a, dt="float32", device="cpu"):
    """numpy float32/int -> torch on ``device``; floats rounded to ``dt``
    (round to nearest even, as ``jnp.asarray(a, bfloat16)`` rounds)."""
    t = torch.from_numpy(np.array(a))
    if t.is_floating_point():
        t = t.to(TORCH_DTYPES[dt])
    return t.to(device)


def _j(jx, a, dt="float32"):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return jx.jnp.asarray(a, jx.dtypes[dt])
    return jx.jnp.asarray(a)


def _bits(x):
    """Raw bits of a torch tensor or JAX/numpy array, for exact
    comparison (NaN-safe, bf16-safe)."""
    if isinstance(x, torch.Tensor):
        a = torch_to_numpy(x)
    else:
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            a = a.view(np.int16)
    return a.view(np.uint8)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------ #
# RowClone data movers: exact
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_kv_scatter_exact_with_duplicate_pads(jx, dt):
    rng = np.random.default_rng(0)
    L, P, S, KVH, D, B = 2, 6, 4, 2, 8, 5
    arena = _rand(rng, (L, P, S, KVH, D))
    new = _rand(rng, (L, B, KVH, D))
    pages = np.asarray([3, 1, 3, 5, 3], np.int32)
    slots = np.asarray([0, 2, 1, 3, 0], np.int32)
    new[:, 4] = new[:, 0]          # a pad row: same slot, same payload
    out = rc_ops.kv_scatter_inline(_t(arena, dt), _t(pages), _t(slots),
                                   _t(new, dt))
    a4 = _j(jx, arena, dt).reshape(L, P, S, -1)
    n3 = _j(jx, new, dt).reshape(L, B, -1)
    jp, js = _j(jx, pages), _j(jx, slots)
    want_ref = jx.rc_ref.kv_scatter(a4, jp, js, n3)
    want_pl = jx.rc.kv_scatter(a4, jp, js, n3, interpret=True)
    got = _bits(out).reshape(_bits(want_ref).shape)
    np.testing.assert_array_equal(got, _bits(want_ref))
    np.testing.assert_array_equal(got, _bits(want_pl))
    # the gather reads the scatter back
    back = rc_ops.kv_gather_inline(out, _t(pages), _t(slots))
    np.testing.assert_array_equal(_bits(back),
                                  _bits(_t(new, dt).view(L, B, KVH, D)))


@pytest.mark.parametrize("case", ["disjoint", "dst_is_src", "src_is_dst"])
def test_page_copy_batched_exact(jx, case):
    rng = np.random.default_rng(1)
    L, P, E = 3, 8, 24
    arena = _rand(rng, (L, P, E))
    if case == "disjoint":
        src, dst = [1, 2, 3], [4, 5, 6]
    elif case == "dst_is_src":
        # op 1 writes page 2, which op 0 reads: the order PimOpQueue.admit
        # lets into one batch (a write after a pending read)
        src, dst = [2, 1, 0], [5, 2, 7]
    else:
        # op 0 writes page 2, which op 1 reads.  admit() never batches
        # this order, and the Pallas grid (in order, block by block)
        # chains it; the reference and the port read the pre-batch arena
        src, dst = [1, 2, 0], [2, 5, 7]
    before = _t(arena, "bfloat16")
    out = rc_ops.pim_page_copy_batched(before.clone(), src, dst)
    ja = _j(jx, arena, "bfloat16")
    s, d = _j(jx, np.asarray(src, np.int32)), _j(jx, np.asarray(dst, np.int32))
    want_ref = jx.rc_ref.page_copy_batched(ja, s, d)
    np.testing.assert_array_equal(_bits(out), _bits(want_ref))
    if case != "src_is_dst":
        want_pl = jx.rc.page_copy_batched(ja, s, d, block_cols=8,
                                          interpret=True)
        np.testing.assert_array_equal(_bits(out), _bits(want_pl))
    # every copy read the arena as it was before the batch
    for a, b in zip(src, dst):
        assert torch.equal(out[:, b], before[:, a])


@pytest.mark.parametrize("value", [0.0, 1.5])
def test_page_init_batched_exact(jx, value):
    rng = np.random.default_rng(2)
    arena = _rand(rng, (2, 6, 16))
    dst = [0, 3, 4]
    out = rc_ops.pim_page_init_batched(_t(arena, "bfloat16"), dst, value)
    ja = _j(jx, arena, "bfloat16")
    d = _j(jx, np.asarray(dst, np.int32))
    want_ref = jx.rc_ref.page_init_batched(ja, d, value)
    want_pl = jx.rc.page_init_batched(ja, d, value, block_cols=8,
                                      interpret=True)
    np.testing.assert_array_equal(_bits(out), _bits(want_ref))
    np.testing.assert_array_equal(_bits(out), _bits(want_pl))


def test_fill_pattern_repeats_the_bits():
    assert rc_ops.fill_pattern(0.0, torch.bfloat16) == 0
    one_bf16 = 0x3F80              # bf16 1.0
    assert rc_ops.fill_pattern(1.0, torch.bfloat16) == one_bf16 * 0x10001
    assert rc_ops.fill_pattern(1.0, torch.float32) == 0x3F800000


def test_cpu_tensors_launch_no_kernel():
    reset_launches()
    arena = torch.zeros((1, 4, 8))
    rc_ops.pim_page_copy_batched(arena, [0], [1])
    rc_ops.pim_page_init_batched(arena, [2], 0.0)
    assert set(launch_counts().values()) == {0}


# ------------------------------------------------------------------ #
# Attention inputs (shared with tests/test_torch_attention.py)
# ------------------------------------------------------------------ #


def _paged_inputs(*, self_token):
    rng = np.random.default_rng(3)
    B, H, KVH, D, S, P, W = 4, 4, 2, 32, 4, 16, 4
    q = _rand(rng, (B, H, D))
    ka = _rand(rng, (P, S, KVH, D))
    va = _rand(rng, (P, S, KVH, D))
    bt = np.stack([rng.permutation(P)[:W] for _ in range(B)]).astype(np.int32)
    # ragged, with a length of 1; without the self token, row 3 has no
    # key at all
    lens = np.asarray([1, 6, 16, 3 if self_token else 0], np.int32)
    ks = _rand(rng, (B, KVH, D)) if self_token else None
    vs = _rand(rng, (B, KVH, D)) if self_token else None
    return q, ka, va, bt, lens, ks, vs


def _flash_inputs():
    rng = np.random.default_rng(4)
    B, H, KVH, S, D = 3, 4, 2, 20, 32
    return (_rand(rng, (B, H, S, D)), _rand(rng, (B, KVH, S, D)),
            _rand(rng, (B, KVH, S, D)), np.asarray([20, 1, 13], np.int32))


# ------------------------------------------------------------------ #
# CUDA kernels against their plain versions (the card only; run with
# ``python -m pytest -m cuda tests/test_torch_kernels.py``)
# ------------------------------------------------------------------ #


@pytest.mark.cuda
def test_cuda_kv_scatter_matches_plain(cuda):
    rng = np.random.default_rng(6)
    arena = _t(_rand(rng, (3, 8, 4, 2, 64)), "bfloat16")
    new = _t(_rand(rng, (3, 4, 2, 64)), "bfloat16")
    pages = _t(np.asarray([1, 7, 1, 1], np.int32))
    slots = _t(np.asarray([0, 3, 2, 0], np.int32))
    new[:, 3] = new[:, 0]
    want = rc_ref.kv_scatter(arena.clone().view(3, 8, 4, -1), pages, slots,
                             new.view(3, 4, -1))
    got = rc_ops.kv_scatter_inline(arena.to(cuda), pages.to(cuda),
                                   slots.to(cuda), new.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(3, 8, 4, -1), want)


@pytest.mark.cuda
def test_cuda_page_copy_init_match_plain(cuda):
    rng = np.random.default_rng(7)
    arena = _t(_rand(rng, (3, 8, 4, 2, 64)), "bfloat16")
    # disjoint, and a destination that another op reads (staged copy)
    for src, dst in (([1, 2], [4, 5]), ([2, 1], [6, 2])):
        want = rc_ref.page_copy_batched(arena.clone(), torch.tensor(src),
                                        torch.tensor(dst))
        want = rc_ref.page_init_batched(want, torch.tensor([0, 3]), 0.5)
        got = rc_ops.pim_page_copy_batched(arena.to(cuda), src, dst)
        got = rc_ops.pim_page_init_batched(got, [0, 3], 0.5)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (src, dst)


@pytest.mark.cuda
def test_cuda_paged_attention_matches_plain(cuda):
    for self_token in (True, False):
        q, ka, va, bt, lens, ks, vs = _paged_inputs(self_token=self_token)

        def run(dev):
            kw = dict(k_self=_t(ks, "bfloat16", dev),
                      v_self=_t(vs, "bfloat16", dev)) if self_token else {}
            return pa_ops.paged_attention(
                _t(q, "bfloat16", dev), _t(ka, "bfloat16", dev),
                _t(va, "bfloat16", dev), _t(bt, device=dev),
                _t(lens, device=dev), return_lse=True, **kw)

        want, got = run("cpu"), run(cuda)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            np.testing.assert_allclose(_f32(g), _f32(w), atol=2e-2,
                                       rtol=2e-2)


@pytest.mark.cuda
def test_cuda_flash_attention_matches_plain(cuda):
    q, k, v, lens = _flash_inputs()
    for causal in (True, False):
        def run(dev):
            return fa_ops.attention(
                _t(q, "bfloat16", dev), _t(k, "bfloat16", dev),
                _t(v, "bfloat16", dev), causal=causal,
                lengths=_t(lens, device=dev) if causal else None)

        want, got = run("cpu"), run(cuda)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2,
                                   rtol=2e-2)
