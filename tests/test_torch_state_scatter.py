"""The SSM state write (TPU row 7, ``state_scatter``) as one launch over
the conv/SSD state pair, against the JAX package.

* The pair wrapper and the one-arena wrapper on the CPU (their plain
  versions) bit for bit against the JAX reference ``state_scatter`` and
  its Pallas kernel in interpret mode: conv rows in bf16 and SSD rows in
  float32 of other sizes, a pad row duplicating row 0 in place, a lone
  ``-0.0``, rows as a tensor and as host ints, and an empty batch.
* The launch plan through ``_ScatterModel``, a host model of
  ``ss_state_scatter`` as its contract in ``csrc/ssm_scan.cu`` states
  it (5 descriptor values an arena, the rows inline or at a pointer):
  the wrapper's descriptors, inline and uploaded row lists, and that a
  ``new`` of the arena's dtype and an int32 row tensor reach the launch
  as they lie (the lean wrapper converts nothing).
* A mamba2 engine (chunked: prefill, chunk, mixed and block steps) and
  a jamba one-period engine (the eager oracle's ``ssm_state_write``
  flush), their state writes through the launch plan, against the JAX
  engine: streams, every step's ``launches_by_kind``, zero arenas; one
  ``state_scatter`` launch per state write where two ran before.

The CUDA kernel has no CPU mode: the ``cuda``-marked test holds it bit
for bit against its plain version and skips here.  JAX is imported in
fixtures and tests only.
"""

import ctypes
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts, reset_launches  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ss_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as ss_ref  # noqa: E402
from repro_torch.models.params import numpy_to_torch, torch_to_numpy  # noqa: E402

# (groups, sublayers, slots) and the trailing dims of each arena: conv
# rows of 3 x 5 bf16 (30 bytes, the byte path on the card), SSD rows of
# 2 x 4 x 2 float32 (64 bytes)
LAYOUT = (2, 3, 7)
CONV = ((3, 5), "bfloat16")
SSM = ((2, 4, 2), "float32")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssm_scan import ops as jss
    return jnp, jss


def _bits(a):
    a = torch_to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _arena_and_new(rng, trail, dtype, B):
    """An arena and a batch of new rows (numpy float32, rounded to
    ``dtype`` by the caller), row 2 of the batch a copy of row 0 and a
    lone ``-0.0`` planted."""
    arena = rng.standard_normal(LAYOUT + trail).astype(np.float32)
    new = rng.standard_normal(LAYOUT[:2] + (B,) + trail).astype(np.float32)
    if B > 2:
        new[:, :, 2] = new[:, :, 0]
    if B > 1:
        new[1, 2, 1].reshape(-1)[0] = -0.0
    return arena, new


def _jax_want(jx, arena, new, rows, dtype, **kw):
    jnp, jss = jx
    jdt = getattr(jnp, dtype)
    return np.asarray(jss.state_scatter_inline(
        jnp.asarray(arena, jdt), jnp.asarray(rows, jnp.int32),
        jnp.asarray(new, jdt), **kw))


@pytest.mark.parametrize("rows", [[4, 1, 4, 6], [0], []],
                         ids=["pad_row", "one_row", "empty"])
def test_pair_matches_jax_ref_and_pallas(jx, rows):
    """The pair wrapper (and each arena alone through the one-arena
    wrapper), rows as a tensor and as host ints, bit for bit against
    the JAX reference and Pallas interpret on both arenas; an empty
    batch changes nothing and launches nothing."""
    for as_tensor in (True, False):
        _check_pair(jx, rows, as_tensor)


def _check_pair(jx, rows, as_tensor):
    rng = np.random.default_rng(len(rows))
    B = len(rows)
    parts = [_arena_and_new(rng, trail, dtype, B) for trail, dtype in
             (CONV, SSM)]
    wants = {name: [_jax_want(jx, a, n, rows, dt, **kw)
                    for (a, n), (_, dt) in zip(parts, (CONV, SSM))]
             for name, kw in (("ref", {}),
                              ("pallas", dict(use_pallas=True,
                                              interpret=True)))}
    jnp = jx[0]
    port = [numpy_to_torch(np.asarray(jnp.asarray(a, getattr(jnp, dt))),
                           "cpu")
            for (a, _), (_, dt) in zip(parts, (CONV, SSM))]
    news = [numpy_to_torch(np.asarray(jnp.asarray(n, getattr(jnp, dt))),
                           "cpu")
            for (_, n), (_, dt) in zip(parts, (CONV, SSM))]
    idx = torch.tensor(rows, dtype=torch.int32) if as_tensor else rows
    alone = [p.clone() for p in port]
    reset_launches()
    ss_ops.state_scatter_pair_inline(port[0], port[1], idx, news[0], news[1])
    for a, n in zip(alone, news):
        ss_ops.state_scatter_inline(a, idx, n)
    assert not any(launch_counts().values())
    for name, want in wants.items():
        for got, one, w in zip(port, alone, want):
            np.testing.assert_array_equal(_bits(got), _bits(w), err_msg=name)
            np.testing.assert_array_equal(_bits(one), _bits(w), err_msg=name)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Rows out of range, a batch that does not match the rows, and a
    pair whose arenas differ in slots."""
    conv = torch.zeros(LAYOUT + CONV[0], dtype=torch.bfloat16)
    ssm = torch.zeros(LAYOUT + SSM[0])
    new_c = torch.zeros(LAYOUT[:2] + (2,) + CONV[0], dtype=torch.bfloat16)
    new_s = torch.zeros(LAYOUT[:2] + (2,) + SSM[0])
    with pytest.raises(IndexError, match="state row"):
        ss_ops.state_scatter_pair_inline(conv, ssm, [0, 7], new_c, new_s)
    with pytest.raises(ValueError, match="does not match"):
        ss_ops.state_scatter_pair_inline(conv, ssm, [0, 1, 2], new_c, new_s)
    with pytest.raises(ValueError, match="differ"):
        ss_ops.state_scatter_pair_inline(conv, ssm[:, :, :5], [0, 1], new_c,
                                         new_s[:, :, :2])


class _ScatterModel:
    """``ss_state_scatter`` on host memory, as its contract in
    ``csrc/ssm_scan.cu`` states it: 5 descriptor values an arena (arena
    base, new base, arena rows a layer, row bytes, layers), ``new`` laid
    out (layers, n, row bytes), the n rows inline or at ``dev_rows``."""

    def __init__(self):
        self.calls = []

    def ss_state_scatter(self, desc, arenas, dev_rows, host_rows, n,
                         stream):
        vals = struct.unpack(f"{5 * arenas}q", desc)
        rows = (list((ctypes.c_int * n).from_address(dev_rows))
                if dev_rows is not None
                else list(struct.unpack(f"{n}i", host_rows)))
        self.calls.append(dict(desc=vals, dev_rows=dev_rows, rows=rows))
        for z in range(arenas):
            dst, src, R, row, L = vals[5 * z:5 * z + 5]
            for l in range(L):
                for b in range(n):
                    ctypes.memmove(dst + (l * R + rows[b]) * row,
                                   src + (l * n + b) * row, row)
        return 0


@pytest.fixture
def model(monkeypatch):
    m = _ScatterModel()
    monkeypatch.setattr(ss_ops, "_lib", m)
    monkeypatch.setattr(ss_ops, "_stream", lambda t: 0)
    return m


@pytest.mark.parametrize("case", ["device_rows", "inline", "uploaded",
                                  "one_arena"])
def test_launch_plan_writes_as_the_reference(model, case):
    """The wrapper's launch through the contract model: device rows (a
    step's buffer), host rows in the launch's parameters, 600 host rows
    (past ``INLINE_ROWS``: uploaded), and one arena.  The arenas equal
    the reference's, and ``LAUNCHES`` counts one launch."""
    R = 700 if case == "uploaded" else 9
    rng = np.random.default_rng(3)
    rows = (list(rng.permutation(R)[:600]) if case == "uploaded"
            else [5, 0, 8, 5])
    B = len(rows)
    g = torch.Generator().manual_seed(4)
    conv = torch.randn((2, 1, R, 3, 5), generator=g).to(torch.bfloat16)
    ssm = torch.randn((2, 1, R, 4, 4), generator=g)
    new_c = torch.randn((2, 1, B, 3, 5), generator=g).to(torch.bfloat16)
    new_s = torch.randn((2, 1, B, 4, 4), generator=g)
    new_c[:, :, B - 1] = new_c[:, :, 0]
    new_s[:, :, B - 1] = new_s[:, :, 0]
    want = [a.clone() for a in (conv, ssm)]
    for w, n in zip(want, (new_c, new_s)):
        ss_ref.state_scatter(w.view(2, R, -1), torch.tensor(rows),
                             n.reshape(2, B, -1))
    idx = (torch.tensor(rows, dtype=torch.int32) if case == "device_rows"
           else rows)
    reset_launches()
    if case == "one_arena":
        ss_ops._launch((ssm,), (new_s,), idx)
        assert torch.equal(ssm, want[1])
    else:
        ss_ops._launch((conv, ssm), (new_c, new_s), idx)
        assert torch.equal(conv.view(torch.int16), want[0].view(torch.int16))
        assert torch.equal(ssm, want[1])
    call, = model.calls
    assert (call["dev_rows"] is not None) == (case in ("device_rows",
                                                       "uploaded"))
    assert call["rows"] == rows
    assert call["desc"][2:5] == (R, 4 * 4 * 4 if case == "one_arena"
                                 else 3 * 5 * 2, 2)
    assert launch_counts()["state_scatter"] == 1


def test_lean_wrapper_passes_buffers_as_they_are(model):
    """A ``new`` of the arena's dtype, contiguous, and an int32 row
    tensor reach the launch as they lie (their own pointers); a float32
    ``new`` for a bf16 arena and int64 rows are converted first."""
    conv = torch.zeros((2, 1, 6, 3, 5), dtype=torch.bfloat16)
    ssm = torch.zeros((2, 1, 6, 4, 4))
    new_c = torch.ones((2, 1, 3, 3, 5), dtype=torch.bfloat16)
    new_s = torch.ones((2, 1, 3, 4, 4))
    rows = torch.tensor([1, 4, 1], dtype=torch.int32)
    ss_ops._launch((conv, ssm), (new_c, new_s), rows)
    call = model.calls[-1]
    assert call["dev_rows"] == rows.data_ptr()
    assert call["desc"][1] == new_c.data_ptr()
    assert call["desc"][6] == new_s.data_ptr()
    ss_ops._launch((conv, ssm), (new_c.float(), new_s), rows.long())
    call = model.calls[-1]
    assert call["dev_rows"] != rows.data_ptr()
    assert call["desc"][1] != new_c.data_ptr()
    assert call["desc"][6] == new_s.data_ptr()
    assert torch.equal(conv[:, :, [1, 4]].float(),
                       torch.ones((2, 1, 2, 3, 5)))


@pytest.mark.parametrize("fam,path", [("ssm", "chunked"),
                                      ("hybrid", "eager")])
def test_engine_state_writes_match_jax(model, monkeypatch, fam, path):
    """The engine's state writes (the fused steps' and the eager
    oracle's ``ssm_state_write`` flush) through the launch plan against
    the JAX engine: streams, every step's ``launches_by_kind`` (the
    queue still counts two ``ssm_state_write`` launches a flush, as JAX
    does) and zero arenas at the end; each write is one launch over the
    pair."""
    from test_torch_hybrid import PATHS, _waves, model as fam_model
    from test_torch_prefix import assert_same_run, run_both

    def scatter(arenas, news, rows):
        B = len(rows) if isinstance(rows, list) else rows.shape[0]
        if B:
            assert len(arenas) == 2
            ss_ops._launch(arenas, news, rows)

    monkeypatch.setattr(ss_ops, "_scatter", scatter)
    m = fam_model(fam)
    reset_launches()
    jeng, jrun, eng, run, _ = run_both(m, _waves(path, m[1].vocab_size),
                                       **PATHS[path])
    assert_same_run(jeng, jrun, eng, run)
    assert launch_counts()["state_scatter"] == len(model.calls) > 0
    assert all(len(c["desc"]) == 10 for c in model.calls)
    st = eng.cache.state
    assert st.rows_in_use == 0
    assert not torch.count_nonzero(st.conv) and not torch.count_nonzero(
        st.ssm)
    if path == "eager":
        writes = sum(d.get("ssm_state_write", 0) for d in run["deltas"])
        # the JAX count: two a flush, one per arena; one launch each here
        assert writes == 2 * sum(1 for c in model.calls
                                 if c["dev_rows"] is None)


@pytest.mark.cuda
def test_cuda_pair_matches_plain():
    """The kernel on the card: the pair (conv rows of 30 bytes, the byte
    path, beside 64-byte SSD rows) and 16-byte-aligned pairs, device and
    host rows, bit for bit against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    cuda = torch.device("cuda")
    g = torch.Generator().manual_seed(9)
    for conv_tail in ((3, 5), (3, 8)):
        conv = torch.randn((2, 3, 7) + conv_tail, generator=g).to(
            torch.bfloat16)
        ssm = torch.randn((2, 3, 7, 64, 64), generator=g)
        rows = [4, 1, 4]
        new_c = torch.randn((2, 3, 3) + conv_tail, generator=g).to(
            torch.bfloat16)
        new_s = torch.randn((2, 3, 3, 64, 64), generator=g)
        new_c[:, :, 2] = new_c[:, :, 0]
        new_s[:, :, 2] = new_s[:, :, 0]
        want = [a.clone() for a in (conv, ssm)]
        ss_ops.state_scatter_pair_inline(want[0], want[1], rows, new_c,
                                         new_s)
        for idx in (torch.tensor(rows, dtype=torch.int32, device=cuda),
                    rows):
            got = [a.to(cuda) for a in (conv, ssm)]
            reset_launches()
            ss_ops.state_scatter_pair_inline(got[0], got[1], idx,
                                             new_c.to(cuda), new_s.to(cuda))
            torch.cuda.synchronize()
            assert launch_counts()["state_scatter"] == 1
            assert torch.equal(got[0].cpu().view(torch.int16),
                               want[0].view(torch.int16))
            assert torch.equal(got[1].cpu(), want[1])
