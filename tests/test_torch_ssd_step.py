"""The paged decode's SSD state update (``ssm_scan.ops.ssd_step_rows``:
one ``ssd_step`` launch a Mamba sublayer) against the op sequence it
replaced and against the JAX package.

* The plain version (what a CPU tensor runs) bit for bit against the
  engine's old sequence: gather the rows' state, ``models.ssm._ssd_step``,
  ``torch.where(alive)``, ``index_select(rowmap)``; pad rows folded onto
  row 0, dead rows, rows in any arena order, and x, B and C as the
  strided views of the conv's output the engine passes.  The same
  through the launch plan: ``_StepModel``, a host model of
  ``ss_ssd_step`` as its contract in ``csrc/ssm_scan.cu`` states it,
  receives the wrapper's pointers, strides and sizes.
* ``models.ssm.ssm_decode_rows`` against the JAX package's decode step.
* mamba2 and jamba-one-period engines (chunked prefill, mixed rounds,
  K-blocks with dead rows, pure decode rounds) token and logit identical
  to the engine's old sublayer body.
* The wrapper's refusals; the benchmark's kernel group and launch
  reader.

The CUDA kernel has no CPU mode: the ``cuda``-marked tests hold it
against the plain ops on the card (the new state bit for bit, y within
float32's error bound of an n-term dot product) and inside a captured
graph's replay, and skip here.  JAX is imported in a fixture only.
"""

import ctypes
import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ss_ops  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BF16_TOL = 2 ** -6
F32_TOL = 1e-4


def _operands(seed, H, P, N, Bp, n_real, R, dead=(), order=None,
              dtype=torch.bfloat16, device="cpu"):
    """A sublayer's decode operands: an arena of ``R`` random rows, the
    batch's rows (``order``: the real rows' arena rows, else drawn) with
    ``Bp - n_real`` pad rows repeating row 0, ``rowmap`` folding them,
    ``alive`` False at ``dead`` (None when empty), x, B, C as views of
    one (Bp, 1, ch) conv output, dt > 0 and A < 0."""
    g = torch.Generator().manual_seed(seed)
    arena = torch.randn((R, H, P, N), generator=g).to(device)
    if order is None:
        order = torch.randperm(R, generator=g)[:n_real].tolist()
    rows = torch.tensor(order + [order[0]] * (Bp - n_real),
                        dtype=torch.int32, device=device)
    rowmap = torch.tensor(list(range(n_real)) + [0] * (Bp - n_real),
                          device=device)
    alive = None
    if dead:
        alive = torch.ones(Bp, dtype=torch.bool, device=device)
        alive[list(dead)] = False
    xbc = torch.randn((Bp, 1, H * P + 2 * N), generator=g).to(device, dtype)
    xx, B, C = torch.split(xbc, [H * P, N, N], dim=-1)
    x = xx.reshape(Bp, 1, H, P)[:, 0]
    dt = (torch.rand((Bp, H), generator=g) * 0.5 + 0.01).to(device)
    A = (-torch.rand(H, generator=g) * 2 - 0.1).to(device)
    out = torch.empty((Bp, H, P, N), device=device)
    return dict(arena=arena, rows=rows, rowmap=rowmap, alive=alive, x=x,
                dt=dt, A=A, B=B[:, 0], C=C[:, 0], out=out)


def _todays_ops(arena, rows, rowmap, alive, x, dt, A, B, C, out):
    """The engine's decode before the kernel: gather, the models' SSD
    step, the alive mask, the row fold."""
    state = arena[rows.long()]
    y, new = S._ssd_step(x[:, None], dt[:, None], A, B[:, None],
                         C[:, None], state)
    new = new.to(arena.dtype)
    if alive is not None:
        new = torch.where(alive[:, None, None, None], new, state)
    want = torch.empty_like(out)
    torch.index_select(new, 0, rowmap, out=want)
    return y[:, 0], want


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _at(ptr, dtype, shape, strides):
    """A CPU tensor over ``ptr``'s memory (the host model's view of a
    pointer the wrapper passed)."""
    size = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    item = torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * (size * item)).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).as_strided(shape, strides)


class _StepModel:
    """A host model of ``ss_ssd_step``: reads its operands at the
    pointers, strides and sizes it is given and runs the plain version
    over them, writing ``out`` and ``y`` where the kernel would."""

    def __init__(self, R):
        self.R = R
        self.calls = []

    def ss_ssd_step(self, arena, rows, rowmap, alive, x, x_stride, dt, A,
                    B, b_stride, C, c_stride, out, y, batch, heads, p, n,
                    bf16, stream):
        from repro_torch.kernels.ssm_scan import ref
        self.calls.append(dict(x_stride=x_stride, b_stride=b_stride,
                               c_stride=c_stride, sizes=(batch, heads, p, n),
                               bf16=bf16, alive=alive is not None))
        H, P, N, Bp = heads, p, n, batch
        act = torch.bfloat16 if bf16 else torch.float32
        ops = dict(
            arena=_at(arena, torch.float32, (self.R, H, P, N),
                      (H * P * N, P * N, N, 1)),
            rows=_at(rows, torch.int32, (Bp,), (1,)),
            rowmap=_at(rowmap, torch.int64, (Bp,), (1,)),
            alive=None if alive is None else _at(alive, torch.bool, (Bp,),
                                                 (1,)),
            x=_at(x, act, (Bp, H, P), (x_stride, P, 1)),
            dt=_at(dt, torch.float32, (Bp, H), (H, 1)),
            A=_at(A, torch.float32, (H,), (1,)),
            B=_at(B, act, (Bp, N), (b_stride, 1)),
            C=_at(C, act, (Bp, N), (c_stride, 1)),
            out=_at(out, torch.float32, (Bp, H, P, N),
                    (H * P * N, P * N, N, 1)))
        _at(y, torch.float32, (Bp, H, P), (H * P, P, 1)).copy_(
            ref.ssd_step_rows(**ops))
        return 0


@pytest.mark.parametrize("case", ["pad", "alive", "order", "launch_plan"])
def test_rows_equal_todays_ops(case, monkeypatch):
    """Bit for bit against the old sequence: pad rows (out holds row 0's
    new state, y each row's own), dead rows (their old state), rows in
    descending arena order, and the launch plan (pads and dead rows
    through the host model: pointers as they lie, x's, B's and C's row
    stride the conv output's)."""
    H, P, N, R = 3, 4, 16, 9
    kw = {"pad": dict(Bp=6, n_real=4),
          "alive": dict(Bp=5, n_real=5, dead=(1, 3)),
          "order": dict(Bp=4, n_real=4, order=[8, 5, 2, 0]),
          "launch_plan": dict(Bp=8, n_real=5, dead=(0, 4))}[case]
    ops = _operands(7, H, P, N, R=R, **kw)
    y_want, out_want = _todays_ops(**ops)
    reset_launches()
    if case == "launch_plan":
        model = _StepModel(R)
        monkeypatch.setattr(ss_ops, "_lib", model)
        monkeypatch.setattr(ss_ops, "_stream", lambda t: 0)
        y = ss_ops._launch_step(**ops)
        call, = model.calls
        ch = H * P + 2 * N
        assert (call["x_stride"], call["b_stride"], call["c_stride"]) == (
            ch, ch, ch)
        assert call["sizes"] == (kw["Bp"], H, P, N)
        assert call["bf16"] == 1 and call["alive"]
        assert LAUNCHES["ssd_step"] == 1
    else:
        y = ss_ops.ssd_step_rows(**ops)
        assert LAUNCHES["ssd_step"] == 0     # the plain version: no launch
    assert _same_bits(ops["out"], out_want)
    assert _same_bits(y, y_want)
    n = kw["n_real"]
    for b in range(n, kw["Bp"]):             # a pad row holds row 0's state
        assert _same_bits(ops["out"][b], ops["out"][0])
    for b in kw.get("dead", ()):
        assert _same_bits(ops["out"][b], ops["arena"][ops["rows"][b]])


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import ARCHS as JARCHS, ParallelConfig as JPCFG
    from repro.configs import reduced as jreduced
    from repro.models import ssm as JS
    from repro.models import transformer as JT
    from repro.models.params import init_params as jinit
    return types.SimpleNamespace(jax=jax, jnp=jnp, ARCHS=JARCHS,
                                 PCFG=JPCFG, reduced=jreduced, S=JS, T=JT,
                                 init=jinit)


def test_decode_rows_match_jax(jx):
    """``ssm_decode_rows`` over arena rows (a pad row, a dead row) against
    the JAX decode step on the same rows' state: the output at bf16's
    tolerance, the conv window exactly, the new state in float32."""
    from repro_torch.models.params import from_jax_params, numpy_to_torch

    jcfg = jx.reduced(jx.ARCHS["mamba2-1.3b"], num_layers=2)
    cfg = reduced(ARCHS["mamba2-1.3b"], num_layers=2)
    jparams = jx.init(jx.T.model_defs(jcfg), jx.jax.random.PRNGKey(0))
    params = from_jax_params(jx.jax.tree.map(np.asarray, jparams), "cpu")
    key = next(k for k in jparams["group0"] if k.endswith("_mamba"))
    jp = jx.jax.tree.map(lambda a: a[0], jparams["group0"][key]["ssm"])
    tp = {k: v[0] for k, v in params["group0"][key]["ssm"].items()}
    s = cfg.ssm
    nh = s.expand * cfg.d_model // s.head_dim
    ch = s.expand * cfg.d_model + 2 * s.state_dim
    rng = np.random.default_rng(3)
    R, Bp, n = 7, 4, 3
    arena = torch.from_numpy(rng.standard_normal(
        (R, nh, s.head_dim, s.state_dim)).astype(np.float32))
    rows = torch.tensor([5, 1, 3, 5], dtype=torch.int32)
    rowmap = torch.tensor([0, 1, 2, 0])
    alive = torch.tensor([True, True, False, True])
    h = rng.standard_normal((Bp, 1, cfg.d_model))
    conv = rng.standard_normal((Bp, s.conv_width - 1, ch))
    jh, jconv = (jx.jnp.asarray(a, jx.jnp.bfloat16) for a in (h, conv))
    th, tconv = (numpy_to_torch(np.asarray(a), "cpu") for a in (jh, jconv))
    out = torch.empty((Bp,) + tuple(arena.shape[1:]))
    got, new_conv = S.ssm_decode_rows(cfg, tp, th, conv_state=tconv,
                                      arena=arena, rows=rows, rowmap=rowmap,
                                      alive=alive, out=out)
    state = arena[rows.long()].numpy()
    jout, (jc, js) = jx.S.ssm_layer(jcfg, jx.PCFG(), jp, jh, mode="decode",
                                    cache=(jconv, jx.jnp.asarray(state)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jout, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_array_equal(new_conv.float().numpy(),
                                  np.asarray(jc, np.float32))
    want = np.array(js, np.float32)
    want[2] = state[2]                       # the dead row keeps its state
    np.testing.assert_allclose(out.numpy(), want[rowmap.numpy()],
                               rtol=F32_TOL, atol=F32_TOL)


def _old_run(self, cfg, pcfg, li, j, p, h, lens):
    """``_StateRound.run`` as it was before the kernel: the decode went
    through ``ssm_layer(mode="decode")`` on gathered rows, then the
    alive mask and the row fold of both states."""
    conv_j = self.conv[li, j][self.idx]
    ssm_j = self.ssm[li, j][self.idx]
    if lens is None:
        out, (nc, ns) = S.ssm_layer(cfg, pcfg, p, h, mode="decode",
                                    cache=(conv_j, ssm_j))
    else:
        out, (nc, ns) = S.ssm_layer_paged(cfg, pcfg, p, h, lengths=lens,
                                          conv_state=conv_j,
                                          ssm_state=ssm_j)
    nc = nc.to(self.conv.dtype)
    ns = ns.to(self.ssm.dtype)
    if self.alive is not None:
        nc = torch.where(self.alive[:, None, None], nc, conv_j)
        ns = torch.where(self.alive[:, None, None, None], ns, ssm_j)
    torch.index_select(nc, 0, self.rowmap, out=self.new_conv[li, j])
    torch.index_select(ns, 0, self.rowmap, out=self.new_ssm[li, j])
    return out


class _Recording(E.PagedEngine):
    """Keeps every token choice's logits."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.seen = []

    def _choose(self, logits, temps, seed, rowmap=None):
        self.seen.append(logits.clone())
        return super()._choose(logits, temps, seed, rowmap=rowmap)


def _serve(cfg, params):
    """5 requests of 3-19 tokens, 4-11 new, odd ids sampled: 8-token
    chunks, mixed rounds, 4-round K-blocks whose rows stop apart."""
    eng = _Recording(cfg, params, device="cpu", page_size=4, num_pages=64,
                     max_prefill_chunk=8, mixed_rounds=True,
                     decode_block_rounds=4)
    rng = np.random.default_rng(1)
    for i in range(5):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(3, 20)))
        eng.submit(E.Request(i, prompt.astype(np.int32),
                             max_new_tokens=int(rng.integers(4, 12)),
                             temperature=float(i % 2)))
    results = {}
    while eng.has_work:
        results.update(eng.run(max_rounds=eng.decode_block_rounds
                               if not eng.queue else 1))
    return eng, results


@pytest.mark.parametrize("arch,kw", [
    ("mamba2-1.3b", dict(num_layers=2)),
    ("jamba-1.5-large-398b", dict(num_layers=4, attn_every=4))])
def test_engine_streams_unchanged(arch, kw, monkeypatch):
    """Served through ``_StateRound`` with the decode's SSD step on arena
    rows, and with the old sublayer body: the same streams, every
    choice's logits bit for bit, the same rounds, and zero arenas at the
    end; the step ran on rows on every decode forward."""
    cfg = reduced(ARCHS[arch], **kw)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           chunk_size=4))
    params = init_params(T.model_defs(cfg), torch.Generator().manual_seed(0),
                         "cpu", torch.bfloat16)
    calls = []
    step = ss_ops.ssd_step_rows

    def counted(*a, **k):
        calls.append(1)
        return step(*a, **k)

    monkeypatch.setattr(ss_ops, "ssd_step_rows", counted)
    new_eng, new = _serve(cfg, params)
    monkeypatch.setattr(E._StateRound, "run", _old_run)
    n_calls = len(calls)
    old_eng, old = _serve(cfg, params)
    assert len(calls) == n_calls > 0
    assert new == old
    assert len(new_eng.seen) == len(old_eng.seen)
    assert all(torch.equal(a, b) for a, b in zip(new_eng.seen, old_eng.seen))
    st = new_eng.stats
    assert st == old_eng.stats | {k: st[k] for k in st if "seconds" in k}
    assert st["multi_round_blocks"] >= 1 and st["mixed_dispatches"] >= 1
    assert st["decode_rounds"] > st["mixed_dispatches"]
    state = new_eng.cache.state
    assert state.rows_in_use == 0
    assert not state.ssm.count_nonzero() and not state.conv.count_nonzero()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """A wrong dtype (int64 rows, a bf16 arena, B unlike x), a wrong
    shape (dt, out, a 3-D arena) and non-dense inputs (a transposed
    arena, x with its p stride not 1) raise before anything runs."""
    ops = _operands(1, 2, 4, 16, Bp=3, n_real=2, R=4)
    bad = {"rows": ops["rows"].long(),
           "arena": ops["arena"].to(torch.bfloat16),
           "B": ops["B"].float(),
           "dt": ops["dt"][:, :1],
           "out": ops["out"][:2]}
    for name, t in bad.items():
        with pytest.raises(ValueError):
            ss_ops.ssd_step_rows(**{**ops, name: t})
    with pytest.raises(ValueError):
        ss_ops.ssd_step_rows(**{**ops, "arena": ops["arena"][0]})
    with pytest.raises(ValueError, match="contiguous"):
        ss_ops.ssd_step_rows(**{**ops, "arena": ops["arena"].transpose(
            0, 1).contiguous().transpose(0, 1)})
    with pytest.raises(ValueError, match="dense"):
        ss_ops.ssd_step_rows(**{**ops, "x": ops["x"].transpose(1, 2)
                                .contiguous().transpose(1, 2)})
    ss_ops.ssd_step_rows(**ops)              # and the operands as made run


def test_kernel_group_names_the_kernel():
    """The benchmark's breakdown puts the kernel's profiler name in the
    ``ssd_step`` group, and no other group's pattern claims it."""
    from bench import trace

    groups = trace.load_groups()
    for name in ("void (anonymous namespace)::ssd_step_kernel<128, "
                 "__nv_bfloat16>((anonymous namespace)::SsdStep)",
                 "(anonymous namespace)::ssd_step_kernel<32, float>"):
        assert trace.group_of(name, groups) == "ssd_step"
        assert [g for g, ps in groups if any(p.search(name) for p in ps)
                ] == ["ssd_step"]


def test_launch_reader_without_and_with_the_counter():
    """``ssd_step_launches_per_round.batch``: None where the program
    counts no ``ssd_step`` (a program without the kernel) or no round,
    else the launches over the decode rounds."""
    path = ROOT / "bench" / "metrics" / "ssd_step_launches_per_round.batch.py"
    spec = importlib.util.spec_from_file_location("ssd_step_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def window(rounds, launches):
        c0 = types.SimpleNamespace(launches0=dict(launches[0]))
        c1 = types.SimpleNamespace(launches1=dict(launches[1]))
        w = types.SimpleNamespace(calls=[c0, c1], d=lambda key: rounds)
        w.launches = lambda k: c1.launches1[k] - c0.launches0[k]
        return w

    assert mod.read(window(10, ({"state_scatter": 0},
                                {"state_scatter": 10}))) is None
    assert mod.read(window(0, ({"ssd_step": 0}, {"ssd_step": 0}))) is None
    assert mod.read(window(10, ({"ssd_step": 4}, {"ssd_step": 484}))) == 48


# ------------------------------------------------------------------ #
# The kernel on the card (``python -m pytest -m cuda --noconftest
# tests/test_torch_ssd_step.py``)
# ------------------------------------------------------------------ #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _check_card(ops, y):
    """The kernel's result against the plain ops run on the card: the new
    state bit for bit; y within the float32 error bound of two n-term dot
    products taken in different orders, 2 n 2^-24 sum_n |C_n new_n|."""
    plain = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in ops.items()}
    y_want, out_want = _todays_ops(**plain)
    torch.cuda.synchronize()
    assert _same_bits(ops["out"], out_want)
    new = S._ssd_step(ops["x"][:, None], ops["dt"][:, None], ops["A"],
                      ops["B"][:, None], ops["C"][:, None],
                      ops["arena"][ops["rows"].long()])[1]
    N = ops["arena"].shape[-1]
    mag = torch.einsum("bn,bhpn->bhp", ops["C"].float().abs(), new.abs())
    err = (y - y_want).abs()
    assert bool((err <= 2 * N * 2.0 ** -24 * mag + 1e-30).all()), \
        float((err / mag.clamp_min(1e-30)).max())


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_ops(cuda):
    """mamba2's and jamba's (p, n) at 64 heads, the reduced configs', two
    words a lane with p not a multiple of a step's rows, and 4 lanes a
    row; bf16 and float32 inputs; pad rows, with and without a dead
    row."""
    for H, P, N, Bp, n_real, dtype in (
            (64, 64, 128, 16, 13, torch.bfloat16),
            (8, 16, 32, 8, 5, torch.bfloat16),
            (3, 5, 256, 4, 4, torch.float32),
            (2, 7, 16, 6, 3, torch.float32)):
        ops = _operands(11, H, P, N, Bp=Bp, n_real=n_real, R=Bp + 5,
                        dead=(1,), dtype=dtype, device=cuda)
        reset_launches()
        y = ss_ops.ssd_step_rows(**ops)
        assert LAUNCHES["ssd_step"] == 1
        _check_card(ops, y)
        ops["alive"] = None
        _check_card(ops, ss_ops.ssd_step_rows(**ops))


@pytest.mark.cuda
def test_cuda_kernel_in_a_captured_graph(cuda):
    """Captured once, replayed over new arena contents, inputs and alive
    masks (pad rows included): each replay equals the plain ops."""
    ops = _operands(12, 64, 64, 128, Bp=8, n_real=6, R=12, dead=(2,),
                    device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ss_ops.ssd_step_rows(**ops)          # warm: the library loads
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = ss_ops.ssd_step_rows(**ops)
    g = torch.Generator(device=cuda).manual_seed(5)
    for alive in ([True] * 8, [False, True, True, False] + [True] * 4):
        ops["arena"].copy_(torch.randn(ops["arena"].shape, generator=g,
                                       device=cuda))
        ops["dt"].copy_(torch.rand(ops["dt"].shape, generator=g,
                                   device=cuda))
        ops["alive"].copy_(torch.tensor(alive, device=cuda))
        graph.replay()
        _check_card(ops, y)
