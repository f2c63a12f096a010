"""The ZeRO-3 training layout of the port (``sharding_env(mesh,
fsdp=True)``, the JAX launcher's) against one process and the JAX step.

gloo ranks on the CPU (``launch.mesh.run_ranks``) at worlds 2 and 4, on
``test_torch_data_parallel.py``'s model (``reduced(gemma-2b)`` at width
64, two layers) in float32 (``layers.COMPUTE_DTYPE``), remat "full" so
the recompute gathers again.  Each rank holds only its slices of the
parameters and of the optimizer state.  Held, for AdamW and Adafactor:

* two steps' loss, gradient norm and every updated parameter (the
  ranks' slices put together) against one process on the global batch,
  at ``LOSS_RTOL`` / ``GNORM_RTOL`` / ``UPDATE_ATOL``, the constants of
  ``test_torch_data_parallel.py`` (the sums run in other orders);
* the first step against the JAX package's ``make_train_step`` on the
  same global batch and weights, at the same tolerances;
* after one step, every rank's slices of the parameters and the
  optimizer state against the replicated data-parallel step's state
  (same ranks, same blocks), cut to the same slices, within float32
  reordering of each leaf's scale (``SLICE_RTOL`` of its largest value;
  after two steps AdamW's ``1 / eps`` gain carries the first step's
  reordering into ~1e-5 of the moments' scale).

A checkpoint written at world 2 keeps the one-device layout: it loads in
one process and in the JAX package's ``Checkpointer`` equal to the
ranks' slices put together, and two ranks that resume from it take the
last steps bit for bit as the unbroken run did.  ``Mesh.all_gather``
along a dim and ``Mesh.reduce_scatter`` (both routes) are held at world
4; the collectives over an axis of one rank run and are not counted.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks as R  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import OptimizerConfig, ParallelConfig  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import (from_jax_params,  # noqa: E402
                                       init_params, torch_to_numpy,
                                       tree_leaves, tree_map)
from repro_torch.training.train_step import make_train_step  # noqa: E402
from test_torch_data_parallel import (GNORM_RTOL, LOSS_RTOL,  # noqa: E402
                                      UPDATE_ATOL, _cfg)

OPTS = {"adamw": dict(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10),
        "adafactor": dict(name="adafactor", lr=1e-3, warmup_steps=1,
                          total_steps=10)}
PK = dict(remat="full", attention_impl="naive", moe_impl="dense")
SLICE_RTOL = 1e-5
STEPS = 2


def _setup(steps=STEPS, batch=8):
    cfg = _cfg()
    params = init_params(T.model_defs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (batch, 17)).astype(np.int32)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    np_params = tree_map(torch_to_numpy, params)
    return cfg, params, np_params, batches


def _whole(ranks, path, which="state"):
    """A state leaf put together from the ranks' slices (``which``: at
    the end, or ``"snap"``, after the snapshot's step)."""
    d = ranks[0]["dims"][path]
    parts = [r[which][path] for r in ranks]
    return parts[0] if d is None else torch.cat(parts, dim=d)


def _one_process(cfg, params, batches, opt, monkeypatch):
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    init, step = make_train_step(cfg, ParallelConfig(**PK),
                                 OptimizerConfig(**OPTS[opt]))
    state = init(tree_map(torch.clone, params))
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


_JAX = {}


def _jax_first_step(cfg, np_params, batch, opt):
    """The JAX package's first step on the global batch, float32."""
    if opt not in _JAX:
        import jax
        import jax.numpy as jnp
        from repro.configs import ARCHS as JARCHS, reduced as jreduced
        from repro.configs import (OptimizerConfig as JOCFG,
                                   ParallelConfig as JPCFG)
        from repro.models import layers as JL
        from repro.training.train_step import make_train_step as jmake

        jcfg = jreduced(JARCHS["gemma-2b"], d_model=64, num_layers=2,
                        d_ff=256, vocab_size=512)
        mp = pytest.MonkeyPatch()
        mp.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
        try:
            ji, js = jmake(jcfg, JPCFG(**PK), JOCFG(**OPTS[opt]))
            jp = jax.tree.map(jnp.asarray, np_params)
            state, m = jax.jit(js)(ji(jp), jax.tree.map(jnp.asarray, batch))
            _JAX[opt] = (jax.tree.map(np.asarray, state["params"]),
                         {k: float(v) for k, v in m.items()})
        finally:
            mp.undo()
    return _JAX[opt]


@pytest.mark.parametrize("world", [2, 4])
def test_zero_step_matches_one_process_and_jax(world, monkeypatch):
    """AdamW and Adafactor, each rank group running both."""
    cfg, params, np_params, batches = _setup()
    runs = run_ranks(R.zero_steps_each, world, backend="gloo",
                     timeout=150.0, args=(cfg, np_params, batches, OPTS))
    for opt in OPTS:
        _check_zero_run([r[opt] for r in runs], world, opt, cfg, params,
                        np_params, batches, monkeypatch)


def _check_zero_run(ranks, world, opt, cfg, params, np_params, batches,
                    monkeypatch):
    dims = ranks[0]["dims"]
    assert any(d is not None for p, d in dims.items()
               if p.startswith("params/group0"))
    # after one step: the slices against the replicated step's, and the
    # JAX step's parameters
    for r in ranks:
        for path, t in r["snap"].items():
            want = r["replicated"][path]
            assert t.shape == want.shape, path
            if dims[path] is not None:
                assert t.numel() * world == _whole(ranks, path,
                                                   "snap").numel(), path
            scale = float(want.abs().max()) if want.numel() else 0.0
            torch.testing.assert_close(t, want, rtol=0,
                                       atol=SLICE_RTOL * scale + 1e-30,
                                       msg=path)
    jparams, jm = _jax_first_step(cfg, np_params, batches[0], opt)
    m = ranks[0]["metrics"][0]
    assert m["loss"] == pytest.approx(jm["loss"], rel=LOSS_RTOL)
    assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=GNORM_RTOL)
    for path, want in tree_leaves(from_jax_params(jparams, "cpu")):
        torch.testing.assert_close(_whole(ranks, f"params/{path}", "snap"),
                                   want, rtol=0, atol=UPDATE_ATOL, msg=path)
    # two steps against one process on the global batch
    state, metrics = _one_process(cfg, params, batches, opt, monkeypatch)
    for s in range(STEPS):
        for r in ranks:
            m = r["metrics"][s]
            assert m["loss"] == pytest.approx(metrics[s]["loss"],
                                              rel=LOSS_RTOL)
            assert m["grad_norm"] == pytest.approx(metrics[s]["grad_norm"],
                                                   rel=GNORM_RTOL)
            assert m["tokens"] == metrics[s]["tokens"]
    for path, t in tree_leaves(state["params"]):
        torch.testing.assert_close(_whole(ranks, f"params/{path}"), t,
                                   rtol=0, atol=UPDATE_ATOL, msg=path)


def test_checkpoint_at_world2_is_one_device_and_resumes(tmp_path):
    """Four steps at world 2, the ZeRO state saved after two; the
    checkpoint loads in one process and in the JAX ``Checkpointer``
    equal to the ranks' slices put together after step 2, and two ranks
    resuming from it take steps 3-4 bit for bit as the unbroken run."""
    cfg, params, np_params, batches = _setup(steps=4)
    d = str(tmp_path / "ckpt")
    full = run_ranks(R.zero_steps, 2, backend="gloo", timeout=120.0,
                     args=(cfg, np_params, batches, OPTS["adamw"], d, False,
                           2, 2))
    resumed = run_ranks(R.zero_steps, 2, backend="gloo", timeout=120.0,
                        args=(cfg, np_params, batches, OPTS["adamw"], d,
                              True))
    assert resumed[0]["start"] == 2
    for r, f in zip(resumed, full):
        assert r["metrics"] == f["metrics"][2:]
        for path, t in r["state"].items():
            assert torch.equal(t, f["state"][path]), path
    init, _ = make_train_step(cfg, ParallelConfig(**PK),
                              OptimizerConfig(**OPTS["adamw"]))
    like = init(tree_map(torch.clone, params))
    loaded, step = Checkpointer(d).load(like)
    assert step == 2
    for path, t in tree_leaves(loaded):
        assert torch.equal(t, _whole(full, path, "snap")), path
    import jax
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    jlike = tree_map(lambda t: np.zeros(t.shape, torch_to_numpy(t).dtype),
                     like)
    jloaded, jstep = JCheckpointer(d).load(jlike)
    assert jstep == 2
    for (path, t), (_, j) in zip(tree_leaves(loaded),
                                 tree_leaves(jax.tree.map(np.asarray,
                                                          jloaded))):
        np.testing.assert_array_equal(torch_to_numpy(t), j, err_msg=path)


def test_bf16_compute_gathers_cast_leaves_as_replicated():
    """bf16 compute (the launcher's): the dense layers' leaves gather in
    bf16 (the cast moved before the gather), the gradients still
    reduce-scatter in float32 to the float32 slices;
    after one step every slice equals the replicated step's within
    float32 reordering, and the loss is the replicated run's bit for
    bit (the same forward)."""
    cfg, params, np_params, batches = _setup(steps=1)
    ranks = run_ranks(R.zero_steps, 2, backend="gloo", timeout=120.0,
                      args=(cfg, np_params, batches, OPTS["adamw"], None,
                            False, None, 1, False))
    for r in ranks:
        for path, t in r["snap"].items():
            want = r["replicated"][path]
            assert t.dtype == want.dtype, path
            scale = float(want.abs().max()) if want.numel() else 0.0
            torch.testing.assert_close(t, want, rtol=0,
                                       atol=SLICE_RTOL * scale + 1e-30,
                                       msg=path)
    for r in ranks:
        assert r["metrics"][0]["loss"] == r["replicated_metrics"][0]["loss"]


def test_gather_and_reduce_scatter_over_four_ranks():
    """``all_gather`` along a dim is the blocks in rank order;
    ``reduce_scatter`` this rank's block of the sum; the byte counters
    count each call's output."""
    out = run_ranks(R.collectives, 4, backend="gloo", timeout=60.0)
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    parts = [x + 100 * r for r in range(4)]
    full = torch.arange(8 * 4 * 3, dtype=torch.float32).reshape(3, 32)
    total = full * sum(r + 1 for r in range(4))
    for rank, o in enumerate(out):
        assert torch.equal(o["gather1"], torch.cat(parts, dim=1))
        assert torch.equal(o["gather0"], torch.cat(parts, dim=0))
        want = total[:, rank * 8:(rank + 1) * 8]
        assert torch.equal(o["scatter"], want)
        b = o["bytes"]
        assert b["_counts"] == {"all-gather": 2, "all-reduce": 0,
                                "reduce-scatter": 1, "all-to-all": 0,
                                "collective-permute": 0}
        assert b["all-gather"] == 2 * 4 * 24 * 4
        assert b["reduce-scatter"] == 3 * 8 * 4
        assert b["all-reduce"] == 0


def test_one_rank_axis_runs_and_is_not_counted():
    """A collective over an axis of one rank goes to the backend (its
    result the input's) and adds nothing to the byte counters, as XLA
    drops such collectives from the JAX package's counts."""
    from repro_torch.launch.mesh import make_local_mesh, process_group
    with process_group("gloo"):
        mesh = make_local_mesh()
        x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
        assert torch.equal(mesh.all_reduce(x.clone(), "model"), x)
        assert torch.equal(mesh.all_gather(x, "data", 1), x)
        assert torch.equal(mesh.reduce_scatter(x, "data", 1), x)
        assert torch.equal(mesh.all_to_all_single(x, "model"), x)
        b = mesh.collective_bytes()
    assert set(b.pop("_counts").values()) == {0}
    assert set(b.values()) == {0}
