"""Data-parallel training of the port: two ranks against one.

Two gloo ranks on the CPU (``launch.mesh.run_ranks``, each run under
its own time limit) each take their contiguous half of the global
batch; the train step sums their gradients in float32 with one
``all_reduce`` before the clip.  Held against one process on the whole
global batch, from the same weights:

* one ``make_train_step`` step (``reduced(gemma-2b)`` at width 64 and
  two layers, float32): the loss, the gradient norm and every updated
  parameter (``*_RTOL``/``UPDATE_ATOL``: the two runs sum the batch's
  per-token gradients in different orders, float32 rounding apart);
* ``launch.train.main --data-axis 2 --backend gloo``: the first step's
  loss bit for bit (the same weights and batch), the next three's at
  ``LAUNCH_RTOL`` (the launcher's AdamW has ``eps=1e-8``, so its first
  updates are about ``lr * sign(g)``, and a gradient component near
  zero whose float32 sum the two runs order differently moves by ``lr``
  in one and not the other: 3.5e-5 relative measured at step 4);
* checkpoint and restart at world 2: an injected failure at step 3 with
  checkpoints every 2 steps restarts both ranks from step 2 (rank 0
  wrote it, in the one-process layout, which a one-process
  ``Checkpointer`` reloads), and the losses equal the uninterrupted
  two-rank run's bit for bit.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks as R  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import (ARCHS, OptimizerConfig,  # noqa: E402
                                 ParallelConfig, reduced)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import (init_params, torch_to_numpy,  # noqa: E402
                                       tree_leaves, tree_map)
from repro_torch.training.train_step import make_train_step  # noqa: E402

LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-4
UPDATE_ATOL = 5e-6
LAUNCH_RTOL = 1e-4
SMALL = ["--device", "cpu", "--reduced", "--width", "64", "--layers", "2",
         "--batch", "4", "--seq", "32", "--log-every", "100"]


def _cfg():
    return reduced(ARCHS["gemma-2b"], d_model=64, num_layers=2, d_ff=256,
                   vocab_size=512)


def test_train_step_world2_matches_one_rank_on_global_batch():
    cfg = _cfg()
    params = init_params(T.model_defs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    np_params = tree_map(lambda t: torch_to_numpy(t), params)
    ranks = run_ranks(R.train_step_ranks, 2, backend="gloo", timeout=90.0,
                      args=(cfg, np_params, batch))
    init_state, step = make_train_step(
        cfg, ParallelConfig(remat="none", attention_impl="naive",
                            moe_impl="dense"),
        OptimizerConfig(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10))
    state, metrics = step(init_state(tree_map(torch.clone, params)),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    want = dict(tree_leaves(state["params"]))
    for r in ranks:
        m = r["metrics"]
        assert m["loss"] == pytest.approx(float(metrics["loss"]),
                                          rel=LOSS_RTOL)
        assert m["grad_norm"] == pytest.approx(float(metrics["grad_norm"]),
                                               rel=GNORM_RTOL)
        assert m["tokens"] == float(metrics["tokens"])
        for path, t in want.items():
            torch.testing.assert_close(r["params"][path], t, rtol=0,
                                       atol=UPDATE_ATOL, msg=path)
    for path in want:                    # replicated: the ranks agree
        assert torch.equal(ranks[0]["params"][path], ranks[1]["params"][path])


def test_launcher_data_axis2_matches_one_rank(tmp_path, capsys):
    one = launch_train.main(SMALL + ["--steps", "4", "--ckpt-dir",
                                     str(tmp_path / "one")])
    two = launch_train.main(SMALL + ["--steps", "4", "--data-axis", "2",
                                     "--backend", "gloo", "--rank-timeout",
                                     "120", "--ckpt-dir",
                                     str(tmp_path / "two")])
    assert sorted(two["losses"]) == sorted(one["losses"]) == [0, 1, 2, 3]
    assert two["losses"][0] == one["losses"][0]
    for s in range(1, 4):
        assert two["losses"][s] == pytest.approx(one["losses"][s],
                                                 rel=LAUNCH_RTOL)
    assert two["steps_run"] == 4 and two["restarts"] == 0


def test_checkpoint_and_restart_at_world2(tmp_path):
    args = launch_train._parser().parse_args(
        SMALL + ["--steps", "6", "--ckpt-every", "2", "--data-axis", "2",
                 "--backend", "gloo"])
    clean = run_ranks(launch_train._train_rank, 2, backend="gloo",
                      timeout=120.0, args=(args, str(tmp_path / "clean")))
    args.fail_at = [3]
    failed = run_ranks(launch_train._train_rank, 2, backend="gloo",
                       timeout=120.0, args=(args, str(tmp_path / "failed")))
    for r in failed:
        assert r["restarts"] == 1 and r["resumed_from"] == [2]
        assert r["losses"] == clean[0]["losses"]
    assert failed[0]["losses"] == failed[1]["losses"]
    # rank 0's checkpoints, in the one-process layout
    ckpt = Checkpointer(str(tmp_path / "failed"))
    assert ckpt.latest_step() == 6
    cfg = reduced(ARCHS["gemma-2b"], d_model=64, num_layers=2, d_ff=256,
                  vocab_size=4096)
    params = init_params(T.model_defs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    init_state, _ = make_train_step(cfg, ParallelConfig(), OptimizerConfig())
    state, step = ckpt.load(init_state(params))
    assert step == 6
    assert all(torch.isfinite(t).all() for _, t in tree_leaves(state))


def test_mesh_layout_over_four_ranks():
    """Ranks lie row-major over ``{data: 2, model: 2}``, as
    ``jax.make_mesh`` lays out devices; each axis's subgroup sums the
    ranks that share the other coordinate; the production mesh refuses
    a world of four."""
    out = run_ranks(R.mesh_layout, 4, backend="gloo", timeout=60.0)
    grid = np.arange(4).reshape(2, 2)
    for rank, r in enumerate(out):
        d, m = r["data"], r["model"]
        assert grid[d, m] == rank
        assert r["sum_data"] == float(grid[:, m].sum())
        assert r["sum_model"] == float(grid[d, :].sum())
        assert "needs 256 ranks" in r["production"]


@pytest.mark.parametrize("how", ["raise", "hang"])
def test_run_ranks_ends_every_rank_on_failure_or_time_limit(how):
    """A rank that raises ends the run at once with its traceback; a rank
    that never returns ends it at the time limit; either way every rank
    is ended and the call raises."""
    t = time.monotonic()
    with pytest.raises(RuntimeError,
                       match=("rank 1 fails on purpose" if how == "raise"
                              else "did not finish within")):
        run_ranks(R.fail_or_hang, 2, backend="gloo", timeout=10.0,
                  args=(how,))
    assert time.monotonic() - t < 30.0
