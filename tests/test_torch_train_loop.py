"""The port's training loop against the JAX package's, on the CPU: the
synthetic data stream, checkpoints across the packages, async save and
garbage collection, supervised restart, five steps of the loop, and the
launcher.

The loop comparison runs both packages in float32 (each
``layers.COMPUTE_DTYPE`` patched), as ``test_torch_forward.py`` does.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import ARCHS as JARCHS, OptimizerConfig as JOCFG  # noqa: E402
from repro.configs import ParallelConfig as JPCFG, ShapeConfig as JShape  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data.pipeline import PipelineConfig as JPipe, SyntheticLM as JSynth  # noqa: E402
from repro.models import layers as JL, transformer as JT  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.training.optimizer import adamw_init as jadamw_init  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro.training.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import (ARCHS, OptimizerConfig, ParallelConfig,  # noqa: E402
                                 ShapeConfig, reduced)
from repro_torch.data.pipeline import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers as L, transformer as T  # noqa: E402
from repro_torch.models.params import from_jax_params, tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime.fault_tolerance import (FailureInjector,  # noqa: E402
                                                 HeartbeatMonitor,
                                                 InjectedFailure, Supervisor)
from repro_torch.training.optimizer import adamw_init  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402

TINY = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=128, num_heads=2,
            num_kv_heads=2, head_dim=16)


def _tiny_state(seed=0):
    """The JAX fault-tolerance tests' tiny stablelm (2 layers, width 32),
    weights from the JAX init carried across; (cfg, state, step_fn,
    data) of the port, with float32 AdamW state."""
    jcfg, cfg = (jreduced(JARCHS["stablelm-3b"], **TINY),
                 reduced(ARCHS["stablelm-3b"], **TINY))
    params = from_jax_params(jax.tree.map(np.asarray, jinit(
        JT.model_defs(jcfg), jax.random.PRNGKey(seed))), "cpu")
    init_state, step = make_train_step(
        cfg, ParallelConfig(remat="none", attention_impl="naive"),
        OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=50))
    data = SyntheticLM(cfg, ShapeConfig("t", 32, 4, "train"),
                       PipelineConfig(seed=5))

    def step_fn(st, batch):
        return step(st, {k: torch.from_numpy(v) for k, v in batch.items()})

    return cfg, init_state(params), step_fn, data


def _clone(state):
    return tree_map(torch.clone, state)


def _same(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y)
               in zip(tree_leaves(a), tree_leaves(b)))


def test_synthetic_lm_batches_match_jax():
    """``SyntheticLM`` batches equal JAX's bit for bit (values, dtypes,
    keys) for a dense model, a vlm (patch embeds, labels shifted past
    the patches) and an encdec model (frames, the sequence split), at
    three steps and two seeds; ``Prefetcher`` yields them in order."""
    from repro_torch.data.pipeline import Prefetcher
    for arch in ("stablelm-3b", "llava-next-34b", "seamless-m4t-medium"):
        for seed in (1, 7):
            ours = SyntheticLM(reduced(ARCHS[arch]),
                               ShapeConfig("t", 40, 3, "train"),
                               PipelineConfig(seed=seed))
            ref = JSynth(jreduced(JARCHS[arch]), JShape("t", 40, 3, "train"),
                         JPipe(seed=seed))
            for step in (0, 1, 9):
                a, b = ours.batch(step), ref.batch(step)
                assert sorted(a) == sorted(b), arch
                for k in a:
                    assert a[k].dtype == b[k].dtype, (arch, k)
                    np.testing.assert_array_equal(a[k], b[k])
    it = Prefetcher(iter(ours))
    for step in range(3):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      ours.batch(step)["tokens"])


def test_checkpoints_load_across_packages(tmp_path):
    """A train state (float32 params, bf16 AdamW moments, the int32
    step) written by JAX loads in the port bit for bit, and the port's
    checkpoint of the same state holds the same files, byte for byte
    (bf16 as JAX writes it: ``descr '<V2'``), with the same manifest
    leaves; JAX's loader reads the port's files back (its bf16 leaves
    viewed as ``ml_dtypes.bfloat16``, as they come from JAX's own)."""
    jcfg = jreduced(JARCHS["stablelm-3b"], **TINY)
    jparams = jinit(JT.model_defs(jcfg), jax.random.PRNGKey(1))
    jopt = jadamw_init(jparams, jnp.bfloat16)
    jopt = {"m": jax.tree.map(lambda x: x + 0.5, jopt["m"]),
            "v": jax.tree.map(lambda x: x + 0.25, jopt["v"]),
            "step": jnp.asarray(1, jnp.int32)}
    jstate = {"params": jparams, "opt": jopt}
    JCheckpointer(str(tmp_path / "jax")).save(3, jstate, blocking=True)

    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    like = {"params": params, "opt": adamw_init(params, torch.bfloat16)}
    got, step = Checkpointer(str(tmp_path / "jax")).load(like)
    assert step == 3 and int(got["opt"]["step"]) == 1
    assert got["opt"]["m"]["embed"]["tok"].dtype == torch.bfloat16
    want = from_jax_params(jax.tree.map(np.asarray, jstate), "cpu")
    assert _same(got, want)

    Checkpointer(str(tmp_path / "torch")).save(3, got, blocking=True)
    jdir, tdir = tmp_path / "jax" / "step_3", tmp_path / "torch" / "step_3"
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert "params__embed__tok.npy" in names and "opt__step.npy" in names
    for n in names:
        if n.endswith(".npy"):
            assert (jdir / n).read_bytes() == (tdir / n).read_bytes(), n
    jm, tm = (json.loads((d / "manifest.json").read_text())
              for d in (jdir, tdir))
    assert jm["leaves"] == tm["leaves"] and tm["step"] == 3

    def as_jax(name, arr):
        if arr.dtype.kind == "V":
            arr = arr.view(ml_dtypes.bfloat16)
        return jnp.asarray(arr)

    back, _ = JCheckpointer(str(tmp_path / "torch")).load(
        jstate, sharding_fn=as_jax)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_async_save_and_gc(tmp_path):
    """Saves return before the files are written and copy the state to
    the host first: updating it in place after ``save`` leaves the
    checkpoint as it was; ``keep=2`` leaves the last two steps."""
    _, state, _, _ = _tiny_state()
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, state)
    snapshot = _clone(state)
    with torch.no_grad():
        for _, t in tree_leaves(state["params"]):
            t.add_(1.0)
    ck.wait()
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    restored, step = ck.load(state)
    assert step == 4 and _same(restored, snapshot)
    assert not os.path.exists(tmp_path / ".tmp_step_4")


def test_supervisor_restart_resumes_bit_exact(tmp_path):
    """The port's counterpart of JAX's
    ``test_restart_resumes_bit_exact``: failures injected at steps 7
    and 13, checkpoints every 5; the run resumes from 5 and 10 and its
    loss at every step equals an uninterrupted run's bit for bit (the
    stream is keyed by step, the CPU's arithmetic deterministic).  A
    failure at every visit exceeds ``max_restarts``."""
    _, state0, step_fn, data = _tiny_state()
    clean = Supervisor(Checkpointer(str(tmp_path / "a")), ckpt_every=5)
    _, rep_clean = clean.run(_clone(state0), step_fn, data.batch, 20)
    sup = Supervisor(Checkpointer(str(tmp_path / "b")), ckpt_every=5,
                     injector=FailureInjector(fail_at=[7, 13]))
    _, rep = sup.run(_clone(state0), step_fn, data.batch, 20)
    assert rep.restarts == 2 and rep.resumed_from == [5, 10]
    assert rep.steps_run == 20 + 2 + 3
    assert rep.losses == rep_clean.losses and len(rep.losses) == 20

    class AlwaysFail(FailureInjector):
        def check(self, step):
            if step == 3:
                raise InjectedFailure("always")

    sup = Supervisor(Checkpointer(str(tmp_path / "c")), ckpt_every=100,
                     max_restarts=2, injector=AlwaysFail())
    with pytest.raises(InjectedFailure):
        sup.run(_clone(state0), step_fn, data.batch, 10)
    mon = HeartbeatMonitor(straggler_factor=5.0, window=16)
    for i in range(10):
        mon.last_beat -= 0.01
        mon.beat(i)
    mon.last_beat -= 1.0
    assert mon.beat(11) and mon.stragglers == [11]


def test_five_steps_match_jax_loop(monkeypatch):
    """Five steps of the port's loop (``make_train_step`` over
    ``SyntheticLM``, remat full, chunked attention in tiles of 16 over
    32 positions, AdamW at its defaults) against JAX's ``make_train_step``
    from the same weights and batches, both in float32: every step's
    loss within 1e-4 relative.  After step 1, AdamW's update of a
    gradient at float32 noise may take either sign (2 * lr on a few
    parameters), which moves later losses by far less than this."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    jcfg, cfg = (jreduced(JARCHS["gemma-2b"], **TINY),
                 reduced(ARCHS["gemma-2b"], **TINY))
    jparams = jinit(JT.model_defs(jcfg), jax.random.PRNGKey(2))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    kw = dict(remat="full", attention_impl="chunked", attention_chunk=16)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    ji, js = jmake_train_step(jcfg, JPCFG(**kw), JOCFG(**ocfg))
    ti, ts = make_train_step(cfg, ParallelConfig(**kw),
                             OptimizerConfig(**ocfg))
    jstate, state = ji(jparams), ti(params)
    jstep = jax.jit(js)
    data = SyntheticLM(cfg, ShapeConfig("t", 32, 4, "train"),
                       PipelineConfig(seed=3))
    for step in range(5):
        batch = data.batch(step)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = ts(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-4), step
    assert int(state["opt"]["step"]) == 5


def test_eval_and_serve_steps_match_jax(monkeypatch):
    """``cross_entropy`` on random logits with IGNORE labels (within
    1e-6 relative), ``make_eval_step``'s metrics (1e-5), and the dry-run
    units ``make_prefill_step`` / ``make_decode_step`` (prefill 6 tokens,
    decode 1) against JAX's, both packages in float32: logits within
    1e-4."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(2, 7, 19)).astype(np.float32)
    labels = rng.integers(0, 19, (2, 7)).astype(np.int32)
    labels[1, 3:] = TS.IGNORE
    got = TS.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = JTS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-6)
    assert int(got[1]) == int(want[1]) == 10

    jcfg, cfg = (jreduced(JARCHS["stablelm-3b"], **TINY),
                 reduced(ARCHS["stablelm-3b"], **TINY))
    jparams = jinit(JT.model_defs(jcfg), jax.random.PRNGKey(4))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    kw = dict(remat="none", attention_impl="naive")
    batch = SyntheticLM(cfg, ShapeConfig("t", 8, 2, "train"),
                        PipelineConfig(seed=4)).batch(0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = jax.tree.map(jnp.asarray, batch)
    m = TS.make_eval_step(cfg, ParallelConfig(**kw))(params, tb)
    jm = JTS.make_eval_step(jcfg, JPCFG(**kw))(jparams, jb)
    for k in ("loss", "aux", "tokens"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                            abs=1e-7), k
    lens = np.full((2,), 6, np.int32)
    cache = T.init_cache(cfg, 2, 8, device="cpu")      # bf16, as JAX's
    jcache = JT.init_cache(jcfg, 2, 8)
    lg, cache = TS.make_prefill_step(cfg, ParallelConfig(**kw))(
        params, {"tokens": tb["tokens"][:, :6]}, cache,
        torch.from_numpy(lens))
    jlg, jcache = JTS.make_prefill_step(jcfg, JPCFG(**kw))(
        jparams, {"tokens": jb["tokens"][:, :6]}, jcache, jnp.asarray(lens))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=1e-4,
                               atol=1e-4)
    lg, _ = TS.make_decode_step(cfg, ParallelConfig(**kw))(
        params, {"tokens": tb["tokens"][:, 6:7]}, cache, 6,
        torch.from_numpy(lens + 1))
    jlg, _ = JTS.make_decode_step(jcfg, JPCFG(**kw))(
        jparams, {"tokens": jb["tokens"][:, 6:7]}, jcache, jnp.asarray(6),
        jnp.asarray(lens + 1))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=1e-4,
                               atol=1e-4)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    """``launch.train.main`` with ``--device cpu --reduced``: a failure
    injected at step 3 with checkpoints every 2 resumes from step 2, and
    the printed JSON summary carries JAX's keys; without ``--device``
    and without a card it refuses to start.  The example shim passes
    the JAX example's arguments."""
    args = ["--reduced", "--width", "32", "--layers", "2", "--steps", "6",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2",
            "--fail-at", "3", "--log-every", "2",
            "--ckpt-dir", str(tmp_path / "ck")]
    out = launch_train.main(["--device", "cpu"] + args)
    text = capsys.readouterr().out
    printed = json.loads(text[text.index("\n{") + 1:])
    assert printed == {k: out[k] for k in printed}
    assert out["restarts"] == 1 and out["resumed_from"] == [2]
    assert out["steps_run"] == 6 + 1 and sorted(out["losses"]) == list(
        range(6))
    assert all(np.isfinite(v) for v in out["losses"].values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            launch_train.main(args)
    assert train_lm.ARGS[:train_lm.ARGS.index("--ckpt-dir")] == [
        "--arch", "stablelm-3b", "--reduced", "--width", "256", "--layers",
        "6", "--steps", "220", "--batch", "8", "--seq", "128", "--lr",
        "1e-3"]
    assert train_lm.ARGS[-4:] == ["--fail-at", "110", "--log-every", "20"]


def test_launcher_refuses_data_parallelism(capsys):
    """``--data-axis 2`` runs data parallel (``test_torch_data_parallel.py``)
    but is refused before any rank starts when it cannot run: without a
    ``--backend`` (a usage error), and over NCCL with more ranks than the
    host has cards (NCCL runs one rank a card)."""
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--device", "cpu", "--data-axis", "2"])
    assert e.value.code == 2
    assert "--backend" in capsys.readouterr().err
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    ranks = max(cards + 1, 2)
    with pytest.raises(ValueError, match="nccl with .* ranks needs"):
        launch_train.main(["--data-axis", str(ranks), "--backend", "nccl",
                           "--batch", str(2 * ranks)])
