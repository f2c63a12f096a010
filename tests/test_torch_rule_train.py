"""The rule set's 2-D training layout (``make_train_step(rules=)``)
against the JAX package's ``make_train_step`` on one device, on the CPU.

The JAX dryrun lowers every train cell with ``in_shardings`` from
``param_specs``: tensor parallelism over ``model`` with
``resolve_spec``'s fallback, FSDP over the batch axes, the optimizer
moments as their parameters and the batch over the batch axes.  GSPMD
keeps the step's function; the port computes it by hand, one process a
rank, on exactly the blocks JAX's specs give that device.

* Parity across ranks: one spawn of four gloo ranks
  (``torch_ranks.rule_train``) takes one ``make_train_step`` step
  (AdamW, or Adafactor in one case) per family at ``{"data": 2,
  "model": 2}`` and one case at ``{"pod": 2, "data": 1, "model": 2}``,
  from the same numpy weights cut by ``rule_params``, on
  ``SyntheticLM``'s global batch of 4 rows cut over the batch axes,
  two microbatches, remat "full" (the recompute repeats the model
  axis's collectives) and tiled attention.  The loss, aux, token count
  and grad norm, and every leaf of the updated state (parameters and
  moments) put back together from the four ranks' blocks equal the JAX
  step on one device.  Every copy of a block the layout replicates is
  the same bit for bit on the ranks that hold it (a gradient summed
  over ``model`` where it must be, and only there).
* Both packages compute in float32 (``layers.COMPUTE_DTYPE`` patched),
  so the tolerances are ``test_torch_zero.py``'s: float32 sums in other
  orders.  The moments are held at ``SLICE_RTOL`` of each leaf's
  largest value, except AdamW's ``v``, a square of the gradient, whose
  relative rounding is twice the gradient's: twice the tolerance.  A
  Mamba sublayer's moments take ``SSM_RTOL``, 4 x ``SLICE_RTOL``: the
  SSD's float32 chunk scan (exponentials of cumulative sums) already
  parts the port's one-process step from JAX's by 1.1e-5 of a leaf's
  scale in the hybrid case (its ``conv_b``'s ``v``), and the 2-D
  step's other sum orders add 8.6e-6 (measured on this box).
* The weights: the port's init draws (the JAX package's schemes, from
  a seeded generator) as numpy, with every attention projection
  rescaled from the init rule's fan-in to its contraction's
  (``_fan_in``, as ``chip_smoke``'s training phases do; ROADMAP,
  "The init rule makes deep gemma untrainable").  Under the rule the
  scores are near one-hot and the step is ill-conditioned: the JAX
  package's own naive and tiled attention then part by 2.7e-4 in the
  grad norm of the fallback case, so no float32 tolerance could tell a
  missing sum from a reordering.  Rescaled, the port's one-process
  step, its 2-D step and JAX's agree within 4e-6 of each leaf's scale.
* The MoE aux loss: the JAX dryrun's step runs the expert-parallel
  ``shard_map`` body, whose aux is the mean of each batch shard's
  (``moe.py``'s ``jnp.mean(aux)``), and the port's 2-D step computes
  that; on one device JAX runs the dense form, whose aux is the whole
  microbatch's.  The reference therefore takes the dense form's output
  with the aux averaged over the microbatch's two batch blocks
  (``_dense_moe`` patched for the run).  Each block is one row (4 rows,
  two microbatches, two batch shards), so the mean over blocks is the
  mean over rows whichever microbatch holds them.  The capacity factor
  makes room for every token, so the expert-parallel body drops none
  and its output is the dense form's.
* A checkpoint of the 2-D state keeps the one-device layout: one
  process loads it equal to the blocks put back together, and the
  ranks load their blocks back bit for bit.
* Arguments without a trace: every train cell of the dry run at both
  production meshes, the port's rank-0 state and batch blocks
  (``dryrun.rank_arguments``, meta tensors) have the shapes JAX's
  ``param_specs`` and ``batch_pspecs`` give a device, in the
  ``PARALLEL_OVERRIDES`` dtypes.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_ranks as R  # noqa: E402
from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.configs import (OptimizerConfig as JOCFG,  # noqa: E402
                           ParallelConfig as JPCFG)
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training.train_step import make_train_step as jmake  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, OptimizerConfig,  # noqa: E402
                                 ParallelConfig, ShapeConfig, reduced)
from repro_torch.data.pipeline import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import (from_jax_params,  # noqa: E402
                                       init_params, torch_to_numpy,
                                       tree_leaves, tree_map)
from repro_torch.training.train_step import make_train_step  # noqa: E402
from test_torch_rule_layout import StubMesh, _block, _jax_leaves  # noqa: E402
from test_torch_zero import SLICE_RTOL  # noqa: E402
from test_torch_data_parallel import (GNORM_RTOL, LOSS_RTOL,  # noqa: E402
                                      UPDATE_ATOL)

MESH = {"data": 2, "model": 2}
POD_MESH = {"pod": 2, "data": 1, "model": 2}
B, SEQ, MICRO = 4, 12, 2
SSM_RTOL = 4 * SLICE_RTOL
ADAMW = dict(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
ADAFACTOR = dict(name="adafactor", lr=1e-3, warmup_steps=1, total_steps=10)
# name -> (arch, reduced() overrides, mesh, optimizer)
CASES = {
    # 4 heads over 2, one KV head and an odd vocab and hidden: whole
    "dense_fallback": ("granite-3-8b", dict(num_layers=2, num_kv_heads=1,
                                            vocab_size=511, d_ff=255), MESH,
                       ADAMW),
    "dense": ("granite-3-8b", dict(num_layers=2), MESH, ADAMW),
    "moe": ("llama4-scout-17b-a16e", dict(num_layers=2), MESH, ADAMW),
    "mla_moe": ("deepseek-v2-236b", dict(num_layers=2), MESH, ADAMW),
    "ssm": ("mamba2-1.3b", dict(num_layers=2), MESH, ADAMW),
    "hybrid": ("jamba-1.5-large-398b", dict(num_layers=4, attn_every=4),
               MESH, ADAMW),
    "encdec": ("seamless-m4t-medium", {}, MESH, ADAMW),
    # 3 heads and one KV head: both whole, as llava's 56 and 8 at 16
    "vlm": ("llava-next-34b", dict(num_layers=2, num_heads=3,
                                   num_kv_heads=1), MESH, ADAMW),
    "multi_pod": ("granite-3-8b", dict(num_layers=2), POD_MESH, ADAMW),
    # its heads and KV heads split: factored means over model
    "adafactor": ("granite-3-8b", dict(num_layers=2), MESH, ADAFACTOR),
}
JAX_P = JPCFG(remat="none", attention_impl="naive", moe_impl="dense",
              microbatches=MICRO)


def _pcfg(cfg):
    # the dry run's settings, small tiles, and room for every token
    return ParallelConfig(remat="full", attention_impl="chunked",
                          attention_chunk=4, moe_impl="shard_map",
                          microbatches=MICRO,
                          moe_capacity_factor=float(
                              cfg.moe.num_experts if cfg.moe else 0))


def _case(name, seed):
    arch, kw, mesh, opt = CASES[name]
    jcfg, cfg = jreduced(JARCHS[arch], **kw), reduced(ARCHS[arch], **kw)
    if cfg.moe is not None and cfg.family == "moe":
        # a leading dense layer: the two-group layout
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, first_dense_layers=1))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, first_dense_layers=1))
    params = _fan_in(tree_map(torch_to_numpy, init_params(
        T.model_defs(cfg), torch.Generator().manual_seed(seed), "cpu")))
    jparams = jax.tree.map(jnp.asarray, params)
    seq = SEQ + cfg.num_patch_tokens
    batch = SyntheticLM(cfg, ShapeConfig("t", seq, B, "train"),
                        PipelineConfig(seed=seed)).batch(0)
    return jcfg, jparams, {
        "cfg": cfg, "pcfg": _pcfg(cfg), "mesh": mesh, "opt": opt,
        "params": params, "batches": [batch]}


def _fan_in(params):
    """Every attention projection (stacked: a leading layers dim) scaled
    from the init rule's fan-in (its second-to-last dim) to its
    contraction's (``wo``: heads x head dim; the others their first
    dim), as ``chip_smoke._attention_fan_in`` does (see the module
    docstring)."""
    for name, group in params.items():
        if not name.startswith("group"):
            continue
        for key, sub in group.items():
            if "attn" not in sub or key.endswith("_mlp"):
                continue
            for w, t in sub["attn"].items():
                if t.ndim == 4:
                    fan = t.shape[1] * (t.shape[2] if w == "wo" else 1)
                    sub["attn"][w] = (t * np.float32(
                        np.sqrt(t.shape[-2] / fan))).astype(t.dtype)
    return params


def _blocked_aux_moe(orig, blocks):
    """The JAX dense MoE with the aux of the shard_map body: the mean of
    each batch block's (see the module docstring)."""
    def moe(cfg, p, x):
        out, _ = orig(cfg, p, x)
        auxes = [orig(cfg, p, xb)[1] for xb in jnp.split(x, blocks, 0)]
        return out, sum(auxes) / blocks
    return moe


def _jax_step(jcfg, jparams, c):
    """The JAX step on one device, on the global batch."""
    nb = int(np.prod([n for a, n in c["mesh"].items() if a != "model"]))
    init, step = jmake(jcfg, JAX_P, JOCFG(**c["opt"]))
    mp = pytest.MonkeyPatch()
    mp.setattr(JM, "_dense_moe", _blocked_aux_moe(JM._dense_moe, nb))
    try:
        state, m = jax.jit(step)(init(jparams), jax.tree.map(
            jnp.asarray, c["batches"][0]))
        return {"metrics": {k: float(v) for k, v in m.items()},
                "state": {p: np.asarray(v) for p, v in
                          _jax_leaves(state)}}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Every case on four gloo ranks (one spawn, its own processes, run
    from a thread) and, meanwhile, in JAX; the dense case's ranks also
    save and reload a checkpoint."""
    made = {name: _case(name, seed=i) for i, name in enumerate(CASES)}
    cases = {name: c for name, (_, _, c) in made.items()}
    cases["dense"]["ckpt_dir"] = str(tmp_path_factory.mktemp("ckpt"))
    jl = JL.COMPUTE_DTYPE
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, R.rule_train, 4, backend="gloo",
                            args=(cases,), timeout=240.0)
        JL.COMPUTE_DTYPE = jnp.float32
        try:
            want = {name: _jax_step(jcfg, jparams, cases[name])
                    for name, (jcfg, jparams, _) in made.items()}
        finally:
            JL.COMPUTE_DTYPE = jl
        return cases, want, ranks.result()


def _whole(outs, path, mesh):
    """A state leaf put back together from every rank's block under its
    spec; every copy of a block must be the same bit for bit."""
    spec = outs[0]["specs"][path]
    first = outs[0]["state"][path]
    spec = tuple(spec) + (None,) * (first.ndim - len(spec))
    axes = [(e,) if isinstance(e, str) else tuple(e or ()) for e in spec]
    shape = [n * int(np.prod([mesh[a] for a in ax], dtype=int))
             for n, ax in zip(first.shape, axes)]
    out = np.zeros(shape, first.dtype)
    seen = {}
    for o in outs:
        blk = o["state"][path]
        idx = []
        for d, ax in enumerate(axes):
            i = 0
            for a in ax:
                i = i * mesh[a] + o["coords"][a]
            idx.append(slice(i * blk.shape[d], (i + 1) * blk.shape[d]))
        key = tuple((s.start, s.stop) for s in idx)
        if key in seen:
            np.testing.assert_array_equal(blk, seen[key],
                                          err_msg=f"{path}: copies differ")
        seen[key] = blk
        out[tuple(idx)] = blk
    return out


def _check(parity, name):
    cases, want, ranks = parity
    c, w = cases[name], want[name]
    outs = [r[name] for r in ranks]
    for o in outs:
        m = o["metrics"][0]
        assert m["loss"] == pytest.approx(w["metrics"]["loss"],
                                          rel=LOSS_RTOL), name
        assert m["aux"] == pytest.approx(w["metrics"]["aux"],
                                         rel=LOSS_RTOL), name
        assert m["tokens"] == w["metrics"]["tokens"], name
        assert m["grad_norm"] == pytest.approx(w["metrics"]["grad_norm"],
                                               rel=GNORM_RTOL), name
    assert sorted(outs[0]["state"]) == sorted(w["state"]), name
    split = 0
    for path, want_leaf in w["state"].items():
        got = _whole(outs, path, c["mesh"])
        assert got.shape == want_leaf.shape, (name, path)
        split += got.size > outs[0]["state"][path].size
        if path.startswith("params/"):
            np.testing.assert_allclose(got, want_leaf, rtol=0,
                                       atol=UPDATE_ATOL,
                                       err_msg=f"{name} {path}")
        else:
            rtol = SSM_RTOL if "_mamba/" in path else SLICE_RTOL
            if path.startswith("opt/v/"):
                rtol *= 2
            scale = float(np.abs(want_leaf).max()) if want_leaf.size else 0
            np.testing.assert_allclose(got, want_leaf, rtol=0,
                                       atol=rtol * scale + 1e-30,
                                       err_msg=f"{name} {path}")
    assert split, name


@pytest.mark.parametrize("name", [n for n in CASES if n not in (
    "multi_pod", "adafactor")])
def test_family_step_matches_jax(parity, name):
    """One AdamW step of one family at {"data": 2, "model": 2}: the
    metrics and the whole updated state against JAX's."""
    _check(parity, name)


def test_multi_pod_batch_and_fsdp_over_both_batch_axes(parity):
    """At {"pod": 2, "data": 1, "model": 2} the batch, the FSDP blocks
    and the gradients' sums run over ("pod", "data"): each rank holds 2
    of the 4 rows, and the step equals JAX's."""
    c = parity[0]["multi_pod"]
    assert c["mesh"] == POD_MESH
    specs = parity[2][0]["multi_pod"]["specs"]
    assert any(("pod", "data") in s for s in specs.values())
    _check(parity, "multi_pod")


def test_adafactor_means_over_the_axes_that_split_a_dim(parity):
    """Adafactor at {"data": 2, "model": 2}: its factored means and its
    update's RMS sum over every axis that splits the dim they reduce
    (the tied table's vocab over model and its width over data; the
    query heads over model), and the factors put back together equal
    JAX's."""
    specs = parity[2][0]["adafactor"]["specs"]
    assert specs["opt/fac/embed/tok/vr"] == ("model",)
    assert specs["opt/fac/embed/tok/vc"] == ("data",)
    assert specs["opt/fac/group0/0_attn/attn/wq/vc"] == (None, "data",
                                                         None)
    _check(parity, "adafactor")


def test_checkpoint_of_the_2d_state_is_one_device(parity):
    """A checkpoint of the dense case's 2-D state (every rank joins the
    gathers, rank 0 writes) holds each leaf whole: one process loads it
    equal to the ranks' blocks put back together, and every rank loads
    its blocks back bit for bit."""
    cases, _, ranks = parity
    c = cases["dense"]
    outs = [r["dense"] for r in ranks]
    assert all(o["reloaded"] for o in outs)
    init, _ = make_train_step(c["cfg"], c["pcfg"],
                              OptimizerConfig(**c["opt"]))
    like = init(from_jax_params(c["params"], "cpu"))
    loaded, step = Checkpointer(c["ckpt_dir"]).load(like)
    assert step == 1
    for path, t in tree_leaves(loaded):
        np.testing.assert_array_equal(t.numpy(),
                                      _whole(outs, path, c["mesh"]),
                                      err_msg=path)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_arguments_are_jax_blocks(multi_pod):
    """Every train cell of the dry run at the production mesh: the
    port's rank-0 state (parameters and AdamW moments) and batch blocks,
    built on meta tensors without a step, have leaf by leaf the shape of
    a device's block under the JAX package's own ``param_specs`` and
    batch specs, in the ``PARALLEL_OVERRIDES`` dtypes; a multi-pod rank
    holds 8 of the 256 sequences."""
    mesh = D.production_mesh_shape(multi_pod).shape
    n = 0
    for arch, shape_name, mp in D.all_cells():
        shape = SHAPES[shape_name]
        if mp != multi_pod or shape.kind != "train":
            continue
        cfg, jcfg = ARCHS[arch], JARCHS[arch]
        a = D.rank_arguments(cfg, shape, multi_pod=mp)
        assert (a["layout"].name, a["layout"].mesh) == ("rules", mesh)
        pcfg = D.parallel_for(cfg, mp)
        pdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
        with JS.sharding_env(StubMesh(mesh), multi_pod=mp, fsdp=True):
            jdefs = JT.model_defs(jcfg)
            pspecs = dict(_jax_leaves(JP.param_specs(jdefs)))
            inputs = D.input_specs(cfg, shape)
            bspecs = {k: JS.resolve_spec(v.shape, ("batch",) + (None,) * (
                v.dim() - 1)) for k, v in inputs.items()}
        state = dict(tree_leaves(a["state"]))
        assert state.pop("opt/step").shape == ()
        assert sorted(state) == sorted(
            f"{k}/{p}" for k in ("params", "opt/m", "opt/v")
            for p in pspecs), arch
        for path, d in _jax_leaves(jdefs):
            blk = _block(d.shape, pspecs[path], mesh)
            assert tuple(state[f"params/{path}"].shape) == blk, (arch, path)
            assert state[f"params/{path}"].dtype == pdt[pcfg.param_dtype]
            for k in ("m", "v"):
                t = state[f"opt/{k}/{path}"]
                assert tuple(t.shape) == blk, (arch, path)
                assert t.dtype == pdt[pcfg.opt_state_dtype], (arch, path)
        for k, v in inputs.items():
            assert tuple(a["batch"][k].shape) == _block(v.shape, bspecs[k],
                                                        mesh), (arch, k)
        assert a["batch"]["tokens"].shape[0] == (8 if mp else 16)
        n += 1
    assert n == 10
