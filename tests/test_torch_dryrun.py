"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, and its traces against what the layouts imply.

* The parts that mean the same on any mesh, for every cell of
  ``all_cells()`` at 16x16 and 2x16x16, equal the JAX dryrun's exactly:
  ``parallel_for``, ``enc_dec_split``, ``input_specs``,
  ``batch_pspecs``, ``param_count``, every leaf's ``param_specs`` and
  ``cache_pspecs`` under ``sharding_env``, and ``analytic_memory`` on
  the JAX dryrun's own ``info``.  The JAX numbers come from one
  subprocess: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512
  host devices), which must not reach this worker's other files.
* Traces (meta tensors, a fake process group): the ranks of a world
  ``{"data": 2, "model": 2}`` sum to the one-rank trace's flops (a
  train step in the rule set's 2-D layout, the serving steps on the
  engine's tensor-parallel step); the
  tensor-parallel decode cell's collective bytes are the layout's two
  sums a layer plus the embedding's and the logits'; the full-depth
  trace equals the JAX dryrun's affine rule from two reduced depths;
  the aten byte counter reads and writes each operand once.
* A train cell on a model axis is traced in the rule set's 2-D layout;
  a trace refuses a live default group and leaves none behind; the CLI
  writes the record; importing the module loads no JAX.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed.sharding import sharding_env  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import process_group  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import (param_count, param_specs,  # noqa: E402
                                       tree_leaves)
from repro_torch.roofline import analysis as ra, hw  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")

# the JAX dryrun's pure parts for every cell, at both production meshes
JAX_SCRIPT = r"""
import dataclasses, json
import repro.launch.dryrun as D
from repro.configs import ARCHS, SHAPES
from repro.distributed.sharding import sharding_env
from repro.launch.mesh import make_production_mesh
from repro.models import transformer as T
from repro.models.params import param_count, param_specs

def spec(p):
    return [list(a) if isinstance(a, tuple) else a for a in p]

def walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree

out = {"cells": [], "params": {}, "param_specs": {}}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    tag = "2x16x16" if mp else "16x16"
    with sharding_env(mesh, multi_pod=mp, fsdp=True):
        for arch, cfg in ARCHS.items():
            defs = T.model_defs(cfg)
            out["params"][arch] = param_count(defs)
            out["param_specs"][f"{arch}/{tag}"] = {
                p: spec(s) for p, s in walk(param_specs(defs))}
        for arch, shape_name, cmp in D.all_cells():
            if cmp != mp:
                continue
            cfg, shape = ARCHS[arch], SHAPES[shape_name]
            pcfg = D.parallel_for(cfg, mp)
            batch = D.input_specs(cfg, shape, pcfg)
            info = {"chips": 512 if mp else 256,
                    "params": out["params"][arch],
                    "param_dtype": pcfg.param_dtype,
                    "opt_state_dtype": pcfg.opt_state_dtype,
                    "microbatches": pcfg.microbatches}
            cell = {"arch": arch, "shape": shape_name, "multi_pod": mp,
                    "parallel": dataclasses.asdict(pcfg),
                    "enc_dec": list(D.enc_dec_split(cfg, shape)),
                    "inputs": {k: [list(v.shape), str(v.dtype)]
                               for k, v in batch.items()},
                    "batch_pspecs": {k: spec(v) for k, v in
                                     D.batch_pspecs(cfg, batch).items()},
                    "info": info,
                    "analytic": D.analytic_memory(cfg, shape, info)}
            if shape.kind != "train":
                enc = D.enc_dec_split(cfg, shape)[0] \
                    if cfg.family == "encdec" else 0
                cell["cache_pspecs"] = {
                    p: [spec(s) for s in pair] for p, pair in walk(
                        T.cache_pspecs(cfg, shape.global_batch,
                                       shape.seq_len, enc))}
            out["cells"].append(cell)
print(json.dumps(out))
"""


def _spec(s):
    return [list(a) if isinstance(a, tuple) else a for a in s]


@pytest.fixture(scope="module")
def jax_dryrun():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _cells(jax_dryrun, multi_pod):
    cells = [c for c in jax_dryrun["cells"] if c["multi_pod"] == multi_pod]
    assert [(c["arch"], c["shape"], multi_pod) for c in cells] == \
        [c for c in D.all_cells() if c[2] == multi_pod]
    return cells


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cell_parts_match_jax(jax_dryrun, multi_pod):
    """parallel_for, enc_dec_split, input_specs, batch_pspecs and
    analytic_memory, cell by cell."""
    ms = D.production_mesh_shape(multi_pod)
    for c in _cells(jax_dryrun, multi_pod):
        cfg, shape = ARCHS[c["arch"]], SHAPES[c["shape"]]
        pcfg = D.parallel_for(cfg, multi_pod)
        assert dataclasses.asdict(pcfg) == c["parallel"], c["arch"]
        assert list(D.enc_dec_split(cfg, shape)) == c["enc_dec"]
        batch = D.input_specs(cfg, shape, pcfg)
        assert {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                for k, v in batch.items()} == c["inputs"], c["arch"]
        with sharding_env(ms, multi_pod=multi_pod, fsdp=pcfg.fsdp):
            got = {k: _spec(v) for k, v in D.batch_pspecs(cfg, batch).items()}
        assert got == c["batch_pspecs"], (c["arch"], c["shape"])
        assert D.analytic_memory(cfg, shape, c["info"]) == c["analytic"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_param_and_cache_specs_match_jax(jax_dryrun, multi_pod):
    """param_count, every parameter leaf's spec and every cache leaf's
    spec under the production mesh's sharding_env."""
    ms = D.production_mesh_shape(multi_pod)
    tag = D.mesh_tag(multi_pod)
    with sharding_env(ms, multi_pod=multi_pod, fsdp=True):
        for arch, cfg in ARCHS.items():
            defs = T.model_defs(cfg)
            assert param_count(defs) == jax_dryrun["params"][arch]
            assert {p: _spec(s) for p, s in tree_leaves(param_specs(defs))} \
                == jax_dryrun["param_specs"][f"{arch}/{tag}"], arch
        n = 0
        for c in _cells(jax_dryrun, multi_pod):
            if "cache_pspecs" not in c:
                continue
            cfg, shape = ARCHS[c["arch"]], SHAPES[c["shape"]]
            enc = D.enc_dec_split(cfg, shape)[0] \
                if cfg.family == "encdec" else 0
            got = {p: [_spec(s) for s in pair] for p, pair in tree_leaves(
                T.cache_pspecs(cfg, shape.global_batch, shape.seq_len, enc))}
            assert got == c["cache_pspecs"], (c["arch"], c["shape"])
            n += 1
    assert n == 22


# --------------------------------------------------------------------- #
# Traces
# --------------------------------------------------------------------- #

DENSE = reduced(ARCHS["granite-3-8b"], num_layers=2)
SMALL = {"train": ShapeConfig("train_t", 64, 4, "train"),
         "prefill": ShapeConfig("prefill_t", 64, 4, "prefill"),
         "decode": ShapeConfig("decode_t", 64, 4, "decode")}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_ranks_sum_to_one_rank_flops(kind):
    """The per-rank traced flops of a world {"data": 2, "model": 2} (a
    train step in the rule set's 2-D layout, every dim of the model
    split over ``model``, its backward included) sum to the world-1
    trace's for the same global batch, exactly."""
    shape = SMALL[kind]
    one = D.trace_cell(DENSE, shape, multi_pod=False, device="meta",
                       world=1)
    assert one["rank_mesh"] == {"data": 1, "model": 1}
    ranks = [D.trace_cell(DENSE, shape, multi_pod=False, device="meta",
                          world=4, model=2, rank=r) for r in range(4)]
    want = {"data": 2, "model": 2}
    assert {json.dumps(r["rank_mesh"]) for r in ranks} == {json.dumps(want)}
    assert ranks[0]["layout"] == ("rules" if kind == "train"
                                  else "tensor_parallel")
    assert ranks[0]["batch_local"]["tokens"][0] == 2
    assert one["traced"]["flops"] > 0
    assert sum(r["traced"]["flops"] for r in ranks) == one["traced"]["flops"]


def test_decode_collectives_are_the_layout_sums():
    """minitron-8b decode_32k at 16x16 on the engine's tensor-parallel
    step (``model=8`` forces it; the sweep lays serving cells out by the
    rule set): {"data": 32, "model": 8}, each rank 4 rows; per layer an
    all-reduce of the attention output and one of the MLP output, (4,
    1, d_model) bf16 each, plus the embedding's sum (bf16) and the
    vocab-parallel logits' (float32)."""
    cfg = ARCHS["minitron-8b"]
    rec = D.trace_cell(cfg, SHAPES["decode_32k"], multi_pod=False,
                       device="meta", model=8)
    assert (rec["layout"], rec["rank_mesh"]) == \
        ("tensor_parallel", {"data": 32, "model": 8})
    b, L = 4, cfg.num_layers
    assert rec["batch_local"] == {"tokens": [b, 1]}
    sums = 2 * L + 1
    assert rec["collectives"] == {
        "all-gather": 0, "reduce-scatter": 0, "all-to-all": 0,
        "collective-permute": 0,
        "all-reduce": sums * b * cfg.d_model * 2 + b * cfg.vocab_size * 4}
    assert rec["collective_counts"]["all-reduce"] == sums + 1
    assert rec["roofline"]["collective_bytes_per_chip"] == \
        2 * rec["collectives"]["all-reduce"]


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_full_depth_trace_equals_affine_extrapolation(family):
    """The JAX dryrun's affine rule in the layer count, from two reduced
    depths (``_cost_scaled_cfgs``), equals the full-depth trace: flops,
    bytes and collective bytes by kind (a train step in the rule set's
    2-D layout at {"data": 2, "model": 2}; a hybrid prefill with Mamba,
    attention, MoE and MLP sublayers)."""
    kw = {"world": 4}
    if family == "dense":
        cfg, shape = reduced(ARCHS["granite-3-8b"], num_layers=6), \
            SMALL["train"]
        kw["model"] = 2
    else:
        cfg = reduced(ARCHS["jamba-1.5-large-398b"], num_layers=24)
        shape = SMALL["prefill"]
    full = D.trace_cell(cfg, shape, multi_pod=False, device="meta", **kw)
    ext = D.extrapolate(cfg, shape, **kw)
    assert ext["extrapolated_from"][-1] == (6 if family == "dense" else 3)
    assert ext["flops"] == full["traced"]["flops"]
    assert ext["bytes"] == full["traced"]["bytes"]
    assert ext["collectives"] == full["collectives"]
    if family == "dense":
        assert full["collectives"]["all-gather"] > 0
        assert full["collectives"]["reduce-scatter"] > 0


def test_unsupported_cell_and_group_refusals():
    """A train step on a model axis is traced in the rule set's 2-D
    layout (TP over ``model`` x FSDP over ``data``; ZeRO-3 splits one
    data axis only), with no ``"unsupported"``; a trace under a live
    default group raises; a trace leaves no group."""
    rec = D.trace_cell(DENSE, SMALL["train"], multi_pod=False,
                       device="meta", world=4, model=2)
    assert "unsupported" not in rec
    assert (rec["layout"], rec["rank_mesh"]) == \
        ("rules", {"data": 2, "model": 2})
    assert rec["roofline"]["flops_per_chip"] > 0
    assert rec["collectives"]["reduce-scatter"] > 0
    assert not dist.is_initialized()
    with process_group("gloo"):
        with pytest.raises(RuntimeError, match="already initialised"):
            D.trace_cell(DENSE, SMALL["decode"], multi_pod=False,
                         device="meta", world=1)
    assert not dist.is_initialized()


def test_traffic_counts_each_operand_once():
    """The aten byte counter reads each operand and writes each result
    once: a destination that is only written (``copy_``, ``zero_``,
    ``out=``) is not read, an in-place op's ``self`` is read and
    written, and a result that is an argument is not counted again."""
    a = torch.empty((4, 8), device="meta")          # 128 bytes
    b = torch.empty((4, 8), device="meta")
    half = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
    c = torch.empty((8, 2), device="meta")          # 64 bytes
    cases = [(lambda: a.add_(b), 3 * 128), (lambda: a.copy_(half), 128 + 64),
             (lambda: a.zero_(), 128), (lambda: a + b, 3 * 128),
             (lambda: torch.mm(a, c, out=torch.empty((4, 2),
                                                     device="meta")),
              128 + 64 + 32),
             (lambda: a.view(8, 4), 0), (lambda: a.sum(), 128 + 4)]
    for fn, want in cases:
        nbytes = D._counted(fn)[2]
        assert nbytes == want, (fn, nbytes, want)


def test_cli_writes_the_record_and_imports_no_jax(tmp_path):
    assert D.main(["--arch", "gemma-2b", "--shape", "decode_32k",
                   "--device", "meta", "--out", str(tmp_path)]) == 0
    assert not dist.is_initialized()
    rec = json.loads((tmp_path / "gemma-2b__decode_32k__16x16.json")
                     .read_text())
    # the rule set's layout on the JAX dryrun's mesh: gemma's 8 heads
    # and one KV head stay whole over model, the batch and the FSDP
    # slices split over data, the cache's sequence over model
    assert (rec["layout"], rec["rank_mesh"]) == \
        ("rules", {"data": 16, "model": 16})
    assert rec["batch_local"] == {"tokens": [8, 1]}
    assert rec["memory"]["hbm_bytes"] == hw.HBM_BYTES
    assert rec["memory"]["fits_hbm_analytic"] is True
    r = rec["roofline"]
    assert r["t_memory_s"] == rec["traced"]["bytes"] / hw.HBM_BW
    assert r["t_compute_s"] == rec["traced"]["flops"] / hw.PEAK_FLOPS_BF16
    assert r["collective_bytes_per_chip"] == \
        ra.collective_bytes_total(rec["collectives"]) > 0
    assert r["bottleneck"] == max(
        ("compute", "memory", "collective"),
        key=lambda k: r[f"t_{k}_s"])
    # importing the module loads neither JAX nor its package
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    code = ("import os, sys\n"
            "import repro_torch.launch.dryrun\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
            "       or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n"
            "assert 'XLA_FLAGS' not in os.environ\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
