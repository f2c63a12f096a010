"""Model families as files (``bench/families/<model_type>.py``): what
the two cells read is what it was before the families moved into their
own files, a new family runs a cell from new files alone, and a missing
one is named.

``recorded_values.json`` holds, for each configuration, what the
harness read before the move (computed by the same code as below on
this repository's CPU build of PyTorch, 2.13): sha256 digests (first 16
hex digits) of every weight leaf at the small test size (seed 2**31 +
17) and their draw order, of the reference's float32 logits of two
teacher-forced sequences and of the float8 control's, every count at
the configurations' full sizes, and a digest of the program's
``ModelConfig``.  The digests of logits are of float32 bytes: another
CPU's kernels may round differently, the weights' and counts' may
not."""

import ast
import dataclasses
import hashlib
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from bench import counts, model, reference, system, weights
from bench.tests.small import BENCH, ROOT, bench_spec, config, mix

RECORDED = json.loads((Path(__file__).parent /
                       "recorded_values.json").read_text())
NAMES = sorted(RECORDED)


def digest(t: torch.Tensor) -> str:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


def _counts(m):
    return {"params": m.param_count, "matmul": m.matmul_param_count,
            "kv": m.kv_bytes_per_token(), "state": m.state_bytes_per_row(),
            "token": counts.token_flops(m, 700),
            "decode": list(counts.decode_rows(m, [100, 900, 3000])),
            "chunk": list(counts.chunk(m, 256, 1000)),
            "call": list(counts.call(m, 3, [100, 900], [(256, 0), (100, 512)],
                                     2)),
            "least": list(counts.least_seconds(
                counts.call(m, 1, [1024] * 64, [], 0))),
            "paged": list(counts.paged_attention(m, [100, 900])),
            "flash": list(counts.flash_prefix(m, 256, 1000)),
            "scatter": list(counts.state_scatter(m, 5))}


@pytest.mark.parametrize("name", NAMES)
def test_weights_draw_as_before(name):
    m = model.from_dict(config(name))
    w = weights.make(m, 2 ** 31 + 17, "cpu")
    assert list(w) == RECORDED[name]["draw_order"]
    assert {k: digest(v) for k, v in w.items()} == RECORDED[name]["weights"]


@pytest.mark.parametrize("name", NAMES)
def test_reference_logits_as_before(name):
    m = model.from_dict(config(name))
    w = weights.make(m, 2 ** 31 + 17, "cpu")
    toks = torch.randint(0, m.vocab, (40,), generator=torch.Generator()
                         .manual_seed(3)).tolist()
    ref = reference.logits(m, w, [(toks, 5), (toks[:17], 3)])
    assert [digest(r) for r in ref] == RECORDED[name]["logits"]
    ctl = reference.logits(m, w, [(toks, 5)], precision="fp8")
    assert digest(ctl[0]) == RECORDED[name]["fp8_logits"]


@pytest.mark.parametrize("name", NAMES)
def test_counts_and_program_config_as_before(name):
    m = model.load(BENCH / "configs" / f"{name}.json")
    assert _counts(m) == RECORDED[name]["counts"]
    cfg = json.dumps(dataclasses.asdict(system.program_config(m)),
                     sort_keys=True, default=str)
    assert hashlib.sha256(cfg.encode()).hexdigest()[:16] == \
        RECORDED[name]["program_config"]


def test_a_missing_family_names_the_files_found():
    c = dict(config("granite-3-8b"), model_type="no-such-family")
    with pytest.raises(ValueError) as e:
        model.from_dict(c)
    assert "families/no-such-family.py" in str(e.value)
    assert "granite.py" in str(e.value) and "mamba2.py" in str(e.value)


def test_family_modules_import_nothing_of_the_program():
    """A family imports the program only inside its program mapping
    (``program_config``, ``program_params``), and of the benchmark only
    the shared modules, so the reference's layers stay free of it."""
    shared = {"bench.model", "bench.reference", "bench.weights"}
    for f in (BENCH / "families").glob("*.py"):
        tree = ast.parse(f.read_text())
        inside = {id(n): fn.name for fn in ast.walk(tree)
                  if isinstance(fn, ast.FunctionDef)
                  for n in ast.walk(fn)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("repro", "jax", "jaxlib", "flax"), (f, mod)
                if top == "repro_torch":
                    assert inside.get(id(node), "").startswith("program_"), \
                        (f, mod)
                if top == "bench":
                    assert mod in shared or mod.startswith(
                        "bench.families."), (f, mod)


TOY = '''\
"""A toy dense family: granite's layers with an untied output table."""

import dataclasses

from bench.families import granite
from bench.families.granite import LAYER_WEIGHTS, fill, layer  # noqa: F401


def read(name, c):
    m = granite.read(name, c)
    return dataclasses.replace(m, param_count=m.param_count
                               + m.vocab * m.d_model)


def leaves(m, ranks):
    return granite.leaves(m, ranks) + [("head", (m.vocab, m.d_model), 0.02)]


def program_config(m):
    return dataclasses.replace(granite.program_config(m),
                               tie_embeddings=False)


def program_params(m, w, ranks):
    p = granite.program_params(m, w, ranks)
    p["embed"]["out"] = w["head"]
    return p
'''


def test_a_new_family_runs_a_cell_from_new_files_alone(tmp_path):
    """A copy of ``bench/`` gains a family file, a configuration, a
    traffic mix and a limits file, and ``BENCHMARK.json`` a configuration
    and a cell; no file already there is edited, and the cell runs end
    to end on the CPU and reads ``correct``."""
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    b = tmp_path / "bench"
    (b / "families" / "toy.py").write_text(TOY)
    cfg = dict(json.loads((BENCH / "configs" / "granite-3-8b.json")
                          .read_text()), name="toy-1", model_type="toy",
               hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               vocab_size=256, tie_word_embeddings=False)
    cfg["engine"] = dict(cfg["engine"], num_pages=128, max_prefill_chunk=32,
                         decode_block_rounds=4, cuda_graphs=False)
    (b / "configs" / "toy-1.json").write_text(json.dumps(cfg))
    (b / "traffic" / "toy-small.json").write_text(
        json.dumps(mix("batch-sampled")))
    (b / "limits" / "toy-1.toy-small.json").write_text(json.dumps(
        {"served_logit_gap": 1.0, "sampled_nll_z": 5.0,
         "sampled_pit_ks": 6.0}))
    spec = bench_spec()
    spec["configs"].append({"name": "toy-1", "source": "a test",
                            "file": "bench/configs/toy-1.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "toy-1.toy-small", "config": "toy-1",
                              "traffic": "toy-small", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "output_tok_s":
            m["workloads"].append("toy-1.toy-small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = textwrap.dedent("""
        import json, sys, time
        from bench import harness
        spec = json.load(open("BENCHMARK.json"))
        out = harness.run(spec, "toy-1.toy-small", 2 ** 31 + 23, 2.0, False,
                          t_start=time.perf_counter(), device="cpu")
        print(json.dumps(out))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={"PYTHONPATH": f"{tmp_path}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["judged"]["served_tokens"] > 0
    assert set(out["metrics"]) == {"output_tok_s", "setup_s"}
    after = {p: p.read_bytes() for p in before if p.is_file()}
    assert after == before
