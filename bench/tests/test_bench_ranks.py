"""The rank mode on the CPU: a cell whose ``chips`` is above 1 runs one
process a rank (``gloo`` here, ``nccl`` on the cards), each serving a
tensor-parallel engine over a ``model`` axis, and rank 0 prints the
line."""

import copy
import json
import shutil
import subprocess
import sys
import textwrap
import time

import pytest

from bench import harness
from bench.tests.small import BENCH, ROOT, bench_spec, config, mix

CELL = "granite-3-8b.batch-sampled"


def two_chip_spec(cell):
    spec = copy.deepcopy(bench_spec(pending=True))
    for w in spec["workloads"]:
        if w["name"] == cell:
            w["chips"] = 2
    return spec


def test_two_ranks_serve_the_same_streams_and_rank_0_judges():
    """A tiny granite whose heads (4), KV heads (2), d_ff (256) and
    vocabulary (512) divide by 2, graphs off (gloo's collectives run on
    the host): both ranks serve the same token streams, and rank 0's
    line is ``correct``, with its window opened and closed by rank 0's
    clock."""
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    seconds = 3.0
    out, bad = harness.run_on_ranks(
        two_chip_spec(CELL), CELL, 2 ** 31 + 55, seconds, False,
        t_start=time.perf_counter(), device="cpu", backend="gloo",
        model=config("granite-3-8b"), mix=mix("batch-sampled"),
        limits=dict(limits, served_logit_gap=1.0),
        engine_kw={"cuda_graphs": False})
    assert bad == []
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["ranks_streams_differ"] == {"value": 0, "limit": 0}
    assert out["device"]["count"] == 2
    assert out["judged"]["served_tokens"] > 0
    assert set(out["metrics"]) == {"output_tok_s", "setup_s"}
    assert out["metrics"]["setup_s"]["value"] == pytest.approx(
        out["timing"]["window_open"])
    # the window ran its seconds on rank 0's clock and no longer
    assert seconds <= out["timing"]["drained"] - out["timing"][
        "window_open"] < seconds + 5.0
    assert list(out)[-1] == "checks"


def test_an_open_mix_on_two_chips_is_refused():
    cell = "granite-3-8b.chat-unshared"
    with pytest.raises(ValueError, match="closed mixes only"):
        harness.run_on_ranks(two_chip_spec(cell), cell, 1, 1.0, False,
                             t_start=time.perf_counter(), device="cpu",
                             backend="gloo", model=config("granite-3-8b"),
                             mix=mix("chat-unshared"))


def test_the_streams_digest_sees_one_token_changed():
    class Req:
        def __init__(self, toks):
            self.out_tokens = toks

    def lives(toks):
        return [harness.Live(rid=i, spec=None, req=Req(t), due_ms=0.0)
                for i, t in enumerate(toks)]

    a = harness.streams_digest(lives([[1, 2, 3], [4, 5]]))
    assert a == harness.streams_digest(lives([[1, 2, 3], [4, 5]]))
    assert a != harness.streams_digest(lives([[1, 2, 3], [4, 6]]))
    assert a != harness.streams_digest(lives([[1, 2], [3, 4, 5]]))


SHARED = '''\
"""A toy dense family that draws only each rank's share of granite's
weights and computes its reference across the ranks."""

from bench.families import granite
from bench.families.granite import (LAYER_WEIGHTS, layer,  # noqa: F401
                                    program_config, program_params, read)

SHARES = True


def leaves(m, ranks):
    return granite.share_leaves(m, ranks.world)


def fill(m, w, gen, ranks):
    # the harness hands this rank's block of the token table
    assert w["embed"].shape[0] == m.vocab // ranks.world, w["embed"].shape
    granite.fill(m, w, gen, ranks)
'''


def shared_copy(tmp_path):
    """A copy of ``bench/`` with the toy family and a configuration of
    it, and a ``BENCHMARK.json`` whose granite cell serves that
    configuration on 2 chips; no file already there is edited."""
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    (tmp_path / "bench" / "families" / "granite_tp.py").write_text(SHARED)
    cfg = dict(config("granite-3-8b"), name="granite-tp",
               model_type="granite_tp")
    (tmp_path / "bench" / "configs" / "granite-tp.json").write_text(
        json.dumps(cfg))
    spec = two_chip_spec(CELL)
    for w in spec["workloads"]:
        if w["name"] == CELL:
            w["config"] = "granite-tp"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return before


def run_in(tmp_path, code: str):
    """``code`` run as a script (spawned ranks import its functions) in
    ``tmp_path``; the JSON of its last line."""
    (tmp_path / "probe.py").write_text(textwrap.dedent(code))
    res = subprocess.run([sys.executable, "probe.py"], cwd=tmp_path,
                         env={"PYTHONPATH": f"{tmp_path}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_a_family_that_draws_each_ranks_share_runs_a_cell(tmp_path):
    """Each of two ranks draws only its share of a tiny granite (the
    family's ``SHARES``), the engine keeps the shares as they are, and
    the reference runs across both ranks: rank 0's line is ``correct``,
    from the toy family's file and no edit of the harness."""
    before = shared_copy(tmp_path)
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    out = run_in(tmp_path, f"""
        import json, time
        from bench import harness
        from bench.tests.small import mix

        if __name__ == "__main__":
            spec = json.load(open("BENCHMARK.json"))
            out, bad = harness.run_on_ranks(
                spec, {CELL!r}, 2 ** 31 + 57, 3.0, False,
                t_start=time.perf_counter(), device="cpu", backend="gloo",
                model=json.load(open("bench/configs/granite-tp.json")),
                mix=mix("batch-sampled"),
                limits=dict({limits!r}, served_logit_gap=1.0),
                engine_kw={{"cuda_graphs": False}})
            assert bad == [], bad
            print(json.dumps(out))
    """)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["ranks_streams_differ"] == {"value": 0, "limit": 0}
    assert out["judged"]["served_tokens"] > 0
    after = {p: p.read_bytes() for p in before if p.is_file()}
    assert after == before


def test_the_reference_across_shares_equals_the_whole_models(tmp_path):
    """The reference over two ranks' shares (their token table's rows
    summed, their partial outputs summed, their logits gathered) gives
    the logits of the whole model the shares make up, run on one rank,
    and the float8 control's logits depart from them.  The program's
    layout check takes the shares and refuses a leaf cut wrong."""
    shared_copy(tmp_path)
    out = run_in(tmp_path, """
        import json, torch
        from bench import model, reference, system, weights
        from bench.model import Ranks
        from bench.tests.small import config

        CFG = "bench/configs/granite-tp.json"
        CUT = {"embed": 0, "wq": -1, "wk": -1, "wv": -1, "wo": 1,
               "w_gate": -1, "w_up": -1, "w_down": 1}

        def on_rank(rank, world):
            m = model.from_dict(json.load(open(CFG)))
            ranks = Ranks(rank, world, None)
            w = weights.make(m, 2 ** 31 + 61, "cpu", ranks)
            toks = torch.randint(0, m.vocab, (40,), generator=torch.Generator()
                                 .manual_seed(3)).tolist()
            seqs = [(toks, 5), (toks[:17], 3)]
            ref = reference.logits(m, w, seqs, ranks=ranks)
            ctl = reference.logits(m, w, seqs, precision="fp8", ranks=ranks)
            # the program's layout takes the shares, and refuses a leaf
            # that is neither whole nor this rank's block
            cfg, mesh = system.program_config(m), system.mesh(world)
            system.program_params(m, w, cfg, ranks, mesh)
            try:
                system.program_params(m, dict(w, wq=w["wq"][..., :-32]), cfg,
                                      ranks, mesh)
                refused = False
            except ValueError:
                refused = True
            shares = [None] * world
            torch.distributed.all_gather_object(shares, w)
            if rank:
                return None
            whole = {k: (torch.cat([s[k] for s in shares], CUT[k])
                         if k in CUT else v) for k, v in w.items()}
            dense = dict(config("granite-3-8b"), name="granite-tp")
            solo = reference.logits(model.from_dict(dense), whole, seqs)
            return {"max_logit": max(float(r.abs().max()) for r in solo),
                    "gap": max(float((a - b).abs().max())
                               for a, b in zip(ref, solo)),
                    "ctl_gap": max(float((a - b).abs().max())
                                   for a, b in zip(ctl, solo)),
                    "shape": list(ref[0].shape), "refused": refused}

        if __name__ == "__main__":
            outs = system.run_ranks(on_rank, 2, backend="gloo", args=(),
                                    timeout=300, threads=1)
            print(json.dumps(outs[0]))
    """)
    assert out["shape"] == [35, 512]
    assert out["refused"] is True
    assert out["gap"] < 1e-4 * out["max_logit"], out
    # the control departs from the whole model's logits by its rounding,
    # far beyond the float32 sums' order
    assert out["ctl_gap"] > 100 * out["gap"], out
