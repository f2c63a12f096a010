"""The comparison that decides ``correct`` fails what it should, at a
small size on the CPU: the float8 control in the program's place, and
the timed path broken underneath (state left unchanged, half of the
batch left out, a token altered where it is chosen, and the sampled
token choice broken: argmax in place of the draw, a uniform draw over
the vocabulary, a row drawn from another row's logits, a stuck D-RaNGe
uniform).  At this size, judging every request of a run (about 400
greedy and 400 sampled tokens), sound runs read greedy gaps of 0.01 at
most and the control 0.05 to 0.22 (the three seeds below, on both
families); the greedy faults read 1.0 and more.  The small cells'
greedy tokens are judged at ``SMALL_LIMIT``, between the two; the draw
statistics are free of scale and keep the cells' own limits."""

import json

import pytest
import torch

from bench.tests.small import BENCH, run_cell

SMALL_LIMIT = 0.02
CLOSED = ["granite-3-8b.batch-sampled", "mamba2-1.3b.batch-sampled"]
DRAWN = ("sampled_nll_z", "sampled_pit_ks")


def gap(out):
    return out["checks"]["served_logit_gap"]["value"]


def limits(cell):
    return json.loads((BENCH / "limits" / f"{cell}.json").read_text())


@pytest.fixture
def judge_all(monkeypatch):
    from bench import harness

    # the small cells' outputs are a few tokens: judge every one
    monkeypatch.setattr(harness, "SAMPLE_MAX", 1000)


@pytest.mark.parametrize("cell", CLOSED)
@pytest.mark.parametrize("seed", [7, 11, 2 ** 31 + 3])
def test_the_control_fails_and_the_program_passes(judge_all, cell, seed):
    out = run_cell(cell, seed=seed, limit=SMALL_LIMIT, control=True)
    assert not out["correct"] and gap(out) > SMALL_LIMIT
    prog = out["judged"]["program"]
    assert prog["served_logit_gap"] <= SMALL_LIMIT
    for k in DRAWN:
        assert prog[k] <= limits(cell)[k], (k, prog[k])


def _state_unchanged(monkeypatch, cell):
    from repro_torch.serving import engine

    if cell.startswith("mamba2"):
        monkeypatch.setattr(engine._StateRound, "scatter", lambda self: None)
    else:
        monkeypatch.setattr(engine, "_scatter_kv", lambda *a, **k: None)


def _wrap_choose(monkeypatch, change):
    from repro_torch.serving.engine import PagedEngine

    choose = PagedEngine._choose

    def broken(self, logits, temps, seed, rowmap=None):
        return change(self, choose, logits, temps, seed, rowmap)

    monkeypatch.setattr(PagedEngine, "_choose", broken)


def _half_batch(monkeypatch, cell):
    def change(self, choose, logits, temps, seed, rowmap):
        logits = logits.clone()
        logits[(logits.shape[0] + 1) // 2:] = logits[0]
        return choose(self, logits, temps, seed, rowmap)

    _wrap_choose(monkeypatch, change)


def _token_altered(monkeypatch, cell):
    def change(self, choose, logits, temps, seed, rowmap):
        tok = choose(self, logits, temps, seed, rowmap)
        return torch.remainder(tok + 1, logits.shape[-1])

    _wrap_choose(monkeypatch, change)


@pytest.mark.parametrize("cell", CLOSED)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered])
def test_a_broken_path_is_not_correct(judge_all, monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    out = run_cell(cell, seed=7, limit=SMALL_LIMIT)
    assert not out["correct"]
    assert gap(out) > SMALL_LIMIT


# ------------------- the sampled token choice broken ------------------- #


def _sampled(temps):
    return torch.as_tensor(temps > 0)


def _argmax(monkeypatch, cell):
    _wrap_choose(monkeypatch, lambda self, choose, logits, *a:
                 logits.argmax(-1))


def _uniform(monkeypatch, cell):
    gen = torch.Generator().manual_seed(5)

    def change(self, choose, logits, temps, seed, rowmap):
        tok = choose(self, logits, temps, seed, rowmap)
        flat = torch.randint(0, logits.shape[-1], tok.shape, generator=gen)
        return torch.where(_sampled(temps), flat, tok)

    _wrap_choose(monkeypatch, change)


def _wrong_row(monkeypatch, cell):
    def change(self, choose, logits, temps, seed, rowmap):
        rows = torch.nonzero(_sampled(temps))[:, 0]
        logits = logits.clone()
        logits[rows] = logits[rows.roll(1)]
        return choose(self, logits, temps, seed, rowmap)

    _wrap_choose(monkeypatch, change)


def _stuck_uniform(monkeypatch, cell):
    from repro_torch.kernels.drange import ops

    monkeypatch.setattr(
        ops, "pim_random_uniform",
        lambda seed, rows, cols, dev, rowmap=None: torch.full(
            (rows, cols), 0.5, device=dev))


@pytest.mark.parametrize("cell", CLOSED)
@pytest.mark.parametrize("fault", [_argmax, _uniform, _wrong_row,
                                   _stuck_uniform])
def test_a_broken_draw_is_not_correct(judge_all, monkeypatch, cell, fault):
    from bench import weights

    # the full widths' logits spread by about 1; the small ones' by 0.2,
    # where a draw from a near-flat neighbour row is hard to tell apart
    monkeypatch.setattr(weights, "EMBED_STD", 0.12)
    fault(monkeypatch, cell)
    out = run_cell(cell, seed=7, limit=1e9)
    assert not out["correct"]
    assert any(out["checks"][k]["value"] > out["checks"][k]["limit"]
               for k in DRAWN), out["checks"]


@pytest.mark.parametrize("cell", CLOSED)
def test_at_that_spread_a_sound_draw_passes_and_planted_ones_fail(
        judge_all, monkeypatch, cell):
    from bench import weights

    monkeypatch.setattr(weights, "EMBED_STD", 0.12)
    out = run_cell(cell, seed=7, limit=1e9, control=True)
    prog = out["judged"]["program"]
    for k in DRAWN:
        assert prog[k] <= limits(cell)[k], (k, prog[k])
    # the faults planted in the reference's own draw: each fails one
    for name, r in out["judged"]["faults"].items():
        assert any(r[k] > limits(cell)[k] for k in DRAWN), (name, r)
