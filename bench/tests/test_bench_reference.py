"""The plain reference against the port at a tiny size, both in float32
(the port's compute dtype patched), on the same weights; and the
reference's independence from the program."""

import ast
import dataclasses

import pytest
import torch

from bench import model, reference, system, weights
from bench.tests.small import BENCH, config


def _program_logits(m, w, tokens):
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import layers
    from repro_torch.models import transformer as T

    cfg = system.program_config(m)
    w32 = {k: v.float() for k, v in w.items()}
    params = system.program_params(m, w32, cfg)
    old = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        with torch.no_grad():
            logits, _ = T.forward(
                cfg, ParallelConfig(attention_impl="naive", remat="none"),
                params, {"tokens": torch.as_tensor([tokens])}, mode="train")
    finally:
        layers.COMPUTE_DTYPE = old
    return logits[0].float()


@pytest.mark.parametrize("name", ["granite-3-8b", "mamba2-1.3b"])
def test_reference_equals_the_port_in_float32(name):
    m = model.from_dict(config(name))
    if m.ssm is not None:
        m = dataclasses.replace(m, ssm=dataclasses.replace(m.ssm, chunk=8))
    w = weights.make(m, 2 ** 31 + 17, "cpu")
    tokens = torch.randint(0, m.vocab, (40,),
                           generator=torch.Generator().manual_seed(3)).tolist()
    ours = _program_logits(m, w, tokens)
    ref = reference.logits(m, {k: v.float() for k, v in w.items()},
                           [(tokens, 0)])[0]
    scale = ref.abs().max()
    assert torch.allclose(ours, ref, atol=2e-4 * scale, rtol=0), \
        float((ours - ref).abs().max() / scale)


def test_the_control_parts_from_the_reference():
    m = model.from_dict(config("granite-3-8b"))
    w = weights.make(m, 5, "cpu")
    tokens = list(range(1, 60))
    ref = reference.logits(m, w, [(tokens, 0)])[0]
    ctl = reference.logits(m, w, [(tokens, 0)], precision="fp8")[0]
    assert reference.widest_gap(ref, ref.argmax(-1)) == 0.0
    assert reference.widest_gap(ref, ctl.argmax(-1)) > 0.0


def test_widest_gap():
    ref = torch.tensor([[0.0, 2.0, 1.5], [3.0, 1.0, 0.0]])
    assert reference.widest_gap(ref, torch.tensor([2, 0])) == 0.5
    assert reference.widest_gap(ref, torch.tensor([1, 2])) == 3.0


def test_the_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("repro_torch", "repro", "jax"), (f, mod)
                if top == "bench":
                    assert mod in ("bench.model",), (f, mod)


def _rows(seed, n=400, vocab=512, std=1.3):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(n, vocab, generator=gen) * std]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_draw_stats_pass_a_sound_draw(seed):
    refs = _rows(seed)
    u = torch.rand(400, generator=torch.Generator().manual_seed(seed + 9),
                   dtype=torch.float64)
    st = reference.draw_stats(refs, [reference.draw(refs[0], u)],
                              torch.Generator().manual_seed(seed))
    assert abs(st["nll_z"]) < 4 and st["pit_ks"] < 2.0 and st["tokens"] == 400


def test_draw_stats_fail_a_broken_draw():
    refs = _rows(4)
    r = refs[0]
    gen = torch.Generator().manual_seed(4)
    half = torch.full((400,), 0.5, dtype=torch.float64)
    u = torch.rand(400, generator=gen, dtype=torch.float64)
    argmax = reference.draw_stats(refs, [r.argmax(-1)], gen)
    other = reference.draw_stats(refs, [reference.draw(r.roll(200, 0), u)], gen)
    stuck = reference.draw_stats(refs, [reference.draw(r, half)], gen)
    assert argmax["nll_z"] < -20
    assert other["nll_z"] > 10
    assert stuck["pit_ks"] > 5


def test_draw_is_the_inverse_cdf():
    logits = torch.log(torch.tensor([[0.25, 0.25, 0.5]]))
    picks = [int(reference.draw(logits, torch.tensor([x]))[0])
             for x in (0.0, 0.24, 0.26, 0.49, 0.51, 0.99)]
    assert picks == [0, 0, 1, 1, 2, 2]
