"""The port's roofline package and the ``serve_rowclone`` example.

* ``repro_torch.roofline.analysis`` against the JAX package's: for every
  architecture and each of its cells (``cells_for``), ``model_flops``,
  ``active_params`` and ``num_attn_layers`` equal, and
  ``RooflineTerms.as_dict()`` equal once the JAX package's TPU
  constants are patched into the port's ``hw`` (the formulas are the
  same; only the constants differ).  ``hw`` holds an H100's constants,
  no TPU's.
* ``Mesh.collective_bytes`` (the counters that take the place of the
  JAX package's HLO parse) at world 2: one decode round of the
  tensor-parallel engine counts the JAX engine's collectives, two
  all-reduces a layer (attention-out and MLP-down sums, bf16) plus the
  embedding's (bf16) and the logits' (float32), each call's output
  bytes.
* ``repro_torch.examples.serve_rowclone`` on the CPU (``--device
  cpu``): the JAX shim's scenario, eight requests of which four share
  the first prompt's prefix through the radix cache.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_ranks as R  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import cells_for as jcells_for  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.models.params import param_count as jparam_count  # noqa: E402
from repro.roofline import analysis as JA  # noqa: E402
from repro.roofline import hw as JHW  # noqa: E402
from repro_torch.configs import ARCHS, cells_for, reduced  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import param_count  # noqa: E402
from repro_torch.roofline import analysis as A  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402


@pytest.mark.parametrize("arch", list(ARCHS))
def test_analysis_matches_jax_for_every_cell(arch, monkeypatch):
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_LINK_BW"):
        monkeypatch.setattr(hw, name, getattr(JHW, name))
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    n = param_count(T.model_defs(cfg))
    assert n == jparam_count(JT.model_defs(jcfg))
    assert A.num_attn_layers(cfg) == JA.num_attn_layers(jcfg)
    assert A.active_params(cfg, n) == JA.active_params(jcfg, n)
    cells, jcells = cells_for(cfg), jcells_for(jcfg)
    assert [dataclasses.astuple(c) for c in cells] == \
        [dataclasses.astuple(c) for c in jcells]
    for shape, jshape in zip(cells, jcells):
        mf = A.model_flops(cfg, shape, n)
        assert mf == JA.model_flops(jcfg, jshape, n)
        terms = dict(flops=mf / 256 * 1.3, hbm_bytes=4.0e11,
                     coll_bytes=2.0e9, chips=256, model_flops=mf)
        assert A.RooflineTerms(**terms).as_dict() == \
            JA.RooflineTerms(**terms).as_dict()


def test_hw_holds_h100_constants_and_totals_collectives():
    assert (hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_F32, hw.HBM_BW) == \
        (989e12, 67e12, 3.35e12)
    assert hw.HBM_BYTES == 80 * 10 ** 9
    assert hw.ICI_LINK_BW == hw.NVLINK_BW_TOTAL / 2 == 450e9
    assert hw.NVLINK_BW_TOTAL / hw.NVLINK_LINKS == 50e9
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_LINK_BW", "HBM_BYTES"):
        assert getattr(hw, name) != getattr(JHW, name), name
    parsed = {"all-gather": 10, "all-reduce": 7, "reduce-scatter": 3,
              "all-to-all": 2, "collective-permute": 1,
              "_counts": {"all-reduce": 1}}
    assert A.collective_bytes_total(parsed) == \
        JA.collective_bytes_total(parsed) == 30


def test_mesh_counters_count_a_tensor_parallel_round():
    cfg = reduced(ARCHS["granite-3-8b"], num_layers=2)
    jcfg = jreduced(JARCHS["granite-3-8b"], num_layers=2)
    params = jax.tree.map(np.asarray, jinit(JT.model_defs(jcfg),
                                            jax.random.PRNGKey(0)))
    ranks = run_ranks(R.round_collectives, 2, backend="gloo", timeout=90.0,
                      args=(cfg, params))
    Bp = 4                               # three live rows, padded
    assert ranks[0]["active"] == 3
    sums = 2 * cfg.num_layers + 1        # the layers' sums, the embedding
    want = {"all-gather": 0, "reduce-scatter": 0, "all-to-all": 0,
            "collective-permute": 0,
            "all-reduce": sums * Bp * cfg.d_model * 2
            + Bp * cfg.vocab_size * 4,
            "_counts": {"all-gather": 0, "all-reduce": sums + 1,
                        "reduce-scatter": 0, "all-to-all": 0,
                        "collective-permute": 0}}
    for r in ranks:
        assert r["bytes"] == want


def test_serve_rowclone_on_the_cpu(capsys):
    from repro_torch.examples import serve_rowclone
    out = serve_rowclone.main(["--device", "cpu"])
    assert out["device"] == "cpu"
    assert out["requests"] == 8 and out["tokens"] == 64
    assert out["engine_stats"]["prefix_hits"] == 4
    assert out["cache_stats"]["prefix_hit_tokens"] > 0
    # the radix cache keeps the committed prefix pages after the run
    assert out["pages_in_use_at_end"] > 0
    assert all(len(t) == 8 for t in out["results"].values())
