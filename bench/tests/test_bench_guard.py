"""The import guard compares whole top-level names."""

import subprocess
import sys

import pytest

from bench import guard
from bench.tests.small import ROOT


@pytest.mark.parametrize("mods,bad", [
    (["jax"], ["jax"]),
    (["jax.numpy", "numpy"], ["jax"]),
    (["repro", "repro.serving.engine"], ["repro"]),
    (["flax.linen"], ["flax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["repro_torch", "repro_torch.serving.engine", "torch"], []),
    (["jaxtyping", "reprolib", "bench.harness"], []),
])
def test_offenders(mods, bad):
    assert guard.offenders(mods) == bad


def test_the_program_and_the_harness_load_no_jax():
    code = ("import sys; sys.path[:0] = ['src', '.'];"
            "import bench.harness, bench.system, repro_torch.serving.engine,"
            " repro_torch.serving.server; from bench import guard;"
            "print(guard.offenders(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
