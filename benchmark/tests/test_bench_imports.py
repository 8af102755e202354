"""No module of ``jax``, ``jaxlib``, ``flax`` or ``qaig_tpu`` in a run,
by whole top-level names (``qaig_tpu_torch`` begins with ``qaig_tpu``),
and the plain reference imports nothing of the program."""

import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("modules,found", [
    (["qaig_tpu_torch", "qaig_tpu_torch.infer.decode", "torch"], []),
    (["qaig_tpu", "qaig_tpu_torch"], ["qaig_tpu"]),
    (["qaig_tpu.models.core"], ["qaig_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "qaig_tpu_torchx"], []),
])
def test_whole_top_level_names(modules, found):
    assert harness.forbidden_modules(modules) == found


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    return eval(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_program():
    tops = _loaded_after("import benchmark.reference, benchmark.checks, "
                         "benchmark.counts, benchmark.peaks")
    assert "qaig_tpu_torch" not in tops
    assert harness.forbidden_modules(tops) == []


def test_a_run_loads_no_forbidden_module():
    tops = _loaded_after(
        "import time\n"
        "from benchmark import harness, system\n"
        "from benchmark.tests import smoke\n"
        "from benchmark.drivers import generate, serve, train\n"
        "cfg = smoke.cascade_config()\n"
        "system.build_cascade(cfg, 3, 'cpu')[0].generate(2, seed=1)\n"
        "import qaig_tpu_torch.cli.serve_generation\n")
    assert "qaig_tpu_torch" in tops
    assert harness.forbidden_modules(tops) == []
