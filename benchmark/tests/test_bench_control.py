"""On a card: the control (the plain reference in the next precision below
the configuration's, in the program's place) comes out not correct when the
harness holds its numbers to the cell's own limits as a run decides
``correct``; the training cell's program comes out correct under them.  At a size a test run holds; the
readings at the cells' own sizes come from ``tools/readings.py
--control``, which prints the same two verdicts.  Run on the card with
``python -m pytest -m cuda benchmark/tests``."""

import time

import pytest

from benchmark import harness
from benchmark.tests import smoke
from benchmark.tests.test_bench_faults import GEN, SERVE, TRAIN, _cell


def _verdicts(cell_name, config, traffic, device, seed, seconds=1.0):
    """(program correct, control correct, control's checks, readings)."""
    cell = _cell(cell_name)
    base = harness.traffic_of(cell)
    base.update(traffic)
    ctx = harness.Ctx(cell=cell, config=config, traffic=base,
                      limits=harness.limits_of(cell), seed=seed,
                      seconds=seconds, trace=False, device=device, t0=time.perf_counter(),
                      control=True)
    record = harness.driver_of(base).run(ctx)
    sound, _ = harness.verdict(record["readings"], ctx.limits,
                               complete=record.get("complete", True))
    control, checks = harness.verdict(record["readings"], ctx.limits,
                                      ".control")
    return sound, control, checks, record["readings"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12, 3_000_000_013])
def test_generation_control_fails_a_limit(seed, cuda_device):
    """The generation cell's limits are read at its own size, where the
    program passes them; at this size the program's bf16 gaps are not
    held to them, only set apart from the control's."""
    _, control, checks, readings = _verdicts(
        "gen_b256", smoke.cascade_config(), dict(GEN, batch=8), cuda_device,
        seed)
    assert not control, checks
    assert any(readings[f"{k}.control"] >= 3 * max(readings[k], 1e-12)
               for k, _, _ in checks), readings


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [31, 2 ** 31 + 32, 3_000_000_033])
def test_serving_control_fails_a_limit(seed, cuda_device):
    """As the generation cell's, over the requests that the batcher
    served."""
    _, control, checks, readings = _verdicts(
        "serve_poisson_b32", smoke.cascade_config(), SERVE, cuda_device,
        seed, seconds=1.5)
    assert not control, checks
    assert any(readings[f"{k}.control"] >= 3 * max(readings[k], 1e-12)
               for k, _, _ in checks), readings


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 2 ** 31 + 22, 3_000_000_023])
def test_training_control_fails_a_limit(seed, cuda_device):
    sound, control, checks, _ = _verdicts(
        "train_casc2_b64", smoke.train_config(), TRAIN, cuda_device, seed)
    assert sound and not control, checks
