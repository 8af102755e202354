"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program on the CPU at a small
size, drives the rest of a run (the harness's look for a card skipped)
and is judged against the cell's own limits.  A sound run comes out
correct.  The cascade runs in float32 here: the CPU's bfloat16 products
round otherwise than the card's, which the limits were read on."""

import json
import time

import pytest
from benchmark import faults, harness
from benchmark.tests import smoke

SPEC = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())


def _cell(name):
    return harness.find_cell(SPEC, name)


def _run(cell_name, config, traffic, seconds=0.5, seed=2 ** 31 + 101):
    cell = _cell(cell_name)
    base = harness.traffic_of(cell)
    base.update(traffic)
    ctx = harness.Ctx(cell=cell, config=config, traffic=base,
                      limits=harness.limits_of(cell), seed=seed,
                      seconds=seconds, trace=False, device="cpu",
                      t0=time.perf_counter())
    record = harness.driver_of(base).run(ctx)
    out, _ = harness.result(ctx, record, SPEC)
    return out


CASCADE = smoke.with_updates(smoke.cascade_config(), dtype="float32")
GEN = {"batch": 4, "warm_calls": 1, "check_rows": 4}
SERVE = {"rate": 4.0, "max_batch": 8, "warm_batches": [1, 2, 4, 8],
         "check_requests": 4, "threads": 16}
TRAIN = {"samples": 32, "warm_steps": 1}


def test_generation_sound_run_is_correct():
    out = _run("gen_b256", CASCADE, GEN)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(faults.CASCADE))
def test_generation_fault_is_caught(fault, monkeypatch):
    faults.CASCADE[fault](monkeypatch.setattr)
    out = _run("gen_b256", CASCADE, GEN)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_serving_fault_is_caught(fault, monkeypatch):
    faults.SERVE[fault](monkeypatch.setattr)
    out = _run("serve_poisson_b32", CASCADE, SERVE,
               seconds=1.5)
    assert not out["correct"], out["checks"]


def test_serving_sound_run_is_correct():
    out = _run("serve_poisson_b32", CASCADE, SERVE,
               seconds=1.5)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0


def test_training_sound_run_is_correct():
    out = _run("train_casc2_b64", smoke.train_config(), TRAIN)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_training_fault_is_caught(fault, monkeypatch):
    faults.TRAIN[fault](monkeypatch.setattr)
    out = _run("train_casc2_b64", smoke.train_config(), TRAIN)
    assert not out["correct"], out["checks"]
