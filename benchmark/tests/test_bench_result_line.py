"""The result line meets the contract: its keys, the metrics of the run's
kind with their units, the device, and the numbers compared, last."""

import json
import math
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _record(**kw):
    rec = {"setup_s": 31.5, "window_s": 30.2, "samples": 6272, "steps": 98,
           "batch": 64, "attempted": 6272, "failed": 0,
           "memory_peak_bytes": 123, "graph_setup_s": 0.8,
           "loader_wait_s": 0.05,
           "readings": {"loss_gap": 1e-8, "grad_gap": 1e-7,
                        "update_gap": 1e-6},
           "trace_steps": 3,
           "trace": {"busy_s": 1.0, "window_s": 1.25, "span_s": 1.2,
                     "n_kernels": 12000,
                     "kernels": {"flash_attention_fwd_f32_kernel": (36, 0.1),
                                 "flash_bwd_dq_rows_kernel": (36, 0.2),
                                 "gemm": (11928, 0.6)},
                     "spans": {"train.step": 0.6, "graph.copy_in": 0.0003,
                               "data.wait": 0.0005},
                     "breakdown": {"device_ops": [["gemm", 0.9]],
                                   "idle_gaps": [["cudaGraphLaunch",
                                                  0.001]]}}}
    rec.update(kw)
    return rec


def _cascade_record(cell):
    """A made-up record of a generation (``gen_b256``) or serving run."""
    rec = {"setup_s": 35.0, "window_s": 30.6, "attempted": 2560, "failed": 0,
           "memory_peak_bytes": 123, "graph_setup_s": 11.0,
           "readings": {"token_gap_mean": 1e-5, "token_gap": 0.01,
                        "pixel_err": 1e-3},
           "trace": {"busy_s": 3.09, "window_s": 3.13, "span_s": 3.1,
                     "n_kernels": 208000,
                     "kernels": {"prefix_split_kernel<bf16, bf16>":
                                 (12600, 1.57), "gemm": (195400, 1.5)},
                     "stages": {"stage_0": 0.2, "stage_1": 0.5,
                                "stage_2": 2.3, "decoder": 0.01},
                     "breakdown": {"device_ops": [["gemm", 1.5]],
                                   "idle_gaps": [["none", 0.001]]}}}
    if cell == "gen_b256":
        rec.update(images=2560, calls=10, batch=256, trace_calls=1)
    else:
        rec.update(latencies=[1.0 + i / 500 for i in range(528)],
                   serve_counters={"dispatches": 100, "padded": 400,
                                   "dispatched": 2700, "rows": 2300,
                                   "rejected": 0, "served": 528,
                                   "queue_wait_s": 200.0})
    return rec


def _ctx(trace, limits=None, name="train_casc2_b64"):
    cell = harness.find_cell(SPEC, name)
    return harness.Ctx(cell=cell, config=harness.config_of(SPEC, cell),
                       traffic=harness.traffic_of(cell),
                       limits=limits or harness.limits_of(cell), seed=1,
                       seconds=30, trace=trace, device="cuda:0", t0=0.0,
                       kind="NVIDIA H100 80GB HBM3",
                       power_limit="700.00 W")


@pytest.mark.parametrize("trace", [False, True])
def test_line_keys_and_metrics(trace, monkeypatch):
    monkeypatch.chdir(ROOT)
    out, lines = harness.result(_ctx(trace), _record(), SPEC)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert out["correct"] is True
    want = {m["name"]: m["unit"] for m in
            harness.metrics_of(SPEC, _ctx(trace).cell, trace)}
    assert set(out["metrics"]) == set(want)
    for name, m in out["metrics"].items():
        assert m["unit"] == want[name] and m["value"] > 0
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == "NVIDIA H100 80GB HBM3"
    if trace:
        assert dev["busy_s"] == 1.0 and dev["window_s"] == 1.25
        assert len(out["breakdown"]["device_ops"]) <= 10
        for name in ("mfu.train", "flash_attn_roofline"):
            assert 0 < out["metrics"][name]["value"] <= 100
    else:
        assert "breakdown" not in out
    assert len(lines) == len(out["checks"])
    assert all(line.startswith("check ") for line in lines)
    json.loads(json.dumps(out))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["gen_b256", "serve_poisson_b32"])
def test_cascade_lines_read_every_metric(cell, trace, monkeypatch):
    """A generation or serving line carries every metric listed for its
    cell, each above 0, a share of a roofline or peak at most 100."""
    monkeypatch.chdir(ROOT)
    ctx = _ctx(trace, name=cell)
    out, _ = harness.result(ctx, _cascade_record(cell), SPEC)
    assert out["correct"] is True
    want = {m["name"]: m["unit"] for m in
            harness.metrics_of(SPEC, ctx.cell, trace)}
    assert {n: m["unit"] for n, m in out["metrics"].items()} == want
    for name, m in out["metrics"].items():
        assert m["value"] > 0, name
        assert m["value"] <= {"%": 100, "fraction": 1}.get(m["unit"],
                                                           m["value"]), name


def test_a_number_over_its_limit_or_missing_fails(monkeypatch):
    monkeypatch.chdir(ROOT)
    out, _ = harness.result(_ctx(False), _record(
        readings={"loss_gap": 1e9, "grad_gap": 0.0, "update_gap": 0.0}), SPEC)
    assert out["correct"] is False
    out, _ = harness.result(_ctx(False), _record(
        readings={"grad_gap": 0.0, "update_gap": 0.0}), SPEC)
    assert out["correct"] is False
    assert math.isnan(out["checks"]["loss_gap"]["value"])


def test_a_reader_that_finds_nothing_leaves_its_metric_out(monkeypatch):
    monkeypatch.chdir(ROOT)
    out, _ = harness.result(_ctx(True), _record(trace=None), SPEC)
    assert "idle_share.train" not in out["metrics"]
    assert "flash_attn_roofline" not in out["metrics"]
    assert "mfu.train" not in out["metrics"]


def test_mfu_reads_the_traced_steps_not_the_window(monkeypatch):
    """``mfu.train`` is the traced steps' products over the device's span
    of them: the window's rate does not set it, the span does."""
    monkeypatch.chdir(ROOT)

    def mfu(**kw):
        out, _ = harness.result(_ctx(True), _record(**kw), SPEC)
        return out["metrics"]["mfu.train"]["value"]
    base = mfu()
    assert mfu(steps=49) == base
    trace = dict(_record()["trace"], span_s=2.4)
    assert abs(mfu(trace=trace) - base / 2) < 1e-9 * base
