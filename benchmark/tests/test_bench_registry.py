"""The harness finds every configuration, traffic mix, limits file and
metric reader of ``BENCHMARK.json`` by name, and the file keeps the
contract's shape."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell, monkeypatch):
    monkeypatch.chdir(ROOT)
    assert harness.find_cell(SPEC, cell["name"]) is cell
    config = harness.config_of(SPEC, cell)
    assert config["name"] == cell["config"]
    assert config["reduced"] == []
    traffic = harness.traffic_of(cell)
    assert harness.driver_of(traffic).run
    limits = harness.limits_of(cell)["limits"]
    assert limits and all(v > 0 for v in limits.values())
    for trace in (False, True):
        names = [m["name"] for m in harness.metrics_of(SPEC, cell, trace)]
        assert names, (cell["name"], trace)
        for name in names:
            assert callable(harness.reader(name))
    # setup_s, another end-to-end metric and a per-layer one in every cell
    e2e = [m["name"] for m in harness.metrics_of(SPEC, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2, e2e


def test_every_metric_has_a_reader_and_a_known_arrow():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = next(x for x in SPEC["end_to_end"]
                         if x["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    e2e_keys = {"name", "unit", "better", "bound", "source"}
    layer_keys = {"name", "unit", "better", "source", "layer", "moves"}
    for keys, entries, sources in (
            (e2e_keys, SPEC["end_to_end"], {"host_clock", "device_trace"}),
            (layer_keys, SPEC["per_layer"], {"device_trace", "program_span",
                                             "program_counter",
                                             "host_clock"})):
        for m in entries:
            assert set(m) - {"workloads"} == keys, m
            assert m["source"] in sources, m
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"])
    assert 1 <= SPEC["run_seconds"] <= 51


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell(SPEC, "no_such_cell")
