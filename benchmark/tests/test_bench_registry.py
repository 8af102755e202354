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


PENDING = harness.load_json(harness.HERE / "pending.json")


@pytest.mark.parametrize("cell", PENDING["workloads"],
                         ids=lambda c: c["name"])
def test_pending_cell_files_found_by_name(cell, monkeypatch):
    monkeypatch.chdir(ROOT)
    spec = harness.with_pending(SPEC)
    config = harness.config_of(spec, cell)
    assert config["name"] == cell["config"] and config["reduced"] == []
    assert harness.driver_of(harness.traffic_of(cell)).run
    assert harness.limits_of(cell)["limits"]
    for trace in (False, True):
        names = [m["name"] for m in harness.metrics_of(spec, cell, trace)]
        assert [n for n in names if n != "setup_s"], (cell["name"], trace)
        for name in names:
            assert callable(harness.reader(name))


def test_pending_entries_are_benchmark_entries_not_yet_in_it():
    """Each entry of ``pending.json`` has the shape of its kind in
    ``BENCHMARK.json`` and a name that is not there yet, so that moving
    it over is all a later PR does (a bound it has not measured is
    null)."""
    for key, entries in PENDING.items():
        shapes = {frozenset(e) - {"workloads"} for e in SPEC[key]}
        names = {e["name"] for e in SPEC[key]}
        for e in entries:
            assert frozenset(e) - {"workloads"} in shapes, e
            assert NAME.match(e["name"]) and e["name"] not in names
            if "unit" in e:
                assert UNIT.match(e["unit"])
                assert (harness.HERE / "metrics"
                        / f"{e['name']}.py").exists()
            if e.get("bound") is not None:
                assert 0.01 <= e["bound"] <= 0.25
            assert len(e.get("why", "")) <= 200


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
