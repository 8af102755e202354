"""The harness: finds a cell's configuration, traffic, limits and metric
readers by the names in ``BENCHMARK.json``, runs the cell's driver once,
and prints the result.

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<mix>.json``: the traffic mix's parameters, with ``driver``
  naming ``drivers/<driver>.py``, whose ``run(ctx)`` returns the run's
  record;
* ``limits/<cell>.json``: the limit of each number compared;
* ``metrics/<metric>.py``: one reader a metric, ``read(record, ctx)``,
  which returns the value, or None where it finds nothing to read (the
  metric is then left out of the line).

A driver's record holds ``setup_s``, the window's numbers, ``readings``
(the numbers compared, by name), ``attempted`` / ``failed``,
``memory_peak_bytes``, optionally ``setup_parts`` (the set-up's seconds by
phase, copied into the result line), optionally ``window`` (how the
window ran, copied too) and, in a traced run, ``trace``
(``trace.py``'s summary).
"""

import importlib
import importlib.util
import json
import math
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qaig_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root="."):
    return load_json(Path(root) / "BENCHMARK.json")


@dataclass
class Ctx:
    """What a driver gets: the cell and its files, the run's arguments."""
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    control: bool = False
    kind: str = "cpu"
    power_limit: str = None


def find_cell(spec, name):
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(spec, cell):
    for cfg in spec["configs"]:
        if cfg["name"] == cell["config"]:
            return load_json(Path(cfg["file"]))
    raise KeyError(f"no configuration {cell['config']!r}")


def traffic_of(cell):
    return load_json(HERE / "traffic" / f"{cell['traffic']}.json")


def limits_of(cell):
    return load_json(HERE / "limits" / f"{cell['name']}.json")


def driver_of(traffic):
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


def metrics_of(spec, cell, trace):
    """The cell's metrics of a run: its end-to-end ones, or with
    ``trace`` its per-layer ones (each listed for the cell, or for every
    cell where it names none)."""
    out = []
    for m in spec["per_layer" if trace else "end_to_end"]:
        cells = m.get("workloads")
        if cells is None or cell["name"] in cells:
            out.append(m)
    return out


def reader(name):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that the benchmark's process must
    not hold, compared whole (``qaig_tpu_torch`` is not ``qaig_tpu``)."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def power_limit():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def limit_checks(readings, limits, suffix=""):
    """[(name, value, limit)] of every number compared, in the limits'
    order, read from ``readings`` under ``name + suffix`` (``.control``:
    the control's); a number the run did not give counts as failed
    (nan)."""
    return [(name, readings.get(name + suffix, math.nan), lim)
            for name, lim in limits["limits"].items()]


def verdict(readings, limits, suffix="", complete=True):
    """(correct, checks): the numbers under ``suffix`` held to the cell's
    limits, as a run's ``correct`` is decided."""
    checks = limit_checks(readings, limits, suffix)
    return bool(complete) and all(v <= lim for _, v, lim in checks), checks


def result(ctx, record, spec):
    """The result line's object, and the check lines for standard
    error."""
    correct, checks = verdict(record["readings"], ctx.limits,
                              complete=record.get("complete", True))
    metrics = {}
    for m in metrics_of(spec, ctx.cell, ctx.trace):
        value = reader(m["name"])(record, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device.startswith("cuda") else "cpu",
              "kind": ctx.kind, "count": ctx.cell["chips"],
              "memory_peak_bytes": record["memory_peak_bytes"],
              "power_limit": ctx.power_limit}
    out = {"correct": correct, "attempted": record["attempted"],
           "failed": record["failed"], "metrics": metrics, "device": device}
    if ctx.trace and record.get("trace"):
        device["busy_s"] = record["trace"]["busy_s"]
        device["window_s"] = record["trace"]["window_s"]
        out["breakdown"] = record["trace"]["breakdown"]
    if record.get("setup_parts"):
        out["setup_parts"] = record["setup_parts"]
    if record.get("window"):
        out["window"] = record["window"]
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    lines = [f"check {name}: {v!r} limit {lim!r}" for name, v, lim in checks]
    return out, lines
