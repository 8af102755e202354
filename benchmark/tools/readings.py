"""The numbers a cell compares, for many seeds in one process, with the
control's beside them: the readings its limits are set from.

    python3 -m benchmark.tools.readings --workload <cell> --seconds <s> \
        --seeds 11,12,13 [--control] [--out readings.jsonl]

Each seed is a whole run of the cell's traffic driver (set-up, window,
reference) with ``--trace 0``; with ``--control`` it also computes the
control's numbers (the reference in the next precision below the
configuration's, in the program's place).  One JSON line a seed, with
``correct`` (the program's numbers held to the cell's limits, as a run
decides it) and with ``--control`` ``control_correct`` (the control's
numbers held to the same limits in the same way).
"""

import argparse
import json
import sys
import time

from benchmark import harness
from benchmark.run import _caches


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--rate", type=float, default=None,
                        help="serving cells: offer this rate instead")
    parser.add_argument("--fault", default=None,
                        help="plant this fault of faults.py's table of the "
                             "cell's kind underneath every run")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    _caches()
    spec = harness.benchmark_spec()
    cell = harness.find_cell(spec, args.workload)
    traffic = harness.traffic_of(cell)
    if traffic.get("one_malloc_arena"):
        from qaig_tpu_torch.cli.serve_generation import one_malloc_arena
        one_malloc_arena()
    if args.rate is not None:
        traffic["rate"] = args.rate
    import torch
    from benchmark import faults
    if args.fault:
        table = {"generate": faults.CASCADE, "serve": faults.SERVE,
                 "train": faults.TRAIN}[traffic["driver"]]
        table[args.fault](faults.Patches())
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = harness.Ctx(
            cell=cell, config=harness.config_of(spec, cell), traffic=traffic,
            limits=harness.limits_of(cell), seed=seed, seconds=args.seconds,
            trace=False, device="cuda:0", t0=time.perf_counter(),
            control=args.control, kind=torch.cuda.get_device_name(0))
        record = harness.driver_of(traffic).run(ctx)
        metrics = {m["name"]: harness.reader(m["name"])(record, ctx)
                   for m in harness.metrics_of(spec, cell, False)}
        correct, _ = harness.verdict(record["readings"], ctx.limits,
                                     complete=record.get("complete", True))
        line = {"workload": cell["name"], "seed": seed, "fault": args.fault,
                "correct": correct, "readings": record["readings"],
                "metrics": metrics,
                "setup_s": record["setup_s"],
                "reference_s": record.get("reference_s"),
                "memory_peak_bytes": record["memory_peak_bytes"],
                "extra": {k: record[k] for k in
                          ("serve_counters", "leaves", "lateness_max_s",
                           "failed", "checked_images") if k in record}}
        if args.control:
            line["control_correct"], _ = harness.verdict(
                record["readings"], ctx.limits, ".control")
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del record
    return 0


if __name__ == "__main__":
    sys.exit(main())
