"""Find the serving knee once: one set-up of a serving cell, then its
schedule offered at each of a ladder of rates for ``--seconds`` each.  A
rate is sustained when nothing is refused and the latency does not grow
over the window (the last quarter's median within 1.5 times the first
quarter's).  One JSON line a rate.

    python3 -m benchmark.tools.sweep_serve --workload serve_poisson_b32 \
        --rates 5,10,15,20 --seconds 20 --seed 1
"""

import argparse
import json
import statistics
import sys
import time

from benchmark import harness
from benchmark.run import _caches


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)
    _caches()
    spec = harness.benchmark_spec()
    cell = harness.find_cell(spec, args.workload)
    traffic = harness.traffic_of(cell)
    if traffic.get("one_malloc_arena"):
        from qaig_tpu_torch.cli.serve_generation import one_malloc_arena
        one_malloc_arena()
    import torch
    from benchmark.drivers import serve
    ctx = harness.Ctx(cell=cell, config=harness.config_of(spec, cell),
                      traffic=traffic, limits=harness.limits_of(cell),
                      seed=args.seed, seconds=args.seconds, trace=False,
                      device="cuda:0", t0=time.perf_counter(),
                      kind=torch.cuda.get_device_name(0))
    server = serve.Server(ctx)
    print(json.dumps({"setup_s": time.perf_counter() - ctx.t0}), flush=True)
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            offered = dict(traffic, rate=rate)
            requests = serve.schedule(offered, args.seed + i, args.seconds)
            results, window_s, delta = server.window(requests,
                                                     traffic["threads"])
            lat = [r[0] for r in results]
            q = max(1, len(lat) // 4)
            ok = sorted(x for x in lat if x != float("inf"))
            line = {"rate": rate, "requests": len(lat),
                    "failed": sum(1 for r in results if r[1] is None),
                    "p50": ok[len(ok) // 2] if ok else None,
                    "p95": ok[int(0.95 * (len(ok) - 1))] if ok else None,
                    "first_q_median": statistics.median(lat[:q]),
                    "last_q_median": statistics.median(lat[-q:]),
                    "window_s": window_s, "counters": delta}
            line["sustained"] = (line["failed"] == 0 and
                                 line["last_q_median"]
                                 <= 1.5 * line["first_q_median"])
            print(json.dumps(line), flush=True)
            server.dispatches.clear()
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
