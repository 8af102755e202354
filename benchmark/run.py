"""Run one cell of the benchmark once and print its result line:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Sets up the cell (weights and inputs from the
seed, every shape it will use warmed up), measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints, as the last line of standard output, one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` with
``--trace 1``, and ``checks``, each number compared beside its limit, also
the last lines of standard error).

Exits non-zero and prints no result when no CUDA card is visible, when
fewer cards are visible than the cell asks for, or when the process holds
a module of ``jax``, ``jaxlib``, ``flax`` or ``qaig_tpu`` once the window
has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def _caches():
    """Every build and kernel cache inside the checkout, at fixed paths.
    Python's bytecode too: where the environment writes none
    (``PYTHONDONTWRITEBYTECODE``) or cannot write beside the sources,
    every run would compile torch's modules again, seconds of set-up that
    swing with the host's load."""
    build = Path.cwd() / "build"
    sys.pycache_prefix = str(build / "pycache")
    sys.dont_write_bytecode = False
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", required=True, type=int)
    parser.add_argument("--seconds", required=True, type=float)
    parser.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = parser.parse_args(argv)
    _caches()

    from benchmark import harness
    spec = harness.benchmark_spec()
    cell = harness.find_cell(spec, args.workload)
    traffic = harness.traffic_of(cell)
    if traffic.get("one_malloc_arena"):
        # as the server's entry point does, before any thread starts
        from qaig_tpu_torch.cli.serve_generation import one_malloc_arena
        one_malloc_arena()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA card is visible", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    ctx = harness.Ctx(
        cell=cell, config=harness.config_of(spec, cell),
        traffic=traffic, limits=harness.limits_of(cell),
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device="cuda:0", t0=T0, kind=torch.cuda.get_device_name(0))
    record = harness.driver_of(ctx.traffic).run(ctx)
    ctx.power_limit = harness.power_limit()   # after the window: not set-up
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    out, lines = harness.result(ctx, record, spec)
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
