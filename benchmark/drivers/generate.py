"""Batch generation, closed loop: one caller issues
``CascadePipeline.generate(batch, seed=...)`` calls back to back, each
with a seed of its own drawn from the run's seed, and waits for each
call's images before the next.

Traffic parameters: ``batch`` (images a call), ``warm_calls`` (calls made
before the window: the first captures the call's CUDA graph),
``check_rows`` (images of each call kept for the reference, drawn from the
seed), ``trace_calls`` (calls profiled after the window in a traced run,
whose record keeps the last one's device seconds by stage from the
program's stage clock, ``trace["stages"]``).

The window opens after the warm calls and closes when the last call
started before ``--seconds`` has returned: ``images_per_s`` is every image
of the window's calls over the window's length.
"""

import gc
import random
import time

import torch

from benchmark import checks, system
from benchmark import trace as tr

MAX_CALLS = 4000


def call_seed(seed, k):
    """The seed of call ``k`` of a run (warm calls: ``k`` from
    ``MAX_CALLS``)."""
    return int(seed) * 2 * MAX_CALLS + k


def check_rows(seed, k, batch, count):
    return sorted(random.Random(call_seed(seed, k)).sample(range(batch),
                                                           min(count, batch)))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx):
    cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
    batch = traffic["batch"]
    pipeline, weights, taps = system.build_cascade(cfg, ctx.seed, device)
    for k in range(traffic["warm_calls"]):
        pipeline.generate(batch, seed=call_seed(ctx.seed, MAX_CALLS + k))
        sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    kept = []
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    deadline = t_start + ctx.seconds
    calls = 0
    complete = True
    while True:
        if calls >= MAX_CALLS:
            raise RuntimeError("the window holds more calls than seeds")
        seed_k = call_seed(ctx.seed, calls)
        images, tokens = pipeline.generate(batch, seed=seed_k)
        rows = check_rows(ctx.seed, calls, batch, traffic["check_rows"])
        idx = torch.tensor(rows, device=images.device)
        staged = taps.tokens(batch, idx)
        if staged is None:      # a stage ran at another batch: no check
            complete = False
            staged = [torch.zeros_like(tokens.index_select(0, idx))] * len(
                cfg["stages"])
        kept.append((seed_k, rows, images.index_select(0, idx),
                     staged[:-1] + [tokens.index_select(0, idx)]))
        sync(device)
        calls += 1
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t_start
    record = {"setup_s": setup_s, "window_s": window_s, "calls": calls,
              "batch": batch, "images": calls * batch,
              "attempted": calls * batch, "failed": 0,
              "complete": complete,
              "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                    if device.startswith("cuda") else 0),
              "graph_setup_s": system.graph_setup_seconds(
                  pipeline._graphs)}
    if ctx.trace:
        def traced():
            for k in range(traffic["trace_calls"]):
                pipeline.generate(batch,
                                  seed=call_seed(ctx.seed, MAX_CALLS - 1 - k))
        _, record["trace"] = tr.profile(traced, device)
        record["trace"]["stages"] = pipeline.stage_seconds()
        record["trace_calls"] = traffic["trace_calls"]

    checked = {
        "seeds": torch.tensor([s for s, rows, _, _ in kept for _ in rows]),
        "rows": torch.tensor([r for _, rows, _, _ in kept for r in rows]),
        "pixels": torch.cat([im.float().cpu() for _, _, im, _ in kept]),
        "stages": [torch.cat([st[i].cpu() for _, _, _, st in kept])
                   for i in range(len(cfg["stages"]))],
    }
    del pipeline, taps, kept
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    record["readings"] = checks.cascade_readings(cfg, weights, checked,
                                                 device, control=ctx.control)
    record["reference_s"] = time.perf_counter() - t_ref
    record["checked_images"] = int(checked["seeds"].shape[0])
    return record
