"""Serving, open loop: requests arrive on a Poisson schedule at a rate
fixed in the traffic file and go to a ``RequestBatcher`` over the
``CascadePipeline`` (in process, below HTTP), which coalesces them into
padded dispatches.  Each request is timed from its due time to the
return of its last image; one refused, failed or unanswered a minute
after the window counts as infinitely late.

The schedule is the same for every seed: ``rate * seconds`` gaps drawn
from ``schedule_seed`` and ``sizes`` in their stated shares, put in an
order drawn from ``schedule_seed`` too, so that every run offers the same
work at the same times.  The run's seed draws what the requests sample
(each request a seed of its own) and which of them are checked.

Traffic parameters: ``rate`` (requests a second), ``sizes`` ([[images,
share], ...]), ``max_batch``, ``warm_batches`` (each bucket, warmed twice
through the batcher before the window), ``threads`` (callers),
``check_requests`` (requests checked against the reference, drawn from
the seed, a quarter of them of the largest size), ``trace_seconds`` (the
traced slice, served after the window at the same rate), ``schedule_seed``.
"""

import gc
import math
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark import checks, system
from benchmark import trace as tr


def schedule(traffic, seed, seconds):
    """[(due seconds, images, request seed)] of one run."""
    count = max(1, round(traffic["rate"] * seconds))
    base = random.Random(traffic["schedule_seed"])
    gaps = [base.expovariate(traffic["rate"]) for _ in range(count)]
    scale = seconds * count / (count + 1) / sum(gaps)
    sizes = []
    for size, share in traffic["sizes"]:
        sizes += [size] * round(share * count)
    sizes = (sizes + [traffic["sizes"][0][0]] * count)[:count]
    base.shuffle(sizes)
    due, t = [], 0.0
    for gap in gaps:
        t += gap * scale
        due.append(t)
    return [(d, s, int(seed) * (1 << 20) + i)
            for i, (d, s) in enumerate(zip(due, sizes))]


def serve(batcher, requests, threads, wait=60.0):
    """Offer ``requests`` on their schedule; returns [(latency, images,
    tokens, lateness)] in their order (latency inf, images None for one
    that failed or never came)."""
    results = [None] * len(requests)
    done = threading.Semaphore(0)

    def call(i, due_at, num, seed):
        lateness = time.perf_counter() - due_at
        try:
            images, tokens = batcher.submit(num, seed)
            results[i] = (time.perf_counter() - due_at, images, tokens,
                          lateness)
        except Exception:   # a refusal counts as missing
            results[i] = (math.inf, None, None, lateness)
        done.release()

    pool = ThreadPoolExecutor(max_workers=threads)
    t0 = time.perf_counter()
    futures = []
    for i, (due, num, seed) in enumerate(requests):
        delay = t0 + due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        futures.append(pool.submit(call, i, t0 + due, num, seed))
    end = time.perf_counter() + wait
    for _ in requests:
        if not done.acquire(timeout=max(0.0, end - time.perf_counter())):
            break
    pool.shutdown(wait=False, cancel_futures=True)
    for f in futures:
        if f.done() and not f.cancelled():
            f.result()      # raises what a caller thread did not catch
    return [r if r is not None else (math.inf, None, None, math.nan)
            for r in results]


def counters(snapshot):
    by = snapshot["dispatches_by_batch"]
    return {"dispatches": snapshot["dispatches_total"],
            "padded": snapshot["padded_rows_total"],
            "dispatched": sum(int(size) * e["count"]
                              for size, e in by.items()),
            "rejected": snapshot["rejected_total"],
            "served": snapshot["served_requests_total"],
            "queue_wait_s": snapshot["queue_wait_seconds_total"]}


class Server:
    """The system under test of a serving run: the pipeline, its batcher,
    and a record of every dispatch's row keys and earlier stages' tokens
    (the reference's conditioning)."""

    def __init__(self, ctx):
        from qaig_tpu_torch.serve import RequestBatcher
        cfg, traffic = ctx.config, ctx.traffic
        self.pipeline, self.weights, taps = system.build_cascade(
            cfg, ctx.seed, ctx.device)
        self.dispatches = []
        generate = self.pipeline.generate

        def recording(num_images, seed=0, init_tokens=None,
                      temperature=None, row_keys=None, fused=None):
            images, tokens = generate(num_images, seed=seed,
                                      init_tokens=init_tokens,
                                      temperature=temperature,
                                      row_keys=row_keys, fused=fused)
            rows = torch.arange(num_images, device=tokens.device)
            staged = taps.tokens(num_images, rows)
            if staged is not None:
                self.dispatches.append((torch.as_tensor(row_keys).clone(),
                                        staged[:-1]))
            return images, tokens

        self.pipeline.generate = recording
        self.batcher = RequestBatcher(self.pipeline,
                                      max_batch=traffic["max_batch"])
        for k, size in enumerate(traffic["warm_batches"] * 2):
            self.batcher.submit(size, (1 << 62) + k)
        if ctx.device.startswith("cuda"):
            torch.cuda.synchronize(ctx.device)
            torch.cuda.reset_peak_memory_stats(ctx.device)
        self.dispatches.clear()

    def window(self, requests, threads):
        """Serve ``requests``; (results, window seconds, counter deltas)."""
        before = counters(self.batcher.metrics())
        t_start = time.perf_counter()
        results = serve(self.batcher, requests, threads)
        window_s = time.perf_counter() - t_start
        after = counters(self.batcher.metrics())
        delta = {k: after[k] - before[k] for k in after}
        delta["rows"] = delta["dispatched"] - delta["padded"]
        return results, window_s, delta

    def close(self):
        self.batcher.stop()


def run(ctx):
    cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
    server = Server(ctx)
    try:
        requests = schedule(traffic, ctx.seed, ctx.seconds)
        setup_s = time.perf_counter() - ctx.t0
        results, window_s, delta = server.window(requests,
                                                 traffic["threads"])
        record = {
            "setup_s": setup_s, "window_s": window_s,
            "latencies": [r[0] for r in results],
            "lateness_max_s": max((r[3] for r in results
                                   if not math.isnan(r[3])), default=0.0),
            "attempted": len(requests),
            "failed": sum(1 for r in results if r[1] is None),
            "serve_counters": delta,
            "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.startswith("cuda") else 0),
            "graph_setup_s": system.graph_setup_seconds(
                server.pipeline._graphs)}
        checked = _checked(traffic, ctx.seed, requests, results,
                           server.dispatches, len(cfg["stages"]))
        if ctx.trace:
            sliced = schedule(traffic, ctx.seed + 1,
                              traffic["trace_seconds"])
            _, record["trace"] = tr.profile(
                lambda: serve(server.batcher, sliced, traffic["threads"]),
                device)
    finally:
        server.close()
    weights = server.weights
    del server
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    record["complete"] = checked is not None
    record["readings"] = {}
    if checked is not None:
        t_ref = time.perf_counter()
        record["readings"] = checks.cascade_readings(
            cfg, weights, checked, device, control=ctx.control)
        record["reference_s"] = time.perf_counter() - t_ref
        record["checked_images"] = int(checked["seeds"].shape[0])
    return record


def _checked(traffic, seed, requests, results, dispatches, n_stages):
    """The checked requests' rows, drawn from the seed among those
    answered (a quarter of them of the largest size), with the tokens of
    every stage (the earlier stages from the dispatch that served them),
    or None where a request's rows are in no dispatch."""
    rng = random.Random(seed)
    answered = [i for i, r in enumerate(results) if r[1] is not None]
    largest = max(s for s, _ in traffic["sizes"])
    big = [i for i in answered if requests[i][1] == largest]
    small = [i for i in answered if requests[i][1] != largest]
    want = traffic["check_requests"]
    picked = (rng.sample(big, min(len(big), max(1, want // 4)))
              if big else [])
    picked += rng.sample(small, min(len(small), want - len(picked)))
    from benchmark import reference as ref
    seeds, rows, pixels, finals = [], [], [], []
    stages = [[] for _ in range(n_stages - 1)]
    for i in sorted(picked):
        _, num, req_seed = requests[i]
        _, images, tokens, _ = results[i]
        keys = ref.request_keys(req_seed, num)
        where = None
        for row_keys, taps in dispatches:
            match = (row_keys[:, None, :] == keys[None]).all(-1)
            hit = match.any(0)
            if bool(hit.all()):
                where = (match.int().argmax(0), taps)
                break
        if where is None:
            return None
        idx, taps = where
        for s in range(n_stages - 1):
            stages[s].append(taps[s].index_select(
                0, idx.to(taps[s].device)).cpu())
        seeds += [req_seed] * num
        rows += list(range(num))
        pixels.append(torch.from_numpy(np.asarray(images, np.float32)))
        finals.append(torch.from_numpy(np.asarray(tokens)))
    return {"seeds": torch.tensor(seeds), "rows": torch.tensor(rows),
            "pixels": torch.cat(pixels),
            "stages": [torch.cat(s) for s in stages] + [torch.cat(finals)]}
