"""A bounded slice of a run under ``torch.profiler``, reduced to what the
per-layer readers need: the device's busy seconds (the union of its
kernels' intervals), the slice's length on the host clock, the device's
span (first kernel's start to last kernel's end), each kernel
name's count and device seconds, the ten device operations that took most
time and the ten longest idle gaps, each named by the innermost host-side
event under way when it began.

The raw records are read from the profiler's Kineto results, which stay
fast over the hundreds of thousands of kernels a cascade call replays.
"""

import bisect
import time

import torch


def _raw_events(prof):
    """[(is_device, name, start_us, end_us)] of every record."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        start = e.start_ns() / 1e3
        out.append((dev, e.name(), start, start + e.duration_ns() / 1e3))
    return out


def _is_kernel(name):
    """Device records that are work (kernels, copies and sets), not the
    runtime's markers."""
    return not name.startswith(("cudaDevice", "cudaStream", "cudaEvent"))


def profile(fn, device):
    """Run ``fn()`` under the profiler, synchronised at both ends; returns
    (fn's value, summary dict)."""
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        value = fn()
        if cuda:
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    return value, summarize(_raw_events(prof), window_s)


def summarize(events, window_s):
    kernels = sorted((s, e, n) for dev, n, s, e in events
                     if dev and _is_kernel(n))
    host = sorted((s, e, n) for dev, n, s, e in events if not dev)
    by_name = {}
    for s, e, n in kernels:
        count, secs = by_name.get(n, (0, 0.0))
        by_name[n] = (count + 1, secs + (e - s) / 1e6)
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, _ in kernels:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((s - cur_e, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    gaps.sort(reverse=True)
    starts = [h[0] for h in host]
    idle = []
    for length, at in gaps[:10]:
        label = "none"
        best = None
        for i in range(bisect.bisect_right(starts, at) - 1, -1, -1):
            s, e, n = host[i]
            if e >= at and (best is None or s > best):
                best, label = s, n
            if at - s > 5e6:      # nothing older than 5 s still open
                break
        idle.append([label, length / 1e6])
    ops = sorted(([n, secs] for n, (_, secs) in by_name.items()),
                 key=lambda x: -x[1])[:10]
    span_us = (max(e for _, e, _ in kernels) - kernels[0][0]
               if kernels else 0.0)
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "span_s": span_us / 1e6,
            "kernels": by_name,
            "n_kernels": sum(c for c, _ in by_name.values()),
            "breakdown": {"device_ops": ops, "idle_gaps": idle}}


def kernel_seconds(summary, patterns):
    """Device seconds of the kernels whose names hold any of
    ``patterns``, and their count."""
    secs, count = 0.0, 0
    for name, (c, s) in summary["kernels"].items():
        if any(p in name for p in patterns):
            secs += s
            count += c
    return secs, count
