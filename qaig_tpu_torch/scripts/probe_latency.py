"""Batch-1 interactive latency on the card, fused against dispatched
(counterpart of ``scripts/probe_latency.py``).

    python -m qaig_tpu_torch.scripts.probe_latency [--iters 5]
        [--scale full|smoke] [--device cuda|cpu] [--skip-dispatched]

On ``CascadePipeline`` over ``bench.py``'s cascade
(``qaig_tpu_torch/bench.py::build_cascade``, bf16, seeded weights):

  - ``fused``: a 1-image request, the whole cascade from one CUDA graph
    (``CascadePipeline.generate``, row-keyed);
  - ``fused_stageK``: each stage alone at batch 1
    (``CascadePipeline.stage_tokens``), each its own graph, conditioned
    on the previous stage's real tokens;
  - ``fused_b8``: the fused cascade at batch 8, and per image;
  - ``dispatched``: the same 1-image request through the step-by-step loop
    (unless ``--skip-dispatched``).

Each figure is the mean of ``--iters`` calls (``--iters // 2`` dispatched)
after a warm one (the capture), each to a synchronise, host clock.  Prints
one JSON line with ``probe_latency.py``'s keys, in seconds.  On the CPU
(``--device cpu``) the fused forms run eagerly.
"""

import argparse
import json
import time

import torch

from qaig_tpu_torch import bench
from qaig_tpu_torch.infer.pipeline import derive_row_keys
from qaig_tpu_torch.scripts.profile_rollout import graphed
from qaig_tpu_torch.train import common


def timed(fn, iters, device):
    """Mean seconds of ``iters`` calls after a warm one, each to a
    synchronise."""
    fn()
    bench.synchronize([device])
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        bench.synchronize([device])
    return (time.perf_counter() - t0) / iters


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--scale", choices=["full", "smoke"], default="full")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--skip-dispatched", action="store_true",
                        help="skip the slow step-by-step baseline")
    args = parser.parse_args(argv)
    device = common.select_device(args.device)
    if device.type == "cuda":
        print(f"card: {bench.card_line()}", flush=True)
    stages_raw, decoder = bench.build_cascade(args.scale, device=device)
    pipeline = bench.pipeline_of(stages_raw, decoder, device)
    _, kind = bench.peak_flops(device, torch.bfloat16)
    out = {"device": kind, "iters": args.iters}

    # whole-cascade fused, batch 1 (the interactive path)
    out["fused_s"] = round(timed(
        lambda: pipeline.generate(1, seed=0, fused=True), args.iters,
        device), 4)

    # each stage alone at batch 1, each its own graph, on the real tokens
    # (CascadePipeline.stage_tokens, as generate runs it)
    call = graphed(device)
    row_keys = derive_row_keys(0, 1).to(device)
    tokens = None
    with torch.inference_mode():
        for k in range(len(pipeline.stages)):
            def fn(keys, prev=None, k=k):
                return pipeline.stage_tokens(k, prev, 1, row_keys=keys)
            inputs = (row_keys,) if k == 0 else (row_keys, tokens)

            def stage(fn=fn, inputs=inputs, k=k):
                return call(("stage", k), fn, inputs)
            out[f"fused_stage{k}_s"] = round(timed(stage, args.iters,
                                                   device), 4)
            tokens = stage()

    # batch 8, per image: fixed sequential-decode time against 1-row waste
    out["fused_b8_s"] = round(timed(
        lambda: pipeline.generate(8, seed=0, fused=True), args.iters,
        device), 4)
    out["fused_b8_per_image_s"] = round(out["fused_b8_s"] / 8, 4)

    if not args.skip_dispatched:
        out["dispatched_s"] = round(timed(
            lambda: pipeline.generate(1, seed=0, fused=False),
            max(1, args.iters // 2), device), 4)
        out["speedup_fused_vs_dispatched"] = round(
            out["dispatched_s"] / out["fused_s"], 2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
