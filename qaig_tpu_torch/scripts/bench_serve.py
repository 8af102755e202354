"""Serving concurrency on the card: coalesced against serial dispatch
(counterpart of ``scripts/bench_serve.py``).

    python -m qaig_tpu_torch.scripts.bench_serve [--n-requests 8]
        [--scale full|smoke] [--device cuda|cpu]

What the port's ``serve.RequestBatcher`` buys: N concurrent 1-image
requests served as ONE padded cascade dispatch against N solo dispatches
one after the other, on ``CascadePipeline`` over ``bench.py``'s cascade
(``qaig_tpu_torch/bench.py::build_cascade``, bf16, seeded weights; fused,
one CUDA graph a batch size on the card) and the real batcher: the product
path without HTTP.  The two batch sizes the measurement uses (1 and the
bucket of N) are captured first.

Prints one JSON line with ``bench_serve.py``'s keys: ``serial_s``,
``coalesced_s``, ``speedup``, ``n_requests``,
``images_per_sec_coalesced``.
"""

import argparse
import json
import time

from qaig_tpu_torch import bench
from qaig_tpu_torch.serve import RequestBatcher
from qaig_tpu_torch.train import common


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n-requests", type=int, default=8)
    parser.add_argument("--scale", choices=["full", "smoke"], default="full")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    device = common.select_device(args.device)
    if device.type == "cuda":
        print(f"card: {bench.card_line()}", flush=True)
    stages, decoder = bench.build_cascade(args.scale, device=device)
    pipeline = bench.pipeline_of(stages, decoder, device)
    batcher = RequestBatcher(pipeline, max_batch=64, batch_multiple=1)
    try:
        n = args.n_requests
        # the two programs the measurement uses: the solo batch and the
        # coalesced bucket of n
        pipeline.generate(1, seed=0)
        pipeline.generate(batcher._bucket(n), seed=0)
        bench.synchronize([device])

        # serial: one request at a time
        t0 = time.perf_counter()
        for i in range(n):
            batcher.submit(1, seed=i)
        serial_s = time.perf_counter() - t0

        # concurrent: all n enqueued under the batcher's lock (what n
        # racing clients converge to once the card is busy), drained as
        # ONE padded batch
        items = [batcher._request(1, i, None) for i in range(n)]
        t0 = time.perf_counter()
        with batcher._cv:
            batcher._pending.extend(items)
            batcher._cv.notify()
        for item in items:
            item["event"].wait()
        coalesced_s = time.perf_counter() - t0
        for item in items:
            if item["error"] is not None:
                raise item["error"]
            if item["result"][0].shape[0] != 1:
                raise RuntimeError("a coalesced request got "
                                   f"{item['result'][0].shape[0]} images")
    finally:
        batcher.stop()
    line = {
        "serial_s": round(serial_s, 4),
        "coalesced_s": round(coalesced_s, 4),
        "speedup": round(serial_s / coalesced_s, 2),
        "n_requests": n,
        "images_per_sec_coalesced": round(n / coalesced_s, 2),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
