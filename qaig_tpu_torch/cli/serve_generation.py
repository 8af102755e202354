"""Serve cascade generation over HTTP (the port's counterpart of
``qaig_tpu/cli/serve_generation.py``, same flags and defaults):

    python -m qaig_tpu_torch.cli.serve_generation --config-path gen.json \
        --decoder-path ae.pt [--port 8000] [--bf16] [--warmup-batch 1] \
        [--device cuda] [--shard-batch] [--num-model-shards N]

Wraps :class:`qaig_tpu_torch.infer.pipeline.CascadePipeline` in
:class:`qaig_tpu_torch.serve.GenerationServer`; prints ``serving on
http://host:port`` once it accepts requests (``--port 0`` binds a free
port), and on SIGTERM or SIGINT drains every accepted request and exits 0
after ``drained; bye.``.

One process serves one card, or with ``--shard-batch`` /
``--num-model-shards N`` every visible card (one CPU device under
``--device cpu``) as a ``data x model`` mesh (``parallel/local.py``), as
``qaig_tpu`` serves every local chip: ``--shard-batch`` splits each
dispatch over ``data`` (dispatches padded to a multiple of it),
``--num-model-shards`` splits every stage MLP over ``model``.

Accepted for flag parity and refused with an error:
``--compilation-cache-dir`` and ``--compiler-options`` (XLA's, with no
counterpart in PyTorch).
"""

import argparse
import ctypes
import pathlib
import signal
import time

XLA_ONLY = "XLA-only: the port compiles nothing through XLA"


def one_malloc_arena():
    """One glibc malloc arena for the whole process (``M_ARENA_MAX`` 1),
    set before any thread starts.  glibc gives each new thread an arena of
    its own, and the dispatcher thread captures the CUDA graphs: a capture
    makes hundreds of thousands of small host allocations inside CUDA,
    which ran several times slower (most of it system time) in a thread's
    arena than in the main one.  Nothing to do where the C library is not
    glibc."""
    try:
        mallopt = ctypes.CDLL("libc.so.6").mallopt
    except (OSError, AttributeError):
        return
    mallopt(-8, 1)   # M_ARENA_MAX


def main(argv=None):
    parser = argparse.ArgumentParser(description="Serve image generation.")
    parser.add_argument("--device", choices=["cuda", "cpu"], type=str,
                        default="cuda",
                        help="cuda (the default) needs a visible GPU and "
                             "never falls back to the CPU.")
    parser.add_argument("--decoder-path", required=True, type=pathlib.Path)
    parser.add_argument("--config-path", required=True, type=pathlib.Path)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-batch", type=int, default=64)
    parser.add_argument("--bf16", action="store_true",
                        help="Serve in bfloat16 (the benchmark precision).")
    parser.add_argument("--shard-batch", action="store_true",
                        help="Shard each dispatch's image batch over all "
                             "visible cards (a replica of the weights on "
                             "each).  Dispatches are padded to a multiple "
                             "of the data axis.")
    parser.add_argument("--num-model-shards", type=int, default=1,
                        help="Tensor-parallel shards for each stage "
                             "transformer's MLPs (Megatron MLP sharding "
                             "over the cards of a data replica).  Implies a "
                             "mesh even without --shard-batch.")
    parser.add_argument("--use-ema", action="store_true",
                        help="Serve the EMA weights (model_ema, written by "
                             "training under --ema-decay).")
    parser.add_argument("--max-queue-rows", type=int, default=None,
                        help="Backpressure bound: reject (503) once this "
                             "many image rows wait in the dispatch queue "
                             "(default: 8 x max-batch; floor: max-batch so "
                             "any admissible request can queue on an idle "
                             "server).")
    parser.add_argument("--request-timeout", type=float, default=None,
                        help="Bound each request's queue wait in seconds "
                             "(504 on expiry; in-flight dispatches always "
                             "complete). Default: wait forever.")
    parser.add_argument("--warmup-batch", type=int, default=0,
                        help="Run the pipeline once at this batch size "
                             "before accepting traffic (0 = none); on "
                             "CUDA this captures the fused cascade's CUDA "
                             "graph for that batch, so a first request of "
                             "that size replays it.")
    parser.add_argument("--compilation-cache-dir", default=None,
                        type=pathlib.Path, help=f"XLA's cache: {XLA_ONLY}.")
    parser.add_argument("--compiler-options", default=None, type=str,
                        help=f"XLA's options: {XLA_ONLY}.")
    args = parser.parse_args(argv)
    refused = [flag for flag, used in (
        ("--compilation-cache-dir", args.compilation_cache_dir is not None),
        ("--compiler-options", args.compiler_options is not None)) if used]
    if refused:
        parser.error(f"{', '.join(refused)}: {XLA_ONLY}")

    if args.device == "cuda":
        one_malloc_arena()
    import torch
    from qaig_tpu_torch.infer.pipeline import CascadePipeline
    from qaig_tpu_torch.parallel.local import LocalMesh, local_devices
    from qaig_tpu_torch.serve import GenerationServer
    from qaig_tpu_torch.train import common

    device = common.select_device(args.device)
    mesh = None
    batch_multiple = 1
    n_model = max(1, args.num_model_shards)
    if args.shard_batch or n_model > 1:
        devices = local_devices(device)
        n_chips = len(devices)
        if n_chips % n_model != 0:
            raise SystemExit(f"--num-model-shards {n_model} must divide "
                             f"the chip count ({n_chips})")
        batch_multiple = n_chips // n_model if args.shard_batch else 1
        mesh = LocalMesh(n_data=batch_multiple, n_model=n_model,
                         devices=devices)
        print(f"serving over {n_chips} chips: data={batch_multiple} "
              f"x model={n_model}"
              + (f" (num_images must be a multiple of {batch_multiple})"
                 if batch_multiple > 1 else ""), flush=True)

    def build_pipeline():
        # re-read the config too, so a reload picks up both new checkpoint
        # bytes and updated checkpoint paths inside the same config file
        pipe = CascadePipeline.from_config(
            common.load_config(args.config_path), args.decoder_path,
            device=device, dtype=torch.bfloat16 if args.bf16 else None,
            use_ema=args.use_ema, mesh=mesh)
        if args.warmup_batch > 0:
            # also runs during POST /reload (old weights keep serving), so
            # the swapped-in pipeline never serves its first, slow call;
            # on CUDA that call captures the batch's graph (infer/graphs.py
            # serialises captures, so one made while the dispatcher
            # replays the old pipeline's graphs is safe); over a mesh the
            # batch is padded to the data axis, as a dispatch is, so every
            # replica runs (and captures) its block
            batch = -(-args.warmup_batch // batch_multiple) * batch_multiple
            pipe.generate(batch, seed=0)
            for replica in pipe.replicas:
                if replica.device.type == "cuda":
                    torch.cuda.synchronize(replica.device)
            print(f"warmed up at batch {args.warmup_batch}", flush=True)
        return pipe

    # no local keeps the startup pipeline alive: after POST /reload the
    # batcher holds the only reference, so the old weights free
    server = GenerationServer(build_pipeline(), host=args.host,
                              port=args.port, max_batch=args.max_batch,
                              batch_multiple=batch_multiple,
                              max_queue_rows=args.max_queue_rows,
                              request_timeout=args.request_timeout,
                              reloader=build_pipeline)
    print(f"serving on http://{args.host}:{server.port}", flush=True)

    # Graceful drain on SIGTERM/SIGINT: stop accepting, finish the in-flight
    # dispatch and everything already queued, exit 0.  The handler only
    # flips a flag (an Event.set() from a signal handler can deadlock
    # against a wait on the same thread); the sleep below wakes on it.
    stop = {"stop": False}

    def on_signal(*_):
        stop["stop"] = True

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, on_signal)
    server.start(background=True)
    while not stop["stop"]:
        time.sleep(0.2)
    print("shutting down: draining queued requests...", flush=True)
    server.stop()
    print("drained; bye.", flush=True)


if __name__ == "__main__":
    main()
