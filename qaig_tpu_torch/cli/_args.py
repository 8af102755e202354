"""Flags shared by the port's stage CLIs (counterpart of
``qaig_tpu/cli/_args.py``, without its XLA-only compilation-cache and
compiler-option flags)."""


def add_runtime_args(parser):
    """The multi-process runtime (``parallel/comm.py``)."""
    parser.add_argument(
        "--multihost", action="store_true",
        help="Join a torch.distributed process group (one process per "
             "card; gloo on the CPU).")
    parser.add_argument(
        "--coordinator-address", default=None, type=str,
        help="host:port of process 0 (or a file:// path every process "
             "sees); torchrun's environment when omitted.")
    parser.add_argument("--num-processes", default=None, type=int)
    parser.add_argument("--process-id", default=None, type=int)


def add_checkpoint_backend(parser):
    parser.add_argument(
        "--checkpoint-backend", choices=["pickle", "pickle-async"],
        default="pickle",
        help="pickle = reference-compatible single file; pickle-async = "
             "the same file, written by a background thread from a host "
             "snapshot (the training steps go on meanwhile).")
