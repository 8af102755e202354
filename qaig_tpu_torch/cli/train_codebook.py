"""Train a SOM codebook on one GPU (the port's counterpart of
``qaig_tpu/cli/train_codebook.py``, same flags and defaults):

    python -m qaig_tpu_torch.cli.train_codebook \
        --dataset-path fmaps/all_dataset.json --decoder-path ae.pt \
        -c codebook.json --out-dir out [--device cuda]

With ``--multihost`` the processes train data-parallel;
``--checkpoint-backend`` takes ``pickle`` and ``pickle-async`` (``orbax``
imports JAX).  Not part of the port: the XLA-only ``--compiler-options``
and ``--compilation-cache-dir``.
"""

import argparse
import pathlib

from qaig_tpu_torch.cli._args import add_checkpoint_backend, add_runtime_args


def main(argv=None):
    from qaig_tpu_torch.train import codebook

    parser = argparse.ArgumentParser(description="Train Codebook.")
    parser.add_argument("--device", choices=["cuda", "cpu"], type=str,
                        default="cuda",
                        help="cuda (the default) needs a visible GPU and "
                             "never falls back to the CPU.")
    parser.add_argument("--dataset-path", required=True, type=pathlib.Path)
    parser.add_argument("--decoder-path", required=True, type=pathlib.Path)
    parser.add_argument("--codebook-path", required=False, type=pathlib.Path)
    parser.add_argument("--auto-resume", action="store_true",
                        help="Fault recovery: continue from the newest "
                             "codebook checkpoint in --out-dir (weights + "
                             "neighbourhood range + step counter); starts "
                             "fresh when none exists. Explicit "
                             "--codebook-path wins.")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--checkpoint-step", type=int, default=1_000)
    parser.add_argument("--lr-step", type=int, default=100_000)
    parser.add_argument("--max-epoch", type=int, default=1_000)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--debug-nans", action="store_true",
                        help="Anomaly detection in the backward "
                             "(torch.autograd.set_detect_anomaly): fail at "
                             "the op that produced a NaN.")
    parser.add_argument("--profile-dir", default=None, type=pathlib.Path,
                        help="Write a torch.profiler trace of a window of "
                             "steps here.")
    parser.add_argument("--profile-start", type=int, default=5)
    parser.add_argument("--profile-steps", type=int, default=5)
    parser.add_argument("-c", "--config-path", required=True,
                        type=pathlib.Path)
    parser.add_argument("--log-every", type=int, default=1,
                        help="Sync loss to host every N steps (1 = "
                             "reference behavior).")
    parser.add_argument("--keep-checkpoints", type=int, default=None,
                        help="Retention: keep only the N newest checkpoints "
                             "in --out-dir.")
    parser.add_argument("--num-model-shards", type=int, default=1,
                        help="Shapes the mesh (its data axis shrinks); the "
                             "codebook stays replicated.")
    add_checkpoint_backend(parser)
    add_runtime_args(parser)
    parser.add_argument("--out-dir", required=True, type=pathlib.Path)
    args = vars(parser.parse_args(argv))
    codebook.run(args)


if __name__ == "__main__":
    main()
