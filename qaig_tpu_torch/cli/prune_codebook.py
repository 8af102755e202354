"""Prune under-used codebook entries on one GPU (the port's counterpart of
``qaig_tpu/cli/prune_codebook.py``, same flags and defaults):

    python -m qaig_tpu_torch.cli.prune_codebook \
        --dataset-path fmaps/all_dataset.json --codebook-path cb.pt \
        --out-dir out [--device cuda]

With ``--multihost`` rank 0 writes and the others wait at a barrier;
``--checkpoint-backend`` takes ``pickle`` and ``pickle-async`` (``orbax``
imports JAX).  Not part of the port: the XLA-only ``--compiler-options``
and ``--compilation-cache-dir``.
"""

import argparse
import pathlib

from qaig_tpu_torch.cli._args import add_checkpoint_backend, add_runtime_args


def main(argv=None):
    from qaig_tpu_torch.train import prune

    parser = argparse.ArgumentParser(description="Train Prune Codebook.")
    parser.add_argument("--device", choices=["cuda", "cpu"], type=str,
                        default="cuda",
                        help="cuda (the default) needs a visible GPU and "
                             "never falls back to the CPU.")
    parser.add_argument("--dataset-path", required=True, type=pathlib.Path)
    parser.add_argument("--codebook-path", required=True, type=pathlib.Path)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--prune-threshold", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    add_checkpoint_backend(parser)
    add_runtime_args(parser)
    parser.add_argument("--out-dir", required=True, type=pathlib.Path)
    args = vars(parser.parse_args(argv))
    prune.run(args)


if __name__ == "__main__":
    main()
