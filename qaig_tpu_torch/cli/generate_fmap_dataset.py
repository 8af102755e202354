"""Generate the feature-map dataset on one GPU (the port's counterpart of
``qaig_tpu/cli/generate_fmap_dataset.py``, same flags and defaults):

    python -m qaig_tpu_torch.cli.generate_fmap_dataset \
        --dataset-path images.json --model-path ae.pt --out-dir fmaps \
        [--device cuda]

With ``--multihost`` (2-4 processes; see ``parallel/comm.py``) rank 0
writes and the others wait at a barrier.  Not part of the port: the
XLA-only ``--compiler-options`` and ``--compilation-cache-dir``.
"""

import argparse
import pathlib

from qaig_tpu_torch.cli._args import add_runtime_args


def main(argv=None):
    from qaig_tpu_torch.train import fmap

    parser = argparse.ArgumentParser(
        description="Generate Feature Maps Dataset.")
    parser.add_argument("--device", choices=["cuda", "cpu"], type=str,
                        default="cuda",
                        help="cuda (the default) needs a visible GPU and "
                             "never falls back to the CPU.")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--num-files-folder", type=int, default=1_000)
    parser.add_argument("--dataset-path", required=True, type=pathlib.Path)
    parser.add_argument("--model-path", required=True, type=pathlib.Path)
    add_runtime_args(parser)
    parser.add_argument("--out-dir", required=True, type=pathlib.Path)
    args = vars(parser.parse_args(argv))
    fmap.run(args)


if __name__ == "__main__":
    main()
