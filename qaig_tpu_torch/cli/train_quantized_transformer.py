"""Train the quantized transformer on the GPU (the port's counterpart of
``qaig_tpu/cli/train_quantized_transformer.py``, same flags and defaults):

    python -m qaig_tpu_torch.cli.train_quantized_transformer \
        --dataset-path fmaps/all_dataset.json --decoder-path ae.pt \
        --lr-codebook-path lr.pt --hr-codebook-path hr.pt \
        --config-path tf.json --out-dir out [--device cuda] [--bf16]

With ``--multihost`` (one process per card, or gloo ranks on the CPU:
``parallel/comm.py``) the processes form a data x pipe x model mesh:
``--num-model-shards``, ``--num-pipeline-stages`` /
``--num-microbatches`` and ``--zero-opt`` as in ``qaig_tpu``;
``--checkpoint-backend`` takes ``pickle`` and ``pickle-async`` (``orbax``
imports JAX).  Not part of the port: the XLA-only ``--compiler-options``
and ``--compilation-cache-dir`` (eager PyTorch compiles nothing to
cache).
"""

import argparse
import pathlib

from qaig_tpu_torch.cli._args import add_checkpoint_backend, add_runtime_args


def restricted_float(x):
    try:
        x = float(x)
    except ValueError:
        raise argparse.ArgumentTypeError(
            "%r not a floating-point literal" % (x,))
    if x < 0.1:
        raise argparse.ArgumentTypeError("%r not in range > 0.1" % (x,))
    return x


def main(argv=None):
    from qaig_tpu_torch.train import transformer

    parser = argparse.ArgumentParser(
        description="Train Quantized Transformer models.")
    parser.add_argument("--device", choices=["cuda", "cpu"], type=str,
                        default="cuda",
                        help="cuda (the default) needs a visible GPU and "
                             "never falls back to the CPU.")
    parser.add_argument("--dataset-path", required=True, type=pathlib.Path)
    parser.add_argument("--train-base-model", action="store_true",
                        help="Train Base Model, Decoder-only.")
    parser.add_argument("--decoder-path", required=True, type=pathlib.Path)
    parser.add_argument("--lr-codebook-path", required=True,
                        type=pathlib.Path)
    parser.add_argument("--hr-codebook-path", required=True,
                        type=pathlib.Path)
    parser.add_argument("--model-path", default=None, type=pathlib.Path)
    parser.add_argument("--test-num-sample", type=int, default=25)
    parser.add_argument("--load-optim", action="store_true")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--temperature", type=restricted_float, default=1.0)
    parser.add_argument("--checkpoint-step", type=int, default=1_000)
    parser.add_argument("--lr-step", type=int, default=50_000)
    parser.add_argument("--max-epoch", type=int, default=1_000)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--use-activation-checkpoint", action="store_true",
                        help="Recompute each block's activations in the "
                             "backward (torch.utils.checkpoint).")
    parser.add_argument("--skip-preview", action="store_true",
                        help="Skip checkpoint-time AR image previews.")
    parser.add_argument("--bf16", action="store_true",
                        help="Mixed-precision training: bfloat16 compute, "
                             "float32 master weights/optimizer.")
    parser.add_argument("--debug-nans", action="store_true",
                        help="Anomaly detection in the backward "
                             "(torch.autograd.set_detect_anomaly): fail at "
                             "the op that produced a NaN.")
    parser.add_argument("--profile-dir", default=None, type=pathlib.Path,
                        help="Write a torch.profiler trace of a window of "
                             "steps here.")
    parser.add_argument("--profile-start", type=int, default=5)
    parser.add_argument("--profile-steps", type=int, default=5)
    parser.add_argument("--config-path", required=True, type=pathlib.Path)
    parser.add_argument("--log-every", type=int, default=1,
                        help="Sync loss to host every N steps (1 = "
                             "reference behavior).")
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="Accumulate gradients over N equal chunks of "
                             "the batch before one Adam update.")
    parser.add_argument("--auto-resume", action="store_true",
                        help="Fault recovery: continue from the newest "
                             "checkpoint in --out-dir (model + optimizer + "
                             "EMA + step counter); starts fresh when none "
                             "exists. Explicit --model-path wins.")
    parser.add_argument("--ema-decay", type=float, default=None,
                        help="Maintain an exponential-moving-average copy "
                             "of the weights, saved as model_ema.")
    parser.add_argument("--grad-clip", type=float, default=None,
                        help="Clip the gradient's global norm to this value "
                             "before each Adam update.")
    parser.add_argument("--keep-checkpoints", type=int, default=None,
                        help="Retention: keep only the N newest checkpoints "
                             "in --out-dir.")
    parser.add_argument("--num-model-shards", type=int, default=1,
                        help="Tensor-parallel shards over the mesh's model "
                             "axis (1 = pure data parallel).")
    parser.add_argument("--num-pipeline-stages", type=int, default=1,
                        help="Pipeline-parallel stages over the mesh's "
                             "pipe axis (GPipe over the decoder layers; 1 "
                             "= off; composes with --num-model-shards).")
    parser.add_argument("--zero-opt", action="store_true",
                        help="ZeRO-1: shard Adam moments over the data "
                             "axis (grads reduce-scatter, params "
                             "all-gather). Not combinable with "
                             "--num-pipeline-stages.")
    parser.add_argument("--num-microbatches", type=int, default=None,
                        help="Microbatches per step under "
                             "--num-pipeline-stages (default = the stage "
                             "count).")
    add_checkpoint_backend(parser)
    add_runtime_args(parser)
    parser.add_argument("--out-dir", required=True, type=pathlib.Path)
    args = vars(parser.parse_args(argv))
    transformer.run(args)


if __name__ == "__main__":
    main()
