"""Generate images through the transformer cascade on the GPU (the port's
counterpart of ``qaig_tpu/cli/generate_images.py``).

    python -m qaig_tpu_torch.cli.generate_images --config-path gen.json \
        --decoder-path ae.pt --out-dir out [--device cuda] [--bf16] \
        [--fused | --no-fused] [--profile-dir trace]
"""

import argparse
import pathlib

from qaig_tpu_torch.cli._args import add_runtime_args

from qaig_tpu_torch.infer import generate


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate Images.")
    parser.add_argument("--device", choices=["cuda", "cpu"], type=str,
                        default="cuda",
                        help="cuda (the default) needs a visible GPU and "
                             "never falls back to the CPU.")
    parser.add_argument("--decoder-path", required=True, type=pathlib.Path)
    parser.add_argument("--num-images", type=int, default=25)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--config-path", required=True, type=pathlib.Path)
    parser.add_argument("--bf16", action="store_true",
                        help="Serving precision: run the cascade in bfloat16 "
                             "(fp32 reference numerics stay the default).")
    parser.add_argument("--use-ema", action="store_true",
                        help="Generate with the EMA weights (model_ema); "
                             "falls back to live weights with a log line.")
    parser.add_argument("--profile-dir", default=None, type=pathlib.Path,
                        help="Write a torch.profiler trace of the whole "
                             "generation here (trace_0.json).")
    fused = parser.add_mutually_exclusive_group()
    fused.add_argument("--fused", dest="fused", action="store_true",
                       default=None,
                       help="Run the whole cascade as one function (on "
                            "CUDA one CUDA graph a data replica, captured "
                            "then replayed; the default on CUDA; refused "
                            "with --num-model-shards > 1 or --multihost).")
    fused.add_argument("--no-fused", dest="fused", action="store_false",
                       help="Run the dispatched per-step loop (the default "
                            "on the CPU).")
    parser.add_argument("--num-model-shards", type=int, default=1,
                        help="Tensor-parallel shards for each stage "
                             "transformer's weights (Megatron MLP sharding "
                             "over the mesh's model axis).")
    add_runtime_args(parser)
    parser.add_argument("--out-dir", required=True, type=pathlib.Path)
    args = vars(parser.parse_args(argv))
    generate.run(args)


if __name__ == "__main__":
    main()
