"""Transformer training-step throughput on the card, flagship config
(counterpart of ``scripts/bench_train.py``).

    python -m qaig_tpu_torch.scripts.bench_train [--batch 64] [--steps 10]
        [--device cuda|cpu] [--scale full|smoke]

The flagship stage: the windowed encoder-decoder cascade stage (in_dim
512, hidden 2048, 5 encoder and 7 decoder layers, 8 heads, K 512, window
256, LR codebook of 4x4 patches and HR of 2x2 over a 32x32x4 latent),
through ``train/transformer.py::make_train_step`` (on the card one CUDA
graph a step: kernels A and A' for the self-attention, the BMU kernel for
the tokenization) at batch 64, bf16 and float32, with and without
activation recompute (``use_remat``).  ``qaig_tpu``'s ``use_flash`` switch
has no counterpart: on the card the self-attention is always kernel A.

Each configuration prints ``bench_train.py``'s text line (without its
``flash=`` field): ms a step and samples a second over ``--steps`` steps
after a warm one (the capture), host clock to a synchronise, and, on a
card of ``bench.py``'s peak table, TFLOP/s and the MFU against the card's
dense peak for the step's dtype.  The step's FLOPs are counted by
``FlopCounterMode`` over one step at batch 1 on the CPU
(:func:`train_step_flops`).  ``--device cpu --scale smoke`` runs a
tiny config eagerly (no MFU).
"""

import argparse
import functools
import time

import numpy as np
import torch

from qaig_tpu_torch import bench
from qaig_tpu_torch.models.codebook import Codebook
from qaig_tpu_torch.models.core import init_parameters
from qaig_tpu_torch.models.transformer import Transformer, TransformerConfig
from qaig_tpu_torch.train import common, optim
from qaig_tpu_torch.train.transformer import make_train_step

# (transformer widths, latent, LR / HR patch, K, window)
SCALES = {
    "full": dict(in_dim=512, hidden=2048, enc=5, dec=7, heads=8, k=512,
                 latent=(4, 32, 32), lr_patch=4, hr_patch=2, window=256),
    "smoke": dict(in_dim=32, hidden=64, enc=1, dec=2, heads=4, k=16,
                  latent=(2, 8, 8), lr_patch=4, hr_patch=2, window=8),
}


def flagship(scale, remat=False):
    s = SCALES[scale]
    return TransformerConfig(
        use_encoder=True, use_pos_cond=True, num_enc_layers=s["enc"],
        num_dec_layers=s["dec"], num_enc_embedding=s["k"],
        num_dec_embedding=s["k"] + 1, self_attn_heads=s["heads"],
        cross_attn_heads=s["heads"], in_dim=s["in_dim"],
        out_dim=s["k"] + 1, hidden_dim=s["hidden"],
        hidden_activation="silu", use_remat=remat)


@functools.lru_cache(maxsize=None)
def train_step_flops(scale, remat, batch):
    """Product FLOPs (2*m*n*k) of one ``make_train_step`` step of the
    flagship stage at ``batch``: ``torch.utils.flop_counter``'s count of
    one eager float32 step at batch 1 on the CPU (the BMU products of
    tokenizing both codebooks, the forward, the backward and, under
    ``use_remat``, the recompute; Adam adds none), times ``batch``.  bf16
    runs the same products, and each is linear in the batch
    (``tests/test_torch_port_tools.py`` holds that)."""
    from torch.utils.flop_counter import FlopCounterMode
    step, _ = build(scale, 1, remat, False, torch.device("cpu"))
    counter = FlopCounterMode(display=False)
    with counter:
        step(0)
    return batch * counter.get_total_flops()


def build(scale, batch, remat, bf16, device, seed=0):
    """(step(i) -> loss, model) of the flagship stage at ``batch``."""
    s = SCALES[scale]
    c, h, w = s["latent"]
    gen = torch.Generator().manual_seed(seed)
    lr_cb, hr_cb = (Codebook(patch_dim=(p, p), image_dim=(h, w),
                             image_channel=c, num_embeddings=s["k"],
                             init_neighbour_range=1).init(gen).to(device)
                    for p in (s["lr_patch"], s["hr_patch"]))
    cfg = flagship(scale, remat)
    model = init_parameters(Transformer(cfg), gen).to(device)
    optimizer, scheduler = optim.make_adam(model.parameters(), 1e-4, 50_000)
    step = make_train_step(model, optimizer, lr_cb, hr_cb, False, s["k"],
                           s["k"], sliding_window=s["window"], bf16=bf16,
                           scheduler=scheduler)
    rng = np.random.default_rng(seed + 3)
    fmap = torch.from_numpy(rng.standard_normal((batch, c, h, w)).astype(
        np.float32)).to(device)
    windows = torch.Generator().manual_seed(seed + 1)
    return (lambda i: step(fmap, windows)), model


def run(scale="full", batch=64, remat=False, bf16=False, device="cuda",
        steps=10):
    """One configuration's line (``scripts/bench_train.py``'s format)."""
    device = common.select_device(device)
    step, model = build(scale, batch, remat, bf16, device)
    loss = step(0)                                   # warm (the capture)
    float(loss)
    bench.synchronize([device])
    t0 = time.perf_counter()
    acc = torch.zeros((), device=device)
    for i in range(steps):
        acc = acc + step(i + 1)
    float(acc)
    bench.synchronize([device])
    dt = (time.perf_counter() - t0) / steps
    tag = f"remat={remat} batch={batch} bf16={bf16}"
    extra = ""
    dtype = torch.bfloat16 if bf16 else torch.float32
    peak, _ = bench.peak_flops(device, dtype)
    if peak:
        achieved = train_step_flops(scale, remat, batch) / dt
        extra = (f", {achieved / 1e12:.1f} TFLOP/s"
                 f" (mfu {achieved / peak:.3f} vs "
                 f"{'bf16' if bf16 else 'f32'} peak)")
    line = (f"{tag}: {dt * 1000:.1f} ms/step, "
            f"{batch / dt:.1f} samples/sec{extra}")
    print(line, flush=True)
    del model, step
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--scale", choices=["full", "smoke"], default="full")
    args = parser.parse_args(argv)
    if args.device == "cuda":
        common.select_device("cuda")
        print(f"card: {bench.card_line()}", flush=True)
    lines = []
    for bf16 in (True, False):
        for remat in (False, True):
            lines.append(run(args.scale, args.batch, remat, bf16,
                             args.device, args.steps))
    return lines


if __name__ == "__main__":
    main()
