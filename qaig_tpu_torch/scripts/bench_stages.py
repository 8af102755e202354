"""Per-stage throughput of the pipeline's stages before the transformers,
on the card (counterpart of ``scripts/bench_stages.py``).

    python -m qaig_tpu_torch.scripts.bench_stages [--iters 10]
        [--ae-batch 32] [--fmap-batch 64] [--cb-batch 256]
        [--only ae|fmap|codebook] [--device cuda|cpu] [--scale full|smoke]

(a) the autoencoder's train step (``train/autoencoder.py::
make_train_step``: convolutions forward and backward, Adam; one CUDA graph
a step on the card) in float32 and bf16, at the reference README's shapes
(128x128x3 images, 256 -> 512 channels, latent 32x32x4); (b) feature-map
extraction, the encoder's forward as ``train/fmap.py`` runs it (eager,
inference mode); (c) the codebook's train step (``train/codebook.py::
make_train_step``: the BMU kernel, the Gaussian soft quantization, Adam;
graphed) at K 512 over 32x32x4 latents, patches 8x8 and 2x2.

Prints ONE JSON line, ``{"device_kind", "n_chips", "iters", "stages":
{...}}``, with ``bench_stages.py``'s keys: each stage's mean seconds a step
over ``--iters`` steps after a warm one (each step timed to a synchronise)
and its 95% CI, samples a second, and the MFU against the card's dense
peak for the stage's dtype (``bench.py``'s table; null elsewhere), from
FLOPs counted from shapes (:func:`conv_flops`, :func:`codebook_flops`: 2
per multiply-add of every convolution and product, forward and backward).
``--device cpu`` clamps the batches and iterations as ``bench_stages.py``
does on the CPU; ``--scale smoke`` shrinks the autoencoder's channels and
image (16x16 images, 8 -> 16 channels) for the CPU.
"""

import argparse
import json
import time

import numpy as np
import torch

from qaig_tpu_torch import bench
from qaig_tpu_torch.models.codebook import Codebook
from qaig_tpu_torch.models.conv_nets import (_decoder_channels,
                                             _encoder_channels)
from qaig_tpu_torch.models.core import init_parameters
from qaig_tpu_torch.train import autoencoder, codebook, common, optim

AE = {"full": dict(min_channel=256, max_channel=512, image=128,
                   latent_hw=32),
      "smoke": dict(min_channel=8, max_channel=16, image=16, latent_hw=4)}


def ae_config(scale):
    a = AE[scale]
    return {"model_lr": 1e-4, "image_channel": 3,
            "min_channel": a["min_channel"], "max_channel": a["max_channel"],
            "num_layers": 2, "latent_channel": 4,
            "hidden_activation_type": "silu",
            "use_final_enc_activation": True,
            "encoder_activation_type": "tanh",
            "use_final_dec_activation": True,
            "decoder_activation_type": "tanh"}


def conv_flops(cfg, n, side, train=False):
    """FLOPs of the autoencoder's convolutions over ``n`` images of
    ``side`` pixels: the encoder's (3x3, stride 2 on ``down``), with
    ``train`` also the decoder's (3x3, and 4x4 transposed ones counted at
    their input size) and the backward: a gradient for the weights of
    every convolution and for the input of all but the first (the images
    need none)."""
    f, first = 0, None
    h = side
    for cin, cout, kind in _encoder_channels(cfg.encoder_config()):
        if kind == "down":
            h //= 2
        layer = 2 * n * h * h * cin * cout * 9
        first = layer if first is None else first
        f += layer
    if not train:
        return f
    for cin, cout, kind in _decoder_channels(cfg.decoder_config()):
        f += 2 * n * h * h * cin * cout * (16 if kind == "up" else 9)
        if kind == "up":
            h *= 2
    return 3 * f - first


def codebook_flops(model, n):
    """A codebook step's products over ``n`` latents: the BMU search, the
    soft quantization (M x K x D) and its gradient for the codes."""
    m = n * model.seq_len
    return 6 * m * model.num_embeddings * model.embedding_dim


def _timed(step, inputs, iters, device):
    """(mean s, CI95 half-width s or None) of ``iters`` steps after a warm
    one, each timed to a synchronise."""
    float(step(*inputs(0)).float().sum())                # warm / capture
    times = []
    for i in range(iters):
        args = inputs(i + 1)
        bench.synchronize([device])
        t0 = time.perf_counter()
        out = step(*args)
        bench.synchronize([device])
        times.append(time.perf_counter() - t0)
        del out
    times = np.asarray(times)
    ci = bench.ci95_half_width(times)
    return float(times.mean()), (float(ci) if ci is not None else None)


def _mfu(flops, mean_t, device, dtype):
    peak, _ = bench.peak_flops(device, dtype)
    return round((flops / mean_t) / peak, 4) if peak else None


def bench_ae(batch, iters, bf16, device, scale="full"):
    """(a) the autoencoder's train step."""
    model, cfg = autoencoder.build_autoencoder(ae_config(scale))
    model = init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(device)
    optimizer, _ = optim.make_adam(model.parameters(), 1e-4)
    step = autoencoder.make_train_step(model, optimizer, bf16=bf16)
    side = AE[scale]["image"]
    rng = np.random.default_rng(0)
    batch_x = torch.from_numpy(rng.standard_normal(
        (batch, 3, side, side)).astype(np.float32)).to(device)
    mean_t, ci = _timed(step, lambda i: (batch_x,), iters, device)
    flops = conv_flops(cfg, batch, side, train=True)
    return {"step_time_mean_s": round(mean_t, 5),
            "step_time_ci95_s": round(ci, 5) if ci else None,
            "images_per_sec": round(batch / mean_t, 2),
            "batch": batch, "precision": "bf16" if bf16 else "fp32",
            "mfu": _mfu(flops, mean_t, device,
                        torch.bfloat16 if bf16 else torch.float32),
            "flops_per_step": flops}


def bench_fmap(batch, iters, device, scale="full"):
    """(b) the encoder's forward (feature-map extraction), images/s."""
    model, cfg = autoencoder.build_autoencoder(ae_config(scale))
    model = init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(device)
    side = AE[scale]["image"]
    rng = np.random.default_rng(0)
    batch_x = torch.from_numpy(rng.standard_normal(
        (batch, 3, side, side)).astype(np.float32)).to(device)

    @torch.inference_mode()
    def encode(x):
        return model.get_latent(x)
    mean_t, ci = _timed(encode, lambda i: (batch_x,), iters, device)
    flops = conv_flops(cfg, batch, side)
    return {"step_time_mean_s": round(mean_t, 5),
            "step_time_ci95_s": round(ci, 5) if ci else None,
            "images_per_sec": round(batch / mean_t, 2),
            "batch": batch,
            "mfu": _mfu(flops, mean_t, device, torch.float32),
            "flops_per_step": flops}


def bench_codebook(batch, iters, patch, device, scale="full"):
    """(c) the codebook's train step at K 512 over 32x32x4 latents (at
    ``--scale smoke`` the autoencoder's 4x4 latents), ``patch`` x
    ``patch`` patches."""
    hw = AE[scale]["latent_hw"] if scale == "smoke" else 32
    patch = min(patch, hw)
    model = Codebook(patch_dim=(patch, patch), image_dim=(hw, hw),
                     image_channel=4, num_embeddings=512,
                     init_neighbour_range=256).init(
        torch.Generator().manual_seed(0)).to(device)
    optimizer, _ = optim.make_adam(model.parameters(), 1e-4)
    step = codebook.make_train_step(model, optimizer)
    rng = np.random.default_rng(0)
    batch_x = torch.from_numpy(rng.standard_normal(
        (batch, 4, hw, hw)).astype(np.float32)).to(device)
    mean_t, ci = _timed(step, lambda i: (batch_x, 64.0), iters, device)
    flops = codebook_flops(model, batch)
    return {"step_time_mean_s": round(mean_t, 5),
            "step_time_ci95_s": round(ci, 5) if ci else None,
            "samples_per_sec": round(batch / mean_t, 2),
            "batch": batch, "patch": patch,
            "tokens_per_image": (hw // patch) ** 2,
            "mfu": _mfu(flops, mean_t, device, torch.float32),
            "flops_per_step": flops}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--ae-batch", type=int, default=32)
    parser.add_argument("--fmap-batch", type=int, default=64)
    parser.add_argument("--cb-batch", type=int, default=256)
    parser.add_argument("--only", choices=["ae", "fmap", "codebook"],
                        default=None)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--scale", choices=["full", "smoke"], default="full")
    args = parser.parse_args(argv)
    device = common.select_device(args.device)
    if device.type == "cpu":
        # keep CPU runs fast: tiny batches, same code path
        args.ae_batch = min(args.ae_batch, 2)
        args.fmap_batch = min(args.fmap_batch, 4)
        args.cb_batch = min(args.cb_batch, 8)
        args.iters = min(args.iters, 2)
    else:
        print(f"card: {bench.card_line()}", flush=True)

    stages = {}
    if args.only in (None, "ae"):
        stages["ae_train_fp32"] = bench_ae(args.ae_batch, args.iters, False,
                                           device, args.scale)
        stages["ae_train_bf16"] = bench_ae(args.ae_batch, args.iters, True,
                                           device, args.scale)
    if args.only in (None, "fmap"):
        stages["fmap_extract"] = bench_fmap(args.fmap_batch, args.iters,
                                            device, args.scale)
    if args.only in (None, "codebook"):
        stages["codebook_train_p8"] = bench_codebook(
            args.cb_batch, args.iters, 8, device, args.scale)
        stages["codebook_train_p2"] = bench_codebook(
            args.cb_batch, args.iters, 2, device, args.scale)
    _, kind = bench.peak_flops(device, torch.float32)
    line = {"device_kind": kind, "n_chips": 1, "iters": args.iters,
            "stages": stages}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
