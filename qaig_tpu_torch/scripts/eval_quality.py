"""Reconstruction quality over an image dataset (counterpart of
``scripts/eval_quality.py``).

Mean PSNR of (a) the autoencoder's reconstruction and (b) the
reconstruction through each given codebook (encoder -> BMU tokens ->
codebook lookup -> decoder), over a dataset.  Pixels are BGR in [-1, 1],
so the peak-to-peak value is 2.0.  Each image's PSNR is computed in
float64, averaged per batch, and the batches' means are averaged weighted
by their sizes, as ``qaig_tpu``'s tool does.

Images come through the port's ``ImageDataset`` and ``DataLoader`` (the
data plane's native batch decoder); the tokens through
``Codebook.get_patches_bmu``, which launches the BMU kernel on the card.
``--device cuda`` (the default) raises without a card.

    python -m qaig_tpu_torch.scripts.eval_quality --dataset-path d.json \\
        --model-path ae.pt [--codebook-path cb.pt ...] [--device cpu]

Prints one JSON line:
  {"num_images": N, "psnr_recon_db": ...,
   "psnr_quantized_db": {"<ckpt>": ...}}
"""

import argparse
import json
import pathlib

import numpy as np
import torch

from qaig_tpu_torch.data.image_dataset import ImageDataset
from qaig_tpu_torch.data.loader import DataLoader
from qaig_tpu_torch.train import common
from qaig_tpu_torch.utils.checkpoint import load_model


def psnr_db(clean, recon, peak=2.0):
    """Per-image PSNR, averaged; inputs (N, C, H, W) in [-1, 1]."""
    err = (np.asarray(clean, np.float64)
           - np.asarray(recon, np.float64)) ** 2
    mse = err.reshape(err.shape[0], -1).mean(axis=1)
    return float(np.mean(10.0 * np.log10(peak * peak
                                         / np.maximum(mse, 1e-12))))


def _host(x):
    return x.float().cpu().numpy()


@torch.inference_mode()
def evaluate(dataset_path, model_path, codebook_paths=(), batch_size=32,
             max_images=None, device="cuda"):
    """The PSNRs, unrounded: {"num_images", "psnr_recon_db",
    "psnr_quantized_db": {codebook path: dB}}."""
    device = common.select_device(device)
    status, ckpt = load_model(str(model_path))
    if not status:
        raise RuntimeError("Could not load autoencoder checkpoint!")
    ae, _ = common.autoencoder_from_checkpoint(ckpt, device)
    codebooks = []
    for path in codebook_paths:
        status, cb_ckpt = load_model(str(path))
        if not status:
            raise RuntimeError(f"Could not load codebook checkpoint {path}!")
        codebooks.append((str(path),
                          common.codebook_from_checkpoint(cb_ckpt, device)))

    loader = DataLoader(ImageDataset(str(dataset_path)),
                        batch_size=batch_size, shuffle=False,
                        drop_remainder=False)
    n_done = 0
    recon_psnrs, weights = [], []
    quant_psnrs = {name: [] for name, _ in codebooks}
    for batch in loader:
        if max_images is not None:
            batch = batch[:max(max_images - n_done, 0)]
            if batch.shape[0] == 0:
                break
        x = torch.from_numpy(batch).to(device)
        recon_psnrs.append(psnr_db(batch, _host(ae(x))))
        if codebooks:
            z = ae.get_latent(x)
            for name, cb in codebooks:
                tokens = cb.get_patches_bmu(z, reshape=True)
                recon = ae.recon_image(cb.get_quantized_image(tokens))
                quant_psnrs[name].append(psnr_db(batch, _host(recon)))
        weights.append(batch.shape[0])
        n_done += int(batch.shape[0])
        if max_images is not None and n_done >= max_images:
            break

    w = np.asarray(weights, np.float64)
    return {
        "num_images": n_done,
        "psnr_recon_db": float(np.average(recon_psnrs, weights=w)),
        "psnr_quantized_db": {name: float(np.average(vals, weights=w))
                              for name, vals in quant_psnrs.items()}}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Dataset-level reconstruction PSNR.")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--dataset-path", required=True, type=pathlib.Path)
    parser.add_argument("--model-path", required=True, type=pathlib.Path,
                        help="Autoencoder checkpoint.")
    parser.add_argument("--codebook-path", action="append", default=[],
                        type=pathlib.Path,
                        help="Codebook checkpoint(s); repeatable.  Each "
                             "adds a quantized-reconstruction PSNR.")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--max-images", type=int, default=None)
    args = parser.parse_args(argv)
    result = evaluate(args.dataset_path, args.model_path, args.codebook_path,
                      args.batch_size, args.max_images, args.device)
    print(json.dumps({
        "num_images": result["num_images"],
        "psnr_recon_db": round(result["psnr_recon_db"], 3),
        "psnr_quantized_db": {
            name: round(value, 3)
            for name, value in result["psnr_quantized_db"].items()}}))
    return result


if __name__ == "__main__":
    main()
