"""Codebook pruning stage (counterpart of ``qaig_tpu/train/prune.py``).

Count how often each code is the BMU over the whole feature-map dataset
(the BMU kernel on the card, ``torch.bincount`` summed on the device; the
last partial batch is kept, so the kernel sees any number of rows), keep
the codes used at least ``prune_threshold`` times, copy their rows into a
smaller codebook and save it as ``pruned_codebook.pt``.

A single-writer stage, as the feature-map stage: under ``--multihost``
rank 0 counts and writes, the other ranks wait at a barrier that rank 0
reaches from a ``finally``.  ``--checkpoint-backend pickle-async`` writes
in the background and is joined before the stage returns.
"""

import numpy as np
import torch

from qaig_tpu_torch.data.fmap_dataset import FeatureMapDataset
from qaig_tpu_torch.data.loader import DataLoader
from qaig_tpu_torch.models.codebook import Codebook
from qaig_tpu_torch.train import common
from qaig_tpu_torch.train.codebook import checkpoint_dict
from qaig_tpu_torch.utils.checkpoint import save_model, wait_pending_saves
from qaig_tpu_torch.utils.logging_utils import setup_logging

PROJECT_NAME = "Prune Codebook"


@torch.inference_mode()
def usage_histogram(model, loader):
    """(K,) int64 numpy: each code's BMU count over ``loader``."""
    k = model.num_embeddings
    device = model.codebook.device
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    for feature_map in loader:
        bmu = model.get_patches_bmu(torch.from_numpy(feature_map).to(device))
        counts += torch.bincount(bmu, minlength=k)
    return counts.cpu().numpy()


def prune(model, counts, prune_threshold, logging=print):
    """A codebook of the codes counted at least ``prune_threshold`` times,
    in their order; every count is logged."""
    keep = np.nonzero(counts >= prune_threshold)[0]
    for i, count in enumerate(counts):
        logging(f"{i}: {count:,}")
    logging(f"Saved embeddings: {len(keep)}")
    new_model = Codebook(
        patch_dim=model.patch_dim, image_dim=model.image_dim,
        image_channel=model.image_channel, num_embeddings=len(keep),
        init_neighbour_range=model.neighbourhood_range,
        device=model.codebook.device)
    with torch.no_grad():
        new_model.codebook.copy_(model.codebook[torch.from_numpy(keep).to(
            model.codebook.device)])
    return new_model


def run(args):
    """Prune the codebook of ``args`` (the CLI flags, a dict); returns the
    pruned codebook (None on ranks other than 0).  ``device`` defaults to
    ``cuda``."""
    device = common.select_device(args.get("device") or "cuda")
    device = common.maybe_init_distributed(args, device)
    out_dir = common.ensure_dir(args["out_dir"])
    if not common.is_main_process():
        common.single_writer_barrier()
        return None
    try:
        return _run_writer(args, device, out_dir)
    finally:
        common.single_writer_barrier()


def _run_writer(args, device, out_dir):
    log = setup_logging(out_dir, PROJECT_NAME)

    cb_ckpt = common.load_checkpoint(args["codebook_path"], "codebook", log)
    model = common.codebook_from_checkpoint(cb_ckpt, device, logging=log.info)
    global_steps = cb_ckpt.get("global_steps", 0)

    log.info(PROJECT_NAME)
    log.info(f"Output Dir: {out_dir}")
    log.info(f"Device: {device}")
    log.info("#" * 100)
    log.info("Codebook Parameters.")
    log.info(f"Image dim: {model.image_dim}")
    log.info(f"Image channel: {model.image_channel:,}")
    log.info(f"Patch size: {model.patch_dim}")
    log.info(f"Num Embeddings: {model.num_embeddings:,}")
    log.info(f"Neighbourhood range: {model.neighbourhood_range:,}")
    log.info("#" * 100)

    dataset = FeatureMapDataset(args["dataset_path"])
    loader = DataLoader(dataset, batch_size=args.get("batch_size", 8),
                        shuffle=True, seed=args.get("seed", 0),
                        drop_remainder=False)
    counts = usage_histogram(model, loader)
    new_model = prune(model, counts, args.get("prune_threshold", 10),
                      logging=log.info)
    save_status = save_model(checkpoint_dict(new_model, global_steps),
                             dest_path=out_dir,
                             file_name="pruned_codebook.pt", logging=log.info,
                             backend=args.get("checkpoint_backend")
                             or "pickle")
    if not wait_pending_saves(logging=log.info):
        save_status = False
    log.info("Successfully saved codebook." if save_status
             else "Error occured saving codebook.")
    return new_model
