"""Feature-map dataset generation stage (counterpart of
``qaig_tpu/train/fmap.py``).

Run the autoencoder checkpoint's FC encoder over the image dataset, write
each latent as a raw ``np.save`` file named by its running index (no
extension) into numbered folders of ``num_files_folder`` files, and write
a TinyDB-format ``all_dataset.json`` manifest of {fmap_path, image_path}
rows.  The loader shuffles with the seed and keeps the last partial batch,
so the manifest lists the same files in the same order as ``qaig_tpu``'s.

The reference quirk is kept: the encoder's final activation is switched by
the checkpoint's ``use_final_dec_activation`` key.

A single-writer stage: under ``--multihost`` rank 0 encodes and writes
(the latents and the manifest are one namespace); the other ranks wait at
a barrier, which rank 0 reaches from a ``finally``, so every rank returns
after the manifest is written, or after the writer failed.
"""

import os

import numpy as np
import torch

from qaig_tpu_torch.data.image_dataset import ImageDataset
from qaig_tpu_torch.data.loader import DataLoader
from qaig_tpu_torch.data.manifest import write_manifest
from qaig_tpu_torch.models.conv_nets import ConvNetConfig, FCEncoder
from qaig_tpu_torch.train import common
from qaig_tpu_torch.utils.checkpoint import load_model

MANIFEST_NAME = "all_dataset.json"


def encoder_from_checkpoint(ckpt, device, logging=print):
    cfg = ConvNetConfig(
        num_layers=ckpt["num_layers"],
        image_channel=ckpt["image_channel"],
        min_channel=ckpt["min_channel"],
        max_channel=ckpt["max_channel"],
        latent_channel=ckpt["latent_channel"],
        hidden_activation_type=ckpt["hidden_activation_type"],
        # reference quirk: the decoder's flag gates the encoder's activation
        use_final_activation=ckpt["use_final_dec_activation"],
        final_activation_type=ckpt["encoder_activation_type"])
    model = common.init_for_restore(FCEncoder(cfg, device=device), device)
    common.restore_model_state(
        model, ckpt["model"], logging=logging,
        key_map=common.submodule_key_map("fc_encoder.",
                                         drop_prefixes=("fc_decoder.",)))
    return model, cfg


@torch.inference_mode()
def save_feature_maps(model, loader, out_dir, device, num_files_folder=1_000,
                      logging=print):
    """Encode every batch and write the latents and the manifest; returns
    the manifest's path."""
    file_index = 0
    folder_name = 0
    all_data = []
    logging("#" * 100)
    logging("Saving Feature Maps to disk...")
    for index, (image, image_paths) in enumerate(loader):
        latents = model(torch.from_numpy(image).to(device)).float().cpu()
        for fmap, image_path in zip(latents.numpy(), image_paths):
            if file_index % num_files_folder == 0 and file_index > 0:
                folder_name += 1
            curr_folder = os.path.join(str(out_dir), str(folder_name))
            os.makedirs(curr_folder, exist_ok=True)
            fmap_path = os.path.join(curr_folder, str(file_index))
            with open(fmap_path, "wb") as f:
                np.save(f, fmap, allow_pickle=False, fix_imports=False)
            file_index += 1
            all_data.append({"fmap_path": fmap_path,
                             "image_path": image_path})
        logging(f"{index + 1:,} / {len(loader):,}")
    logging("Finished saving feature maps.")
    manifest_path = write_manifest(os.path.join(str(out_dir), MANIFEST_NAME),
                                   all_data)
    logging("Finished saving json file.")
    logging("#" * 100)
    return manifest_path


def run(args):
    """Extract the feature maps of ``args`` (the CLI flags, a dict);
    returns the manifest's path.  ``device`` defaults to ``cuda``."""
    device = common.select_device(args.get("device") or "cuda")
    device = common.maybe_init_distributed(args, device)
    out_dir = common.ensure_dir(args["out_dir"])
    if not common.is_main_process():
        common.single_writer_barrier()
        return os.path.join(str(out_dir), MANIFEST_NAME)
    try:
        status, ckpt = load_model(args["model_path"])
        if not status:
            raise RuntimeError(
                "An error occured while loading Encoder model checkpoint!")
        model, _ = encoder_from_checkpoint(ckpt, device)
        dataset = ImageDataset(args["dataset_path"], return_filepaths=True)
        loader = DataLoader(dataset, batch_size=args.get("batch_size", 8),
                            shuffle=True, seed=args.get("seed", 0),
                            drop_remainder=False)
        return save_feature_maps(
            model, loader, out_dir, device,
            num_files_folder=args.get("num_files_folder", 1_000))
    finally:
        common.single_writer_barrier()
