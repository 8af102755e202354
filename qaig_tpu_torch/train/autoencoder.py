"""Autoencoder training stage (counterpart of
``qaig_tpu/train/autoencoder.py``), on one device or data-parallel over
``--multihost`` processes (``--zero-opt``: ZeRO-1; ``--num-model-shards``
shapes the mesh, the conv nets stay replicated, as in ``qaig_tpu``).

Adam(0.5, 0.999) on the MSE between the images and their reconstruction,
the learning rate halved every ``lr_step`` updates; every
``checkpoint_step`` a checkpoint in ``qaig_tpu``'s schema (plus the step
counter and the optax-form optimizer state) and ground-truth /
reconstruction grids; a NaN guard.  ``bf16`` runs the forward and backward
on a bfloat16 copy of every parameter (``torch.func.functional_call``)
while the master weights, Adam moments and loss stay float32, as the JAX
package casts its parameter tree.  Float32 convolutions on the card run in
full float32 (``common.select_device`` turns TF32 off).  On CUDA the step
(forward, backward, Adam) replays from a CUDA graph, the counterpart of
the JAX trainer's one jitted step.  Over a mesh each rank steps on its
rows of the global batch, the gradients are averaged in the step (or
reduce-scattered, under ZeRO-1) and the logged loss is the global mean;
rank 0 writes the logs, grids and checkpoints (``--checkpoint-backend
pickle-async``: in the background).
"""

import functools

import torch
from torch.func import functional_call

from qaig_tpu_torch.convert import to_jax_state, to_optax_state
from qaig_tpu_torch.data.image_dataset import ImageDataset
from qaig_tpu_torch.data.loader import DataLoader
from qaig_tpu_torch.models.conv_nets import Autoencoder, AutoencoderConfig
from qaig_tpu_torch.models.core import init_parameters
from qaig_tpu_torch.parallel.mesh import make_mesh_for_batch
from qaig_tpu_torch.parallel.sharding import Parallel
from qaig_tpu_torch.train import common, optim
from qaig_tpu_torch.utils.checkpoint import save_model, wait_pending_saves
from qaig_tpu_torch.utils.image_io import save_images
from qaig_tpu_torch.utils.logging_utils import setup_logging

PROJECT_NAME = "Autoencoder"


def build_autoencoder(config_dict, device=None):
    """The model of a config, with the JAX package's fallback activations
    (silu / tanh) where a final activation is off."""
    use_final_enc = config_dict["use_final_enc_activation"]
    use_final_dec = config_dict["use_final_dec_activation"]
    cfg = AutoencoderConfig(
        num_layers=config_dict["num_layers"],
        image_channel=config_dict["image_channel"],
        min_channel=config_dict["min_channel"],
        max_channel=config_dict["max_channel"],
        latent_channel=config_dict["latent_channel"],
        hidden_activation_type=config_dict["hidden_activation_type"],
        use_final_enc_activation=use_final_enc,
        encoder_activation_type=(
            config_dict["encoder_activation_type"] if use_final_enc
            else "silu"),
        use_final_dec_activation=use_final_dec,
        decoder_activation_type=(
            config_dict["decoder_activation_type"] if use_final_dec
            else "tanh"))
    return Autoencoder(cfg, device=device), cfg


def make_train_step(model, optimizer, bf16=False, grad_accum=1,
                    scheduler=None, debug_nans=False, graphed=None,
                    parallel=None):
    """``step(batch) -> loss``: forward, MSE, backward and one
    ``optimizer`` update of ``model`` in place (then ``scheduler``).
    ``grad_accum``: the batch in that many equal chunks, gradients summed,
    one update.  ``debug_nans``: autograd anomaly detection (eager).
    ``graphed`` (None: on CUDA unless ``debug_nans``): the device work
    replays from a CUDA graph (``common.train_step``); the step's
    ``runner`` then holds it (None when eager).  ``parallel``: a
    ``parallel/sharding.py::Parallel`` (``batch`` holds this rank's rows;
    the gradients are reduced over the mesh, the loss is the global
    mean)."""
    device = next(model.parameters()).device

    def loss_fn(batch):
        if bf16:
            cast = {name: p.to(torch.bfloat16)
                    for name, p in model.named_parameters()}
            recon = functional_call(model, cast,
                                    (batch.to(torch.bfloat16),))
            recon = recon.to(torch.float32)
        else:
            recon = model(batch)
        return torch.mean((recon - batch) ** 2)

    def forward_backward(batch):
        if parallel is not None:
            parallel.zero_grad_()
        loss = 0.0
        for chunk in batch.chunk(grad_accum):
            chunk_loss = loss_fn(chunk)
            (chunk_loss / grad_accum).backward()
            loss = loss + chunk_loss.detach()
        loss = loss / grad_accum
        return loss if parallel is None else parallel.mean_loss(loss)

    return common.train_step(forward_backward,
                             common.parallel_update(optimizer, parallel),
                             optimizer, scheduler, device, graphed,
                             debug_nans)


def checkpoint_dict(cfg, model, optimizer, scheduled=True, global_steps=0,
                    params=None, states=None):
    """``qaig_tpu``'s autoencoder checkpoint: the config, the flat model
    state, the optax-form optimizer state and the step counter
    (``params`` / ``states``: ``common.gather_training_state``'s)."""
    return {
        "global_steps": global_steps,
        "num_layers": cfg.num_layers,
        "image_channel": cfg.image_channel,
        "min_channel": cfg.min_channel,
        "max_channel": cfg.max_channel,
        "latent_channel": cfg.latent_channel,
        "hidden_activation_type": cfg.hidden_activation_type,
        "use_final_enc_activation": cfg.use_final_enc_activation,
        "encoder_activation_type": cfg.encoder_activation_type,
        "use_final_dec_activation": cfg.use_final_dec_activation,
        "decoder_activation_type": cfg.decoder_activation_type,
        "model": to_jax_state(model, params=params),
        "model_optimizer": to_optax_state(model, optimizer,
                                          scheduled=scheduled,
                                          states=states),
    }


def run(args):
    """Train from the CLI flags in ``args`` (a dict); returns the model.
    ``device`` defaults to ``cuda``."""
    device = common.select_device(args.get("device") or "cuda")
    notes = []
    device = common.maybe_init_distributed(args, device,
                                           logging=notes.append)
    main = common.is_main_process()
    out_dir = common.ensure_dir(args["out_dir"])
    log = setup_logging(out_dir, PROJECT_NAME, main_process=main)
    for note in notes:
        log.info(note)
    profiler = common.Profiler(args)
    metrics = common.MetricsLogger(out_dir, enabled=main)
    backend = args.get("checkpoint_backend") or "pickle"

    config_dict = common.load_config(args["config_path"])
    model_lr = config_dict["model_lr"]
    lr_update_step = args.get("lr_step", 50_000)
    checkpoint_step = args.get("checkpoint_step", 1_000)
    batch_size = args.get("batch_size", 8)
    max_epoch = args.get("max_epoch", 1_000)
    max_steps = args.get("max_steps")
    seed = args.get("seed", 0)
    raw_accum = args.get("grad_accum")
    grad_accum = 1 if raw_accum is None else int(raw_accum)
    if grad_accum < 1:
        raise ValueError(f"--grad-accum must be >= 1, got {grad_accum}")
    if batch_size % grad_accum:
        raise ValueError(
            f"batch size {batch_size} not divisible by "
            f"--grad-accum {grad_accum}")
    # the conv nets have no tensor-parallel split: --num-model-shards only
    # shapes the mesh (its model peers step on the same rows); the mesh
    # sees one --grad-accum chunk at a time
    mesh = make_mesh_for_batch(batch_size // grad_accum,
                               n_model=int(args.get("num_model_shards")
                                           or 1), device=device)

    model, cfg = build_autoencoder(config_dict, device)
    init_parameters(model, torch.Generator(device=device).manual_seed(seed))
    optimizer, scheduler = optim.make_adam(model.parameters(), model_lr,
                                           lr_update_step)

    # --auto-resume: continue from the newest checkpoint in out_dir (model,
    # optimizer and step counter); an explicit --model-path wins
    resume_steps = None
    if args.get("auto_resume") and not args.get("model_path"):
        latest, latest_n = common.find_latest_checkpoint(out_dir,
                                                         logging=log.info)
        if latest is None:
            log.info("Auto-resume: no checkpoint under "
                     f"{out_dir}/models_checkpoint; starting fresh.")
        else:
            args = dict(args, model_path=latest, load_optim=True)
            resume_steps = latest_n
            log.info(f"Auto-resume: continuing from {latest}")

    if args.get("model_path"):
        ckpt = common.load_checkpoint(args["model_path"], "model", log)
        common.restore_model_state(model, ckpt["model"], logging=log.info)
        if args.get("auto_resume"):
            resume_steps = int(ckpt.get("global_steps", resume_steps or 0))
        if args.get("load_optim") and ckpt.get("model_optimizer") is not None:
            common.restore_optimizer(model, optimizer, scheduler,
                                     ckpt["model_optimizer"],
                                     logging=log.info)

    parallel = (Parallel(model, optimizer, mesh,
                         zero=bool(args.get("zero_opt")),
                         tensor_parallel=False)
                if mesh.distributed else None)
    dataset = ImageDataset(args["dataset_path"])
    loader = DataLoader(dataset, batch_size=batch_size, seed=seed,
                        process_index=mesh.index("data"),
                        process_count=mesh.size("data"))
    train_step = make_train_step(
        model, optimizer, bf16=bool(args.get("bf16")), grad_accum=grad_accum,
        scheduler=scheduler, debug_nans=bool(args.get("debug_nans")),
        parallel=parallel)

    n_params = sum(p.numel() for p in model.parameters())
    log.info(PROJECT_NAME)
    log.info(f"Output Dir: {out_dir}")
    log.info(f"Device: {device}")
    log.info(common.train_step_mode(device, bool(args.get("debug_nans"))))
    log.info("Mesh: {}{}".format(
        mesh.describe(),
        " | ZeRO-1 optimizer sharding" if args.get("zero_opt") else ""))
    log.info(f"Model size: {n_params:,}")
    log.info("#" * 100)
    log.info("Autoencoder Parameters.")
    log.info(f"Num Layers: {cfg.num_layers:,}")
    log.info(f"Image Channel: {cfg.image_channel:,}")
    log.info(f"Min Channel: {cfg.min_channel:,}")
    log.info(f"Max Channel: {cfg.max_channel:,}")
    log.info(f"Latent Channel: {cfg.latent_channel:,}")
    log.info(f"Hidden activation type: {cfg.hidden_activation_type}")
    log.info("#" * 100)
    log.info("Training Parameters.")
    log.info(f"Max Epoch: {max_epoch:,}")
    log.info(f"Batch Size: {batch_size:,}")
    log.info(f"Model LR Update size: {lr_update_step:,}")
    log.info(f"Model Checkpoint step: {checkpoint_step:,}")
    if grad_accum > 1:
        log.info(f"Gradient accumulation: {grad_accum}")
    log.info("#" * 100)

    def dump(images, name):
        images = (images if parallel is None
                  else common.gather_replicated(images, mesh))
        if main:
            save_images(images.float().cpu().numpy(), name, out_dir,
                        logging=log.info)

    log_every = args.get("log_every", 1)
    throughput = common.ThroughputMeter(batch_size)
    # a checkpoint saved at counter N already holds update N, so a resumed
    # run continues at N + 1 and applies exactly the updates an
    # uninterrupted one would
    global_steps = 0 if resume_steps is None else resume_steps + 1
    if resume_steps is not None:
        log.info(f"Resuming at global step {global_steps:,}.")
    stop = False
    try:
        for _ in range(max_epoch):
            total_recon_loss = 0.0
            iteration_count = 0
            loss_acc = torch.zeros((), device=device)
            for index, image in enumerate(loader):
                profiler.step(global_steps)
                batch = torch.from_numpy(image).to(device)
                loss = train_step(batch)
                iteration_count += 1
                loss_acc += loss
                should_sync = (log_every <= 1
                               or (global_steps + 1) % log_every == 0
                               or global_steps % checkpoint_step == 0)
                if should_sync:
                    total_recon_loss = float(loss_acc)
                    common.check_finite(total_recon_loss)

                if global_steps % checkpoint_step == 0:
                    params, states = common.gather_training_state(
                        model, optimizer, parallel,
                        snapshot=backend == "pickle-async")
                    if main:
                        save_status = save_model(
                            functools.partial(
                                checkpoint_dict, cfg, model, optimizer,
                                scheduled=scheduler is not None,
                                global_steps=global_steps, params=params,
                                states=states),
                            dest_path=out_dir,
                            file_name=f"model_{global_steps}.pt",
                            logging=log.info, backend=backend)
                        log.info("Successfully saved model." if save_status
                                 else "Error occured saving model.")
                        if save_status and args.get("keep_checkpoints"):
                            common.prune_checkpoints(
                                out_dir, int(args["keep_checkpoints"]),
                                logging=log.info)
                    with torch.inference_mode():
                        recon = model(batch)
                    dump(batch, f"ground_truth_{global_steps}")
                    dump(recon, f"recon_{global_steps}")

                lr_now = optim.current_lr(model_lr, lr_update_step,
                                          global_steps + 1)
                if should_sync:
                    avg = total_recon_loss / iteration_count
                    log.info(
                        "Cum. Steps: {:,} | Steps: {:,} / {:,} | L.R.: "
                        "{:.8f} | Recon Loss: {:.5f}".format(
                            global_steps + 1, index + 1, len(loader),
                            lr_now, avg))
                    metrics.log(step=global_steps + 1, lr=lr_now,
                                recon_loss=avg,
                                samples_per_sec=throughput.rate(
                                    global_steps + 1))
                global_steps += 1
                if max_steps and global_steps >= max_steps:
                    stop = True
                    break
            if stop:
                break
    finally:
        saved = wait_pending_saves(logging=log.info)
        profiler.close()
        metrics.close()
    if not saved:
        raise RuntimeError(
            "An error occured while saving model checkpoint!")
    return model
