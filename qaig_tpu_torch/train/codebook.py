"""Codebook (SOM) training stage (counterpart of
``qaig_tpu/train/codebook.py``), on one device or data-parallel over
``--multihost`` processes (``--num-model-shards`` shapes the mesh; the
codebook stays replicated, as in ``qaig_tpu``).

Each step: the Gaussian-neighbourhood quantization of a feature-map batch
(``Codebook.forward``: the BMU kernel on the card, then the soft blend of
codes), MSE against the batch, backward into the codebook, one Adam(0.5,
0.999) update with LR halving.  The neighbourhood range shrinks by one
every ``neighbourhood_step`` global steps.  Every ``checkpoint_step``: the
decoder's previews of the batch and of its quantization (``image_plot_<n>``
/ ``quant_image_plot_<n>``) and a checkpoint in ``qaig_tpu``'s schema
(with the neighbourhood range, the step counter and the optax-form
optimizer state).  ``--auto-resume`` continues at the step after the
newest checkpoint and replays the range decrement that followed it.  On
CUDA the step replays from a CUDA graph, the counterpart of the JAX
trainer's one jitted step, with the range as its input.  Over a mesh each
rank steps on its rows of the global batch, the gradient is averaged in
the step and the logged loss is the global mean; rank 0 writes the logs,
grids and checkpoints (``--checkpoint-backend pickle-async``: in the
background).
"""

import functools

import torch

from qaig_tpu_torch.convert import to_jax_state, to_optax_state
from qaig_tpu_torch.data.fmap_dataset import FeatureMapDataset
from qaig_tpu_torch.data.loader import DataLoader
from qaig_tpu_torch.models.codebook import Codebook
from qaig_tpu_torch.parallel.mesh import make_mesh_for_batch
from qaig_tpu_torch.parallel.sharding import Parallel
from qaig_tpu_torch.train import common, optim
from qaig_tpu_torch.utils.checkpoint import save_model, wait_pending_saves
from qaig_tpu_torch.utils.image_io import save_images
from qaig_tpu_torch.utils.logging_utils import setup_logging

PROJECT_NAME = "Codebook"


def make_train_step(model, optimizer, scheduler=None, debug_nans=False,
                    graphed=None, parallel=None):
    """``step(batch, neighbourhood_range) -> loss``: quantize, MSE,
    backward and one ``optimizer`` update of the codebook in place (then
    ``scheduler``).  The range enters the device work as a float32 0-d
    tensor, as it is a traced argument of the JAX step, so one graph serves
    every range.  ``debug_nans``: autograd anomaly detection (eager).
    ``graphed`` (None: on CUDA unless ``debug_nans``): the device work
    replays from a CUDA graph (``common.train_step``); the step's
    ``runner`` then holds it (None when eager).  ``parallel``: a
    ``parallel/sharding.py::Parallel`` (``batch`` holds this rank's rows;
    the gradient is averaged over the mesh, the loss is the global
    mean)."""
    def forward_backward(batch, neighbourhood_range):
        if parallel is not None:
            parallel.zero_grad_()
        quant = model(batch, use_gaussian=True,
                      neighbourhood_range=neighbourhood_range)
        loss = torch.mean((quant - batch) ** 2)
        loss.backward()
        loss = loss.detach()
        return loss if parallel is None else parallel.mean_loss(loss)

    run = common.train_step(forward_backward,
                            common.parallel_update(optimizer, parallel),
                            optimizer, scheduler, model.codebook.device,
                            graphed, debug_nans)

    def step(batch, neighbourhood_range):
        return run(batch, torch.as_tensor(neighbourhood_range,
                                          dtype=torch.float32))

    step.runner = run.runner
    return step


def checkpoint_dict(model, global_steps, optimizer=None, scheduled=True,
                    params=None, states=None):
    """``qaig_tpu``'s codebook checkpoint (the optimizer state only when
    ``optimizer`` is given; ``params`` / ``states``:
    ``common.gather_training_state``'s)."""
    ckpt = {
        "patch_dim": tuple(model.patch_dim),
        "image_dim": tuple(model.image_dim),
        "image_C": model.image_channel,
        "num_embeddings": model.num_embeddings,
        "neighbourhood_range": model.neighbourhood_range,
        "global_steps": global_steps,
        "checkpoint": to_jax_state(model, params=params),
    }
    if optimizer is not None:
        ckpt["model_optimizer"] = to_optax_state(
            model, optimizer, scheduled=scheduled, states=states)
    return ckpt


def run(args):
    """Train from the CLI flags in ``args`` (a dict); returns the codebook.
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
    neighbourhood_step = config_dict["neighbourhood_step"]
    lr_update_step = args.get("lr_step", 100_000)
    checkpoint_step = args.get("checkpoint_step", 1_000)
    batch_size = args.get("batch_size", 8)
    max_epoch = args.get("max_epoch", 1_000)
    max_steps = args.get("max_steps")
    seed = args.get("seed", 0)

    # the pre-trained decoder, for the previews only
    decoder, _ = common.decoder_from_checkpoint(
        common.load_checkpoint(args["decoder_path"], "decoder model", log),
        device, logging=log.info)

    global_steps = 0
    resume_opt = None
    # --auto-resume: continue from the newest codebook checkpoint in
    # out_dir; an explicit --codebook-path wins
    if args.get("auto_resume") and not args.get("codebook_path"):
        latest, _ = common.find_latest_checkpoint(out_dir, prefix="codebook",
                                                  logging=log.info)
        if latest is None:
            log.info("Auto-resume: no checkpoint under "
                     f"{out_dir}/models_checkpoint; starting fresh.")
        else:
            args = dict(args, codebook_path=latest)
            log.info(f"Auto-resume: continuing from {latest}")
    if args.get("codebook_path"):
        cb_ckpt = common.load_checkpoint(args["codebook_path"], "codebook",
                                         log)
        model = common.codebook_from_checkpoint(cb_ckpt, device,
                                                logging=log.info)
        model.requires_grad_(True)
        global_steps = cb_ckpt.get("global_steps", 0)
        if args.get("auto_resume"):
            # the checkpoint at counter N already holds update N: continue
            # at N + 1; plain --codebook-path resumes at N, as the
            # reference does
            resume_opt = cb_ckpt.get("model_optimizer")
            global_steps = global_steps + 1
            if global_steps % neighbourhood_step == 0:
                # the interrupted run shrank the range right after this
                # save (the bottom of the boundary step): replay it
                model.decrease_neighbourhood(steps=1)
            log.info(f"Resuming at global step {global_steps:,}.")
    else:
        model = Codebook(
            patch_dim=(config_dict["patch_H"], config_dict["patch_W"]),
            image_dim=(config_dict["image_H"], config_dict["image_W"]),
            image_channel=config_dict["image_C"],
            num_embeddings=config_dict["num_embeddings"],
            init_neighbour_range=config_dict["num_embeddings"] // 2,
            device=device).init(torch.Generator(device=device)
                                .manual_seed(seed))

    optimizer, scheduler = optim.make_adam(model.parameters(), model_lr,
                                           lr_update_step)
    if resume_opt is not None:   # --auto-resume: the Adam moments go on too
        common.restore_optimizer(model, optimizer, scheduler, resume_opt,
                                 logging=log.info)

    mesh = make_mesh_for_batch(
        batch_size, n_model=int(args.get("num_model_shards") or 1),
        device=device)
    parallel = (Parallel(model, optimizer, mesh, tensor_parallel=False)
                if mesh.distributed else None)
    dataset = FeatureMapDataset(args["dataset_path"])
    loader = DataLoader(dataset, batch_size=batch_size, seed=seed,
                        process_index=mesh.index("data"),
                        process_count=mesh.size("data"))
    train_step = make_train_step(model, optimizer, scheduler=scheduler,
                                 debug_nans=bool(args.get("debug_nans")),
                                 parallel=parallel)

    log.info(PROJECT_NAME)
    log.info(f"Output Dir: {out_dir}")
    log.info(f"Device: {device}")
    log.info(common.train_step_mode(device, bool(args.get("debug_nans"))))
    log.info(f"Mesh: {mesh.describe()}")
    log.info("#" * 100)
    log.info("Codebook Parameters.")
    log.info(f"Image dim: {model.image_dim}")
    log.info(f"Image channel: {model.image_channel:,}")
    log.info(f"Patch size: {model.patch_dim}")
    log.info(f"Num Embeddings: {model.num_embeddings:,}")
    log.info(f"Neighbourhood range: {model.neighbourhood_range:,}")
    log.info("#" * 100)
    log.info("Training Parameters.")
    log.info(f"Max Epoch: {max_epoch:,}")
    log.info(f"Batch Size: {batch_size:,}")
    log.info(f"Model LR Update size: {lr_update_step:,}")
    log.info(f"Model Checkpoint step: {checkpoint_step:,}")
    log.info("#" * 100)

    def dump(images, name):
        images = (images if parallel is None
                  else common.gather_replicated(images, mesh))
        if main:
            save_images(images.float().cpu().numpy(), name, out_dir,
                        logging=log.info)

    log_every = args.get("log_every", 1)
    throughput = common.ThroughputMeter(batch_size)
    stop = False
    try:
        for _ in range(max_epoch):
            iteration_count = 0
            total_recon_loss = 0.0
            loss_acc = torch.zeros((), device=device)
            for index, feature_map in enumerate(loader):
                profiler.step(global_steps)
                batch = torch.from_numpy(feature_map).to(device)
                nrange = float(model.neighbourhood_range)
                loss = train_step(batch, nrange)
                iteration_count += 1
                loss_acc += loss
                should_sync = (log_every <= 1
                               or (global_steps + 1) % log_every == 0
                               or global_steps % checkpoint_step == 0)
                if should_sync:
                    total_recon_loss = float(loss_acc)
                    common.check_finite(total_recon_loss)

                if global_steps % checkpoint_step == 0:
                    with torch.inference_mode():
                        quant = model(batch, use_gaussian=True,
                                      neighbourhood_range=nrange)
                        dump(decoder(batch), f"image_plot_{global_steps}")
                        dump(decoder(quant),
                             f"quant_image_plot_{global_steps}")
                    params, states = common.gather_training_state(
                        model, optimizer, parallel,
                        snapshot=backend == "pickle-async")
                    if main:
                        save_status = save_model(
                            functools.partial(
                                checkpoint_dict, model, global_steps,
                                optimizer, scheduled=scheduler is not None,
                                params=params, states=states),
                            dest_path=out_dir,
                            file_name=f"codebook_{global_steps}.pt",
                            logging=log.info, backend=backend)
                        log.info("Successfully saved codebook."
                                 if save_status
                                 else "Error occured saving codebook.")
                        if save_status and args.get("keep_checkpoints"):
                            common.prune_checkpoints(
                                out_dir, int(args["keep_checkpoints"]),
                                prefix="codebook", logging=log.info)

                lr_now = optim.current_lr(model_lr, lr_update_step,
                                          global_steps + 1)
                if should_sync:
                    avg = total_recon_loss / iteration_count
                    log.info(
                        "Cum. Steps: {:,} | Steps: {:,} / {:,} | L.R.: "
                        "{:.8f} | Recon Loss: {:.5f} | Neighbourhood Range: "
                        "{}".format(global_steps + 1, index + 1, len(loader),
                                    lr_now, avg, model.neighbourhood_range))
                    metrics.log(step=global_steps + 1, lr=lr_now,
                                recon_loss=avg,
                                samples_per_sec=throughput.rate(
                                    global_steps + 1),
                                neighbourhood_range=model.neighbourhood_range)
                global_steps += 1
                if global_steps % neighbourhood_step == 0:
                    model.decrease_neighbourhood(steps=1)
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
