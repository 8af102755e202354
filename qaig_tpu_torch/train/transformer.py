"""Quantized-transformer training stage, base and cascade modes
(counterpart of ``qaig_tpu/train/transformer.py``), on one device or over
a mesh of processes (``--multihost``: data parallelism,
``--num-model-shards`` tensor parallelism, ``--num-pipeline-stages``
GPipe, ``--zero-opt`` ZeRO-1; ``qaig_tpu_torch/parallel``).

Each step: tokenize a feature-map batch against the LR and HR codebooks
(the BMU kernel on the card), assemble the sequences (cascade: a <start>
token = hr_K before the HR tokens, LR tokens into the encoder; base: LR
tokens then shifted HR tokens), cut one random window per sample with its
absolute positions as AdaLN conditioning when the model slides, run the
teacher-forced forward and the cross-entropy against HR tokens + <end>
(= hr_K), backward, and one Adam(0.5, 0.999) update with LR halving.
Checkpoints use ``qaig_tpu``'s schema (model, optax-form optimizer state,
EMA, step counter) and come with the autoregressive image preview.

The window starts are drawn on the host from a CPU ``torch.Generator``, so
a seed gives the same windows on the card and on the CPU, and enter the
step as a tensor.  On CUDA the step's device work (tokenization, forward,
backward, clip, Adam and EMA) replays from a CUDA graph, the counterpart
of the JAX trainer's one jitted step; previews, logging and saves stay
outside it.  ``bf16`` runs
the forward and backward on a bfloat16 copy of every parameter
(``torch.func.functional_call``) while the master weights, Adam moments
and loss stay float32, as the JAX package casts its parameter tree; the
codebooks are never cast, so tokens match the float32 pipeline.

Over a mesh every random draw of a step is made for the global batch on
every rank and this rank's rows are taken, so a data-parallel run takes
the 1-process run's steps; the logged loss is the global mean.  Only rank
0 writes logs, metrics, previews and checkpoints; the checkpoint holds the
full parameters and Adam moments (gathered over the mesh) in the
per-layer-list schema.  ``--checkpoint-backend pickle-async`` writes them
in the background (``utils/checkpoint.py``).
"""

import copy

import torch
import torch.nn.functional as F
from torch.func import functional_call

from qaig_tpu_torch.convert import to_jax_state, to_optax_state
from qaig_tpu_torch.data.fmap_dataset import FeatureMapDataset
from qaig_tpu_torch.data.loader import DataLoader
from qaig_tpu_torch.infer.decode import DecodeEngine, SamplerSettings
from qaig_tpu_torch.models.core import init_parameters
from qaig_tpu_torch.models.transformer import Transformer, TransformerConfig
from qaig_tpu_torch.parallel.mesh import make_mesh_for_batch
from qaig_tpu_torch.parallel.pipeline import GPipe
from qaig_tpu_torch.parallel.sharding import Parallel
from qaig_tpu_torch.train import common, optim
from qaig_tpu_torch.utils.checkpoint import save_model, wait_pending_saves
from qaig_tpu_torch.utils.image_io import save_images
from qaig_tpu_torch.utils.logging_utils import setup_logging

PROJECT_NAME = "Quantized Transformer"


def build_transformer_config(config_dict, train_base_model, lr_num_embeddings,
                             hr_num_embeddings, use_remat=False):
    """The model of a training config: base = decoder-only over the joint
    LR + HR vocabulary; cascade = encoder over LR tokens, decoder over HR
    tokens + <start>; both predict HR tokens + <end>."""
    if train_base_model:
        num_enc_layers = 0
        num_enc_embedding = 0
        cross_attn_heads = 0
        num_dec_embedding = lr_num_embeddings + hr_num_embeddings
    else:
        num_enc_layers = config_dict["num_enc_layers"]
        num_enc_embedding = lr_num_embeddings
        cross_attn_heads = config_dict["cross_attn_heads"]
        num_dec_embedding = hr_num_embeddings + 1  # includes <start>

    return TransformerConfig(
        use_encoder=not train_base_model,
        use_pos_cond=config_dict["use_sliding_window"],
        num_enc_layers=num_enc_layers,
        num_dec_layers=config_dict["num_dec_layers"],
        num_enc_embedding=max(num_enc_embedding, 1),
        num_dec_embedding=num_dec_embedding,
        self_attn_heads=config_dict["self_attn_heads"],
        cross_attn_heads=cross_attn_heads,
        in_dim=config_dict["in_dim"],
        out_dim=hr_num_embeddings + 1,  # includes <end>
        hidden_dim=config_dict["hidden_dim"],
        hidden_activation=config_dict["hidden_activation"],
        use_remat=use_remat)


def input_length(lr_tokens, hr_tokens, train_base_model):
    """Length of :func:`assemble_sequences`' ``hr_input`` from the number
    of LR and HR tokens per sample: the HR tokens after the LR ones (base)
    or after <start> (cascade)."""
    return hr_tokens + (lr_tokens if train_base_model else 1)


def assemble_sequences(lr_indices, hr_indices, train_base_model,
                       lr_num_embeddings, hr_num_embeddings):
    """(hr_input, lr_input, hr_target) from the (N, Seq) BMU token grids;
    ``lr_input`` is None in base mode.  ``hr_input`` is
    :func:`input_length` long."""
    n = hr_indices.shape[0]
    end = torch.full((n, 1), hr_num_embeddings, dtype=hr_indices.dtype,
                     device=hr_indices.device)
    hr_target = torch.cat([hr_indices, end], dim=1)
    if train_base_model:
        hr_input = torch.cat([lr_indices, hr_indices + lr_num_embeddings],
                             dim=1)
        return hr_input, None, hr_target
    hr_input = torch.cat([end, hr_indices], dim=1)  # <start> = hr_K
    return hr_input, lr_indices, hr_target


def slice_windows(hr_input, hr_target, starts, window):
    """Row ``i``'s length-``window`` slice from ``starts[i]``, of input and
    target, and its absolute positions (N, window)."""
    pos = starts[:, None] + torch.arange(window, device=starts.device)
    return hr_input.gather(1, pos), hr_target.gather(1, pos), pos


def draw_window_starts(generator, n, seq_in, window):
    """``n`` uniformly drawn window starts in ``[0, seq_in - window]`` from
    ``generator``, on its device."""
    return torch.randint(0, seq_in - window + 1, (n,), generator=generator,
                         device=generator.device)


def sequence_length(batch, lr_codebook, hr_codebook, train_base_model):
    """:func:`input_length` of a feature-map batch (N, C, H, W)."""
    def tokens(codebook):
        ph, pw = codebook.patch_dim
        return (batch.shape[2] // ph) * (batch.shape[3] // pw)
    return input_length(tokens(lr_codebook), tokens(hr_codebook),
                        train_base_model)


def tokenize_batch(batch, starts, lr_codebook, hr_codebook,
                   train_base_model, lr_num_embeddings, hr_num_embeddings,
                   sliding_window=None):
    """Feature maps (N, C, H, W) float32 -> (hr_input, lr_input, hr_target,
    pos_cond): BMU tokens, assembled, and when the model slides cut to the
    windows from ``starts`` (N,) on the batch's device."""
    lr_idx = lr_codebook.get_patches_bmu(batch, reshape=True)
    hr_idx = hr_codebook.get_patches_bmu(batch, reshape=True)
    hr_input, lr_input, hr_target = assemble_sequences(
        lr_idx, hr_idx, train_base_model, lr_num_embeddings,
        hr_num_embeddings)
    pos_cond = None
    if sliding_window is not None:
        hr_input, hr_target, pos_cond = slice_windows(
            hr_input, hr_target, starts, sliding_window)
    return hr_input, lr_input, hr_target, pos_cond


def make_train_step(model, optimizer, lr_codebook, hr_codebook,
                    train_base_model, lr_num_embeddings, hr_num_embeddings,
                    sliding_window=None, bf16=False, grad_accum=1,
                    grad_clip=None, scheduler=None, debug_nans=False,
                    ema_model=None, ema_decay=None, graphed=None,
                    parallel=None):
    """``step(batch, generator) -> loss``: tokenize, forward, backward and
    one ``optimizer`` update of ``model`` in place (then ``scheduler``).
    The window starts are drawn from ``generator`` on the host before the
    device work.

    ``bf16``: forward and backward on bfloat16 copies of the parameters,
    float32 master weights, gradients, moments and loss.  ``grad_accum``:
    the batch in that many equal chunks, gradients summed, one update (the
    mean of chunk means is the full mean).  ``grad_clip``: scale the
    gradients to that global norm at most before the update.
    ``ema_model``: after the update, its parameters move to ``ema_decay``
    times themselves plus the rest of the live ones.  ``debug_nans``:
    autograd anomaly detection over forward and backward (eager).
    ``graphed`` (None: on CUDA unless ``debug_nans``): the device work
    replays from a CUDA graph (``common.train_step``); the step's
    ``runner`` then holds it (None when eager).

    ``parallel``: a ``parallel/sharding.py::Parallel`` over ``model`` and
    ``optimizer`` (the mesh's data, tensor and pipeline parallelism and
    ZeRO-1): ``batch`` holds this rank's rows, the window starts are drawn
    for the global batch and this rank's are taken, the gradients are
    reduced over the mesh (and clipped to the global norm), and the loss
    returned is the global mean."""
    device = next(p for p in model.parameters()
                  if p.device.type != "meta").device
    pipe = parallel.pipe if parallel is not None else None
    ema_pairs = None
    if ema_model is not None:
        ema_pairs = ((parallel.owned(ema_model), parallel.owned(model))
                     if parallel is not None else
                     (list(ema_model.parameters()), list(model.parameters())))

    def loss_fn(hr_in, lr_in, hr_tgt, pos_cond):
        kwargs = {"x_enc": lr_in, "pos_cond": pos_cond}
        if pipe is not None:
            kwargs["decoder_stack"] = pipe
        if bf16:
            cast = {name: p.to(torch.bfloat16)
                    for name, p in model.named_parameters()
                    if p.device.type != "meta"}
            logits = functional_call(model, cast, (hr_in,), kwargs)
        else:
            logits = model(hr_in, **kwargs)
        if logits is None:   # a pipeline stage before the last
            return None
        return F.cross_entropy(
            logits.to(torch.float32).reshape(-1, logits.shape[-1]),
            hr_tgt.reshape(-1))

    def forward_backward(batch, starts=None):
        if parallel is not None:
            parallel.zero_grad_()
        parts = tokenize_batch(batch, starts, lr_codebook, hr_codebook,
                               train_base_model, lr_num_embeddings,
                               hr_num_embeddings, sliding_window)
        if pipe is not None:
            loss = loss_fn(*parts)
            pipe.backward(loss)
            return parallel.mean_loss(
                None if loss is None else loss.detach())
        chunks = [[None] * grad_accum if x is None else x.chunk(grad_accum)
                  for x in parts]
        loss = 0.0
        for chunk in zip(*chunks):
            chunk_loss = loss_fn(*chunk)
            (chunk_loss / grad_accum).backward()
            loss = loss + chunk_loss.detach()
        loss = loss / grad_accum
        return loss if parallel is None else parallel.mean_loss(loss)

    def update():
        if parallel is not None:
            parallel.reduce_grads_()
            if grad_clip is not None:
                parallel.clip_grads_(grad_clip)
        elif grad_clip is not None:
            params = [p for p in model.parameters() if p.requires_grad]
            grads = [p.grad for p in params if p.grad is not None]
            gnorm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            for g in grads:
                g.mul_(scale)
        optimizer.step()
        if parallel is not None:
            parallel.after_step_()
        if ema_pairs is not None:
            with torch.no_grad():
                torch._foreach_mul_(ema_pairs[0], ema_decay)
                torch._foreach_add_(ema_pairs[0], ema_pairs[1],
                                    alpha=1.0 - ema_decay)

    run = common.train_step(forward_backward, update, optimizer, scheduler,
                            device, graphed, debug_nans)

    n_data, data_index = ((parallel.mesh.size("data"),
                           parallel.mesh.index("data"))
                          if parallel is not None else (1, 0))

    def step(batch, generator):
        inputs = [batch]
        if sliding_window is not None:
            n = batch.shape[0]
            starts = draw_window_starts(
                generator, n * n_data, sequence_length(
                    batch, lr_codebook, hr_codebook, train_base_model),
                sliding_window)
            inputs.append(starts[data_index * n:(data_index + 1) * n])
        return run(*inputs)

    step.runner = run.runner
    return step


def checkpoint_dict(cfg, train_base_model, sliding_window):
    """A checkpoint's self-describing hyperparameters (``qaig_tpu``'s
    schema); the caller fills the states."""
    return {
        "train_base_model": train_base_model,
        "use_sliding_window": cfg.use_pos_cond,
        "sliding_window": sliding_window,
        "num_enc_embedding": (cfg.num_enc_embedding if cfg.use_encoder
                              else None),
        "num_dec_embedding": cfg.num_dec_embedding,
        "num_enc_layers": cfg.num_enc_layers if cfg.use_encoder else None,
        "num_dec_layers": cfg.num_dec_layers,
        "self_attn_heads": cfg.self_attn_heads,
        "cross_attn_heads": (cfg.cross_attn_heads if cfg.use_encoder
                             else None),
        "transformer_in_dim": cfg.in_dim,
        "transformer_out_dim": cfg.out_dim,
        "transformer_hidden_dim": cfg.hidden_dim,
        "hidden_activation": cfg.hidden_activation,
        "model": None,
        "model_optimizer": None,
    }


def generate_preview_tokens(engine, feature_map, lr_codebook,
                            train_base_model, lr_num_embeddings,
                            hr_num_embeddings, total_hr_seq, temperature,
                            sliding_window, generator):
    """Checkpoint-time autoregressive preview: HR-vocabulary tokens
    (N, total_hr_seq) by single-path sampling from the feature maps' LR
    tokens."""
    lr_tokens = lr_codebook.get_patches_bmu(feature_map, reshape=True)
    n = lr_tokens.shape[0]
    if train_base_model:
        init, x_enc, shift = lr_tokens, None, lr_num_embeddings
    else:
        init = torch.full((n, 1), hr_num_embeddings, dtype=torch.long,
                          device=lr_tokens.device)
        x_enc, shift = lr_tokens, 0
    settings = SamplerSettings(
        temperature=temperature, end_token=hr_num_embeddings,
        end_mode="replace_zero", index_shift=shift)
    tokens = engine.generate(init, total_hr_seq, generator, settings,
                             x_enc=x_enc, sliding_window=sliding_window)
    return tokens - shift


def validate_parallel_args(cfg, batch_size, args):
    """Check the ``--num-model-shards`` / ``--num-pipeline-stages`` /
    ``--num-microbatches`` / ``--grad-accum`` / ``--zero-opt``
    combination (``qaig_tpu``'s messages) and return ``(n_model, n_pipe,
    num_microbatches)`` (``num_microbatches`` None without a pipeline).
    Not ported: ``qaig_tpu``'s refusal of bf16 with both pipeline and
    tensor parallelism on the CPU, an XLA:CPU toolchain limit."""
    n_model = int(args.get("num_model_shards") or 1)
    n_pipe = int(args.get("num_pipeline_stages") or 1)
    raw_accum = args.get("grad_accum")
    grad_accum = 1 if raw_accum is None else int(raw_accum)
    if cfg.hidden_dim % n_model:
        raise ValueError(
            f"hidden_dim {cfg.hidden_dim} not divisible by "
            f"--num-model-shards {n_model}")
    if n_pipe < 1:
        raise ValueError(f"--num-pipeline-stages must be >= 1, got {n_pipe}")
    if grad_accum < 1:
        raise ValueError(f"--grad-accum must be >= 1, got {grad_accum}")
    if grad_accum > 1:
        if batch_size % grad_accum:
            raise ValueError(
                f"batch size {batch_size} not divisible by "
                f"--grad-accum {grad_accum}")
        if n_pipe > 1:
            raise ValueError(
                "--grad-accum cannot be combined with "
                "--num-pipeline-stages (the GPipe schedule already "
                "microbatches; use --num-microbatches instead)")
    num_microbatches = None
    if n_pipe > 1:
        if cfg.num_dec_layers % n_pipe:
            raise ValueError(
                f"num_dec_layers {cfg.num_dec_layers} not divisible by "
                f"--num-pipeline-stages {n_pipe}")
        raw_mb = args.get("num_microbatches")
        if raw_mb is not None and int(raw_mb) < 1:
            raise ValueError(
                f"--num-microbatches must be >= 1, got {raw_mb}")
        num_microbatches = int(raw_mb) if raw_mb is not None else n_pipe
        if batch_size % num_microbatches:
            raise ValueError(
                f"batch size {batch_size} not divisible by "
                f"--num-microbatches {num_microbatches}")
        if args.get("zero_opt"):
            raise ValueError(
                "--zero-opt cannot be combined with "
                "--num-pipeline-stages (pipeline stages already shard "
                "the decoder moments over 'pipe'; ZeRO over 'data' on "
                "top is untested)")
    return n_model, n_pipe, num_microbatches


def save_checkpoint(out_dir, step, header, model, optimizer, scheduler,
                    ema_model=None, parallel=None, backend="pickle",
                    keep=None, logging=print):
    """Write ``model_<step>.pt`` (``header`` plus the model, its optax-form
    Adam state and the EMA weights) on rank 0; with ``parallel`` every rank
    takes part in gathering the full tensors first.  Returns the save's
    status (None on the other ranks).  ``backend``: ``pickle`` or
    ``pickle-async`` (``utils/checkpoint.py``); ``keep``: prune to that
    many checkpoints after a successful save."""
    # the background write builds the checkpoint from host snapshots; a
    # synchronous one converts as it goes
    snapshot = backend == "pickle-async"
    params, states = common.gather_training_state(model, optimizer,
                                                  parallel, snapshot)
    ema = (common.gather_training_state(ema_model, parallel=parallel,
                                        snapshot=snapshot)[0]
           if ema_model is not None else None)
    if not common.is_main_process():
        return None

    def build():
        ckpt = dict(header, global_steps=step)
        ckpt["model"] = to_jax_state(model, params=params)
        ckpt["model_optimizer"] = to_optax_state(
            model, optimizer, scheduled=scheduler is not None, states=states)
        if ema_model is not None:
            ckpt["model_ema"] = to_jax_state(ema_model, params=ema)
        return ckpt
    status = save_model(build, dest_path=out_dir,
                        file_name=f"model_{step}.pt", logging=logging,
                        backend=backend)
    logging("Successfully saved model." if status
            else "Error occured saving model.")
    if status and keep:
        common.prune_checkpoints(out_dir, int(keep), logging=logging)
    return status


def run(args):
    """Train from the CLI flags in ``args`` (a dict); returns the model
    (this rank's shards over a mesh).  ``device`` defaults to ``cuda``."""
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
    train_base_model = args.get("train_base_model", False)
    temperature = args.get("temperature", 1.0)
    test_num_sample = args.get("test_num_sample", 25)
    lr_update_step = args.get("lr_step", 50_000)
    checkpoint_step = args.get("checkpoint_step", 1_000)
    batch_size = args.get("batch_size", 8)
    max_epoch = args.get("max_epoch", 1_000)
    max_steps = args.get("max_steps")
    seed = args.get("seed", 0)
    grad_accum = int(args.get("grad_accum") or 1)

    # pre-trained decoder and codebooks (frozen; the codebooks stay float32)
    load = common.load_checkpoint
    decoder, _ = common.decoder_from_checkpoint(
        load(args["decoder_path"], "decoder model", log), device,
        logging=log.info)
    lr_codebook = common.codebook_from_checkpoint(
        load(args["lr_codebook_path"], "Low-Resolution codebook", log),
        device, logging=log.info)
    hr_codebook = common.codebook_from_checkpoint(
        load(args["hr_codebook_path"], "High-Resolution codebook", log),
        device, logging=log.info)
    lr_num_embeddings = lr_codebook.num_embeddings
    hr_num_embeddings = hr_codebook.num_embeddings
    total_hr_seq = hr_codebook.seq_len

    use_sliding_window = config_dict["use_sliding_window"]
    sliding_window = (config_dict["sliding_window"] if use_sliding_window
                      else None)
    cfg = build_transformer_config(
        config_dict, train_base_model, lr_num_embeddings, hr_num_embeddings,
        use_remat=args.get("use_activation_checkpoint", False))
    # DP over the mesh's data axis, Megatron TP of every 2-layer MLP over
    # its model axis, GPipe over its pipe axis (the mesh sees one
    # microbatch, or one --grad-accum chunk, at a time)
    n_model, n_pipe, num_microbatches = validate_parallel_args(
        cfg, batch_size, args)
    mesh = make_mesh_for_batch(
        batch_size // (num_microbatches if n_pipe > 1 else grad_accum),
        n_model=n_model, n_pipe=n_pipe, device=device)
    model = init_parameters(Transformer(cfg, device=device),
                            torch.Generator(device=device).manual_seed(seed))
    optimizer, scheduler = optim.make_adam(model.parameters(), model_lr,
                                           lr_update_step)

    ema_decay = args.get("ema_decay")
    ema_model = None
    if ema_decay is not None:
        ema_decay = float(ema_decay)
        if not 0.0 <= ema_decay < 1.0:
            raise ValueError(
                f"--ema-decay must be in [0, 1), got {ema_decay}")
    grad_clip = args.get("grad_clip")
    if grad_clip is not None:
        grad_clip = float(grad_clip)
        if not grad_clip > 0.0:
            raise ValueError(f"--grad-clip must be > 0, got {grad_clip}")

    # --auto-resume: continue from the newest checkpoint in out_dir (model,
    # optimizer, EMA and step counter); an explicit --model-path wins
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
        ckpt = load(args["model_path"], "model", log)
        common.restore_model_state(model, ckpt["model"], logging=log.info)
        if args.get("auto_resume"):
            resume_steps = int(ckpt.get("global_steps", resume_steps or 0))
        if ema_decay is not None and ckpt.get("model_ema") is not None:
            ema_model = copy.deepcopy(model)
            common.restore_model_state(ema_model, ckpt["model_ema"],
                                       logging=log.info)
        if args.get("load_optim") and ckpt.get("model_optimizer") is not None:
            common.restore_optimizer(model, optimizer, scheduler,
                                     ckpt["model_optimizer"],
                                     logging=log.info)
    if ema_decay is not None and ema_model is None:
        ema_model = copy.deepcopy(model)
    if ema_model is not None:
        ema_model.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())

    # the parallel forms take the restored full model and optimizer and
    # keep this rank's part of them
    parallel = None
    if mesh.distributed:
        parallel = Parallel(
            model, optimizer, mesh, zero=bool(args.get("zero_opt")),
            pipeline=(GPipe(model, mesh, num_microbatches) if n_pipe > 1
                      else None), ema_model=ema_model)

    dataset = FeatureMapDataset(args["dataset_path"])
    loader = DataLoader(dataset, batch_size=batch_size, seed=seed,
                        process_index=mesh.index("data"),
                        process_count=mesh.size("data"))
    test_loader = DataLoader(dataset,
                             batch_size=min(test_num_sample, len(dataset)),
                             seed=seed + 1)
    skip_preview = bool(args.get("skip_preview"))
    # previews: rank 0 alone, on the live model (replicated under DP) or,
    # under the pipeline, on a full copy gathered at the checkpoint; every
    # rank of a tensor-parallel run decodes with its shards in lockstep
    previews_here = main or (n_model > 1 and n_pipe == 1)

    train_step = make_train_step(
        model, optimizer, lr_codebook, hr_codebook, train_base_model,
        lr_num_embeddings, hr_num_embeddings, sliding_window,
        bf16=bool(args.get("bf16")), grad_accum=grad_accum,
        grad_clip=grad_clip, scheduler=scheduler,
        debug_nans=bool(args.get("debug_nans")), ema_model=ema_model,
        ema_decay=ema_decay, parallel=parallel)

    log.info(PROJECT_NAME)
    log.info(f"Output Dir: {out_dir}")
    log.info(f"Device: {device}")
    log.info(common.train_step_mode(device, bool(args.get("debug_nans"))))
    log.info(f"Model size: {n_params:,}")
    log.info("#" * 100)
    log.info("Codebook Parameters.")
    log.info(f"Low Res Patch size: {lr_codebook.patch_dim}")
    log.info(f"Low Res Num Embeddings: {lr_num_embeddings:,}")
    log.info(f"High Res Patch size: {hr_codebook.patch_dim}")
    log.info(f"High Res Num Embeddings: {hr_num_embeddings:,}")
    log.info("#" * 100)
    log.info("Transformer Parameters.")
    log.info("Mesh: {}{}{}{}".format(
        mesh.describe(),
        f" (microbatches={num_microbatches})" if n_pipe > 1 else "",
        " | ZeRO-1 optimizer sharding" if args.get("zero_opt") else "",
        f" | grad-accum {grad_accum}" if grad_accum > 1 else ""))
    if use_sliding_window:
        log.info(f"Sliding Window: {sliding_window:,}")
    log.info(f"Num Decoder Embedding: {cfg.num_dec_embedding:,}")
    log.info(f"Num Decoder Layers: {cfg.num_dec_layers:,}")
    log.info(f"Self Attention Heads: {cfg.self_attn_heads:,}")
    log.info(f"In Dim: {cfg.in_dim:,}")
    log.info(f"Out Dim: {cfg.out_dim:,}")
    log.info(f"Hidden Dim: {cfg.hidden_dim:,}")
    log.info(f"Hidden activation: {cfg.hidden_activation}")
    log.info("#" * 100)
    log.info("Training Parameters.")
    log.info(f"Max Epoch: {max_epoch:,}")
    log.info(f"Batch Size: {batch_size:,}")
    log.info(f"Model LR Update size: {lr_update_step:,}")
    log.info(f"Model Checkpoint step: {checkpoint_step:,}")
    log.info(f"Checkpoint backend: {backend}")
    if grad_accum > 1:
        log.info(f"Gradient accumulation: {grad_accum}")
    if ema_decay is not None:
        log.info(f"EMA decay: {ema_decay}")
    if grad_clip is not None:
        log.info(f"Gradient clip (global norm): {grad_clip}")
    log.info("#" * 100)

    # window starts on the host (the same on any device and on every
    # rank); preview sampling on the model's device
    window_generator = torch.Generator().manual_seed(seed)
    sample_generator = torch.Generator(device=device).manual_seed(seed)
    log_every = args.get("log_every", 1)
    throughput = common.ThroughputMeter(batch_size)
    # a checkpoint saved at counter N already holds update N, so a resumed
    # run continues at N + 1 and applies exactly the updates an
    # uninterrupted one would
    global_steps = 0 if resume_steps is None else resume_steps + 1
    if resume_steps is not None:
        log.info(f"Resuming at global step {global_steps:,}.")
    header = checkpoint_dict(cfg, train_base_model, sliding_window)

    def dump(images, name):
        if main:
            save_images(images.float().cpu().numpy(), name, out_dir,
                        logging=log.info)

    @torch.inference_mode()
    def preview(step, full=None):
        preview_model = model
        if full is not None:
            preview_model = common.init_for_restore(
                Transformer(cfg, device=device), device)
            preview_model.load_state_dict(full)
        fmap = torch.from_numpy(next(iter(test_loader))).to(device)
        dump(decoder(fmap), f"ground_truth_{step}")
        dump(decoder(lr_codebook(
            fmap, neighbourhood_range=lr_codebook.neighbourhood_range)),
            f"low_res_cond_{step}")
        dump(decoder(hr_codebook(
            fmap, neighbourhood_range=hr_codebook.neighbourhood_range)),
            f"high_res_example_{step}")
        tokens = generate_preview_tokens(
            DecodeEngine(preview_model), fmap, lr_codebook, train_base_model,
            lr_num_embeddings, hr_num_embeddings, total_hr_seq, temperature,
            sliding_window, sample_generator)
        dump(decoder(hr_codebook.get_quantized_image(tokens)),
             f"high_res_recon_{step}")

    stop = False
    try:
        for _ in range(max_epoch):
            total_loss = 0.0
            iteration_count = 0
            loss_acc = torch.zeros((), device=device)
            for index, feature_map in enumerate(loader):
                profiler.step(global_steps)
                batch = torch.from_numpy(feature_map).to(device)
                loss = train_step(batch, window_generator)
                iteration_count += 1
                loss_acc += loss
                should_sync = (log_every <= 1
                               or (global_steps + 1) % log_every == 0
                               or global_steps % checkpoint_step == 0)
                if should_sync:
                    total_loss = float(loss_acc)
                    common.check_finite(total_loss)

                if global_steps % checkpoint_step == 0:
                    save_checkpoint(
                        out_dir, global_steps, header, model, optimizer,
                        scheduler, ema_model=ema_model, parallel=parallel,
                        backend=backend, keep=args.get("keep_checkpoints"),
                        logging=log.info)
                    if not skip_preview:
                        # under the pipeline every rank joins the gather
                        full = (parallel.full_params(model) if n_pipe > 1
                                else None)
                        if previews_here:
                            preview(global_steps, full)

                lr_now = optim.current_lr(model_lr, lr_update_step,
                                          global_steps + 1)
                if should_sync:
                    avg = total_loss / iteration_count
                    log.info(
                        "Cum. Steps: {:,} | Steps: {:,} / {:,} | L.R.: "
                        "{:.8f} | Recon Loss: {:.5f}".format(
                            global_steps + 1, index + 1, len(loader),
                            lr_now, avg))
                    metrics.log(step=global_steps + 1, lr=lr_now,
                                ce_loss=avg,
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
