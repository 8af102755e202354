"""Cascade image generation (counterpart of ``qaig_tpu/infer/generate.py``).

For each stage "0", "1", ... of the config: load its transformer and
codebooks, generate the stage's tokens by rollout best-of-``num_beam``
sampling, decode them through the HR codebook and the FC decoder, and save
an image grid.  Stage "0" is the base model conditioned on random LR tokens;
each later stage is conditioned on the previous stage's tokens through its
encoder.

Two paths, as in the JAX package: the dispatched loop (one eager step at a
time, stage by stage) and the fused cascade (:func:`_run_fused`: every
stage's rollout, the stage-0 conditioning image and every stage's pixel
decode as one function), which on CUDA runs from one CUDA graph
(``infer/graphs.py``) and on the CPU runs eagerly.  Both draw from the
generator in the same order and give the same tokens.

Sharded generation (:func:`make_decode_mesh`): each replica on the mesh's
data axis decodes its block of the images through every stage, and
``--num-model-shards`` splits each stage's MLPs over the model axis.
Without ``--multihost`` the mesh is a ``parallel/local.py::LocalMesh``
over every visible card of this one process, as ``qaig_tpu`` builds its
mesh over every local chip: a replica a data row on the row's first card,
its MLPs split over the row's cards (``shard_mlps_local_``).  Under
``--multihost`` it is the mesh of the run's processes, a replica a rank
(``parallel/sharding.py::shard_mlps_``).  Every draw is made for all the
images and each replica's rows taken (``infer/decode.py::RowSlice``), so
the tokens equal one card's.  The first replica (rank 0) gathers the
tokens and the images and writes the grids.

On a local mesh whose model axis is 1 (every visible card by default) the
fused cascade is the default on CUDA, as on one card: each replica runs
:func:`_run_fused` for its block from its own CUDA graph on its own card,
drawing through its ``RowSlice``, and every replica's replay is launched
before any output is read, so the cards decode at the same time (as
``CascadePipeline.generate`` does over a mesh).  This differs from
``qaig_tpu``, whose sharded path is dispatched (one SPMD program a step,
over every chip at once); the tokens are the same.  The dispatched loop
stays for ``--no-fused`` (its replicas run one after the other from this
thread) and for what ``qaig_tpu`` also dispatches: a model axis above 1
and ``--multihost``, where ``--fused`` raises.  Each stage's checkpoints
are read once and copied to every replica's card.

The local mesh does not go through ``CascadePipeline(mesh=...)``: its
batch-keyed draws are the pipeline's (one stage-0 conditioning token an
image), and ``generate``'s are ``qaig_tpu``'s ``generate``'s (a stage-0
grid of the LR codebook's length an image).
"""

import contextlib
import copy
import time

import torch

from qaig_tpu_torch.infer.decode import DecodeEngine, RowSlice, SamplerSettings
from qaig_tpu_torch.infer.graphs import (GraphRunner, StageClock,
                                         product_warmup)
from qaig_tpu_torch.models.transformer import Transformer, TransformerConfig
from qaig_tpu_torch.parallel import comm
from qaig_tpu_torch.parallel.local import (LocalMesh, local_devices,
                                           local_mesh_for_batch,
                                           shard_mlps_local_)
from qaig_tpu_torch.parallel.mesh import make_mesh_for_batch
from qaig_tpu_torch.parallel.sharding import shard_mlps_
from qaig_tpu_torch.train import common
from qaig_tpu_torch.utils.checkpoint import load_model
from qaig_tpu_torch.utils.image_io import save_images


def transformer_from_checkpoint(ckpt, device, logging=print, use_ema=False):
    """Rebuild a Transformer from its self-describing checkpoint dict.
    ``use_ema`` restores ``model_ema`` when the checkpoint has it."""
    train_base_model = ckpt["train_base_model"]
    cfg = TransformerConfig(
        use_encoder=not train_base_model,
        use_pos_cond=ckpt["use_sliding_window"],
        num_enc_layers=ckpt["num_enc_layers"] or 0,
        num_dec_layers=ckpt["num_dec_layers"],
        num_enc_embedding=ckpt["num_enc_embedding"] or 1,
        num_dec_embedding=ckpt["num_dec_embedding"],
        self_attn_heads=ckpt["self_attn_heads"],
        cross_attn_heads=ckpt["cross_attn_heads"] or 0,
        in_dim=ckpt["transformer_in_dim"],
        out_dim=ckpt["transformer_out_dim"],
        hidden_dim=ckpt["transformer_hidden_dim"],
        hidden_activation=ckpt["hidden_activation"])
    model = common.init_for_restore(Transformer(cfg, device=device), device)
    state = ckpt["model"]
    if use_ema:
        if ckpt.get("model_ema") is not None:
            state = ckpt["model_ema"]
        else:
            logging("Checkpoint has no model_ema; using live weights.")
    common.restore_model_state(model, state, logging=logging)
    return model, ckpt


def make_decode_mesh(num_images, n_model=1, device=None, devices=None):
    """The mesh of sharded generation: the images split over the data
    axis, whose size is the largest divisor of ``num_images`` that fits;
    with ``n_model > 1`` each stage's MLPs tensor-parallel over the model
    axis.  Under ``--multihost``, the run's processes
    (``parallel/mesh.py``: an idle process raises); else a
    :class:`LocalMesh` over ``devices``, by default every visible card
    (one CPU device on the CPU, only ``device`` when it names its index):
    idle cards are logged."""
    if comm.active():
        return make_mesh_for_batch(num_images, n_model=n_model, device=device)
    if devices is None:
        device = torch.device(device or "cuda")
        devices = (local_devices(device) if device.index is None
                   else [device])
    return local_mesh_for_batch(num_images, n_model, devices)


def _random_tokens(shape, high, generator):
    """Uniform random token ids in [0, high) on the generator's device
    (this rank's rows of the draw for all ranks, from a
    :class:`RowSlice`)."""
    if isinstance(generator, RowSlice):
        return generator.randint(high, shape)
    return torch.randint(0, high, shape, generator=generator,
                         device=generator.device)


def generate_stage_tokens(model, stage_cfg, generator, is_base_stage,
                          lr_num_embeddings, hr_num_embeddings, total_seq,
                          sliding_window, lr_input=None, init_tokens=None):
    """Run one cascade stage; returns HR-vocabulary tokens
    (N, total_seq)."""
    engine = DecodeEngine(model)
    shift = lr_num_embeddings if is_base_stage else 0
    settings = SamplerSettings(
        temperature=stage_cfg["temperature"],
        end_token=hr_num_embeddings,
        end_mode="mask",
        index_shift=shift,
        pos_offset=1)  # the reference's generation-time position offset
    tokens = engine.rollout_generate(
        init_tokens, total_seq, generator, settings,
        num_beam=stage_cfg["num_beam"], beam_width=stage_cfg["beam_width"],
        x_enc=None if is_base_stage else lr_input,
        sliding_window=sliding_window)
    return tokens - shift


def _load_stage(index, stage_cfg, cast, device, use_ema=False,
                logging=print):
    """Load one cascade stage's codebooks + transformer."""
    lr_codebook = None
    lr_num_embeddings = 0
    if stage_cfg.get("lr_codebook_path") is not None:
        status, lr_ckpt = load_model(stage_cfg["lr_codebook_path"],
                                     logging=logging)
        if not status:
            raise RuntimeError(
                "An error occured while loading codebook checkpoint!")
        lr_codebook = cast(common.codebook_from_checkpoint(
            lr_ckpt, device, logging=logging))
        lr_num_embeddings = lr_codebook.num_embeddings

    status, hr_ckpt = load_model(stage_cfg["hr_codebook_path"],
                                 logging=logging)
    if not status:
        raise RuntimeError(
            "An error occured while loading codebook checkpoint!")
    hr_codebook = cast(common.codebook_from_checkpoint(hr_ckpt, device,
                                                       logging=logging))
    total_seq = hr_codebook.seq_len
    if total_seq % stage_cfg["beam_width"] != 0:
        raise ValueError("Invalid value for beam_width!")

    status, model_ckpt = load_model(stage_cfg["model_path"], logging=logging)
    if not status:
        raise RuntimeError(
            "An error occured while loading model checkpoint!")
    model, model_ckpt = transformer_from_checkpoint(
        model_ckpt, device, logging=logging, use_ema=use_ema)
    return {
        "index": index, "stage_cfg": stage_cfg, "model": cast(model),
        "lr_codebook": lr_codebook, "lr_num_embeddings": lr_num_embeddings,
        "hr_codebook": hr_codebook,
        "hr_num_embeddings": hr_codebook.num_embeddings,
        "total_seq": total_seq,
        "sliding_window": (model_ckpt["sliding_window"]
                           if model_ckpt["use_sliding_window"] else None),
        "is_base": index == "0"}


def _stage_tokens(st, num_images, generator, prev_tokens):
    """One stage's draws and rollout: the stage-0 random conditioning grid
    (drawn first), then the rollout (conditioned on ``prev_tokens`` past
    stage 0).  Returns (the conditioning tokens (stage 0, else None),
    tokens)."""
    init_tokens = None
    if st["is_base"]:
        init_tokens = _random_tokens(
            (num_images, st["lr_codebook"].seq_len), st["lr_num_embeddings"],
            generator)
        start = init_tokens
    else:
        start = torch.full((num_images, 1), st["hr_num_embeddings"],
                           dtype=torch.long, device=generator.device)
    tokens = generate_stage_tokens(
        st["model"], st["stage_cfg"], generator, st["is_base"],
        st["lr_num_embeddings"], st["hr_num_embeddings"], st["total_seq"],
        st["sliding_window"], lr_input=prev_tokens, init_tokens=start)
    return init_tokens, tokens


def _stage_images(st, decoder, init_tokens, tokens):
    """(conditioning image (stage 0, else None), reconstruction), float32:
    the stage's pixel decode."""
    cond = None
    if init_tokens is not None:
        cond = decoder(st["lr_codebook"].get_quantized_image(
            init_tokens)).float()
    recon = decoder(st["hr_codebook"].get_quantized_image(tokens)).float()
    return cond, recon


def _run_fused(stages, decoder, num_images, generator, clock=None):
    """The whole cascade -- every stage's rollout, the stage-0 conditioning
    reconstruction and every stage's pixel decode -- as one function with
    no host read of a device value, so that a CUDA graph can hold it.  The
    dispatched loop runs the same stages one at a time, so both draw from
    ``generator`` in one order and give the same tokens.  ``clock`` (a
    ``graphs.StageClock``) marks each stage's rollout (``stage_<i>``) and
    pixel decodes (``decoder``).  Returns (conditioning image, one
    reconstruction per stage, last tokens)."""
    cond, recons, tokens = None, [], None
    if clock is not None:
        clock.start()
    for i, st in enumerate(stages):
        init_tokens, tokens = _stage_tokens(st, num_images, generator,
                                            tokens)
        if clock is not None:
            clock.mark(f"stage_{i}")
        stage_cond, recon = _stage_images(st, decoder, init_tokens, tokens)
        if clock is not None:
            clock.mark("decoder")
        cond = stage_cond if stage_cond is not None else cond
        recons.append(recon)
    return cond, recons, tokens


def library_warmup(decoder, codebook, dtype, device):
    """A :class:`GraphRunner`'s warm-up for the cascade: one image's pixel
    decode (cuDNN's convolutions) and ``graphs.product_warmup`` in
    ``dtype`` (cuBLAS and cuBLASLt), so that a capture finds both
    libraries set up in its thread."""
    def warmup():
        tokens = torch.zeros(1, codebook.seq_len, dtype=torch.long,
                             device=device)
        decoder(codebook.get_quantized_image(tokens))
        product_warmup(dtype, device)
    return warmup


def _load_decoder(decoder_path, device, dtype):
    status, dec_ckpt = load_model(decoder_path)
    if not status:
        raise RuntimeError(
            "An error occured while loading decoder model checkpoint!")
    decoder, _ = common.decoder_from_checkpoint(dec_ckpt, device)
    return common.cast_floats(decoder, dtype)


def use_fused(fused, device, sharded=False):
    """The path ``generate.run`` takes: ``fused`` (``--fused`` /
    ``--no-fused``) when given, else fused on CUDA and dispatched on the
    CPU.  A data axis keeps the fused path (a graph a replica); a
    ``sharded`` run (a model axis above 1, or ``--multihost``) is
    dispatched, and ``--fused`` raises there, as in ``qaig_tpu``."""
    if sharded:
        if fused:
            raise ValueError(
                "--fused requires unsharded generation (one process, a "
                "model axis of 1); drop --multihost / --num-model-shards "
                "or use --no-fused.")
        return False
    return device.type == "cuda" if fused is None else bool(fused)


@torch.inference_mode()
def run(args, cache=None, devices=None):
    """Generate ``num_images`` images through every stage of the config;
    returns the last stage's tokens (N, seq).  ``args`` holds the CLI
    flags; ``device`` defaults to ``cuda``, ``fused`` to :func:`use_fused`.

    ``devices``: the devices of the in-process mesh (every visible card by
    default; a list may repeat a device), as ``CascadePipeline(mesh=...)``
    takes them; :func:`make_decode_mesh`.

    ``cache``: a dict the caller keeps between calls.  The fused path
    keeps every replica's loaded stages, generator and CUDA graphs there,
    so a later call with the same config, checkpoints, precision and
    devices re-seeds the generators and, at a batch size seen before,
    replays that batch's graphs instead of loading and capturing again."""
    device = common.select_device(args.get("device") or "cuda")
    device = common.maybe_init_distributed(args, device)
    common.ensure_dir(args["out_dir"])
    # --bf16: serving precision; float32 (reference numerics) is the default
    dtype = torch.bfloat16 if args.get("bf16") else torch.float32
    n_model = int(args.get("num_model_shards") or 1)
    fused = use_fused(args.get("fused"), device,
                      sharded=comm.world_size() > 1 or n_model > 1)
    profiler = None
    if args.get("profile_dir"):
        # the whole generation, one Chrome trace: profile_dir/trace_0.json
        profiler = common.Profiler(dict(args, profile_start=0))
        profiler.step(0)
    try:
        mesh = make_decode_mesh(args.get("num_images", 25), n_model, device,
                                devices)
        print(f"Generation mesh: {mesh.describe()}")
        if fused:
            homes = ([row[0] for row in mesh.grid]
                     if isinstance(mesh, LocalMesh) else [device])
            return _generate_fused(args, homes, dtype, cache)
        return _generate_dispatched(args, device, dtype, mesh)
    finally:
        if profiler is not None:
            profiler.close()


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stage_to(st, device):
    """A copy of a loaded stage (:func:`_load_stage`) on ``device``: the
    checkpoints are read once for every replica."""
    copied = dict(st)
    for key in ("model", "lr_codebook", "hr_codebook"):
        if st[key] is not None:
            copied[key] = copy.deepcopy(st[key]).to(device)
    return copied


def _concat_on(blocks, device):
    """The replicas' blocks, in order, as one tensor on ``device`` (the
    first replica's card)."""
    if len(blocks) == 1:
        return blocks[0]
    return torch.cat([block.to(device) for block in blocks])


def _on(device):
    """``device`` as the current CUDA device around a replica's work."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _generate_dispatched(args, device, dtype, mesh):
    """The dispatched loop: load, generate and save one stage at a time.
    Over a sharded ``mesh`` each replica decodes its images (and its MLP
    shards): on a :class:`LocalMesh` every data row's replica in this
    process, one after the other, else this rank's.  The first replica
    gathers the tokens, decodes the pixels and writes.  Returns all the
    images' last tokens (on the host under ``--multihost``)."""
    num_images = args.get("num_images", 25)
    n_data = mesh.size("data")
    local = isinstance(mesh, LocalMesh)
    if local:
        rows = mesh.grid
        homes = [row[0] for row in rows]
        coords = range(n_data)
    else:
        rows, homes, coords = [None], [device], [mesh.index("data")]
    draws = []
    for home, d in zip(homes, coords):
        generator = torch.Generator(device=home).manual_seed(
            args.get("seed") or 0)
        draws.append(RowSlice(generator, d, n_data) if n_data > 1
                     else generator)
    local_images = num_images // n_data
    main = common.is_main_process()

    def gather(parts):
        if local:
            return _concat_on(parts, homes[0])
        if mesh.distributed:   # every image's rows, on every rank
            return common.gather_replicated(parts[0], mesh).to(device)
        return parts[0]

    decoder = _load_decoder(args["decoder_path"], homes[0], dtype)
    prev = [None] * len(homes)
    tokens = None
    for index, stage_cfg in common.load_config(args["config_path"]).items():
        print(f"Model: {int(index):,}")
        loaded = _load_stage(index, stage_cfg,
                             lambda m: common.cast_floats(m, dtype),
                             homes[0], use_ema=bool(args.get("use_ema")))
        stages = [loaded] + [_stage_to(loaded, home) for home in homes[1:]]
        for st, row in zip(stages, rows):
            if local:
                shard_mlps_local_(st["model"], row)
            else:
                shard_mlps_(st["model"], mesh)
        for home in homes:
            _synchronize(home)
        t0 = time.perf_counter()
        inits = []
        for i, (st, home, draw) in enumerate(zip(stages, homes, draws)):
            with _on(home):
                init_tokens, prev[i] = _stage_tokens(st, local_images, draw,
                                                     prev[i])
            inits.append(init_tokens)
        tokens = gather(prev)
        init_tokens = None if inits[0] is None else gather(inits)
        if main:
            cond, recon = _stage_images(stages[0], decoder, init_tokens,
                                        tokens)
            if cond is not None:
                save_images(cond.cpu().numpy(), "recon_model_Cond",
                            args["out_dir"], logging=print)
            recon = recon.cpu().numpy()
        for home in homes:
            _synchronize(home)
        print(f"Stage {index}: {stages[0]['total_seq']} tokens x "
              f"{num_images} images in {time.perf_counter() - t0:.3f} s")
        if main:
            save_images(recon, f"recon_model_{index}", args["out_dir"],
                        logging=print)
    return tokens


def _runner(home, decoder, stages, dtype):
    """A replica's :class:`GraphRunner` on its card (None on the CPU, where
    the fused cascade runs eagerly)."""
    if home.type != "cuda":
        return None
    return GraphRunner(home, library_warmup(
        decoder, stages[-1]["hr_codebook"], dtype, home))


def _load_replicas(args, homes, dtype):
    """Every replica of the fused path: its stages, decoder, generator,
    draws (a :class:`RowSlice` of its rows when there are several), graph
    runner and stage clocks (``graphs.StageClock``, by batch), on its
    card.  The checkpoints are read once, on the
    first card, and copied to the others."""
    use_ema = bool(args.get("use_ema"))
    decoder = _load_decoder(args["decoder_path"], homes[0], dtype)
    stages = [_load_stage(index, stage_cfg,
                          lambda m: common.cast_floats(m, dtype), homes[0],
                          use_ema=use_ema)
              for index, stage_cfg in common.load_config(
                  args["config_path"]).items()]
    replicas = []
    for d, home in enumerate(homes):
        own = {"stages": stages, "decoder": decoder} if d == 0 else {
            "stages": [_stage_to(st, home) for st in stages],
            "decoder": copy.deepcopy(decoder).to(home)}
        generator = torch.Generator(device=home)
        replicas.append(dict(
            own, home=home, generator=generator, clocks={},
            draw=(RowSlice(generator, d, len(homes)) if len(homes) > 1
                  else generator),
            runner=_runner(home, own["decoder"], own["stages"], dtype)))
    return replicas


def _generate_fused(args, homes, dtype, cache):
    """The fused cascade (:func:`_run_fused`) on each replica's card
    (``homes``, one a data row): on CUDA from the replica's CUDA graph of
    the batch, captured at its first call, every replica's replay started
    before any output is read; on the CPU eagerly, one replica after the
    other.  The first replica gathers the images and tokens."""
    num_images = args.get("num_images", 25)
    local_images = num_images // len(homes)
    key = (str(args["config_path"]), str(args["decoder_path"]), dtype,
           bool(args.get("use_ema")), tuple(str(home) for home in homes))
    held = cache if cache is not None else {}
    if held.get("key") != key:
        replicas = _load_replicas(args, homes, dtype)
        held.clear()
        held.update(key=key, replicas=replicas)
    replicas = held["replicas"]
    stages = replicas[0]["stages"]
    for replica in replicas:
        replica["generator"].manual_seed(args.get("seed") or 0)
    print(f"Fused single-dispatch cascade: {len(stages)} stages"
          + (f", a graph on each of {len(homes)} replicas"
             if len(homes) > 1 else ""))
    for home in homes:
        _synchronize(home)
    t0 = time.perf_counter()
    steps0 = DecodeEngine.rollout_steps
    parts, captured = [], []
    for replica in replicas:
        clock = replica["clocks"].setdefault(local_images,
                                             StageClock(replica["home"]))

        def cascade(replica=replica, clock=clock):
            return _run_fused(replica["stages"], replica["decoder"],
                              local_images, replica["draw"], clock)
        runner = replica["runner"]
        with _on(replica["home"]):
            if runner is None:
                parts.append(cascade())
                continue
            if local_images not in runner.graphs:
                captured.append(runner)
            parts.append(runner(local_images, cascade,
                                generator=replica["generator"]))
    conds, recons, tokens = zip(*parts)
    cond = (None if conds[0] is None
            else _concat_on(conds, homes[0]).cpu().numpy())
    recons = [_concat_on(blocks, homes[0]).cpu().numpy()
              for blocks in zip(*recons)]
    tokens = _concat_on(tokens, homes[0])
    for home in homes:
        _synchronize(home)
    seconds = time.perf_counter() - t0
    note = "; ".join(
        f"capture {graph.capture_s:.3f} s, instantiation "
        f"{graph.instantiate_s:.3f} s"
        for graph in (runner.graphs[local_images] for runner in captured))
    parts_s = ", ".join(f"{name} {secs:.4f}" for name, secs in
                        replicas[0]["clocks"][local_images].seconds().items())
    print(f"Cascade: {sum(st['total_seq'] for st in stages)} tokens x "
          f"{num_images} images in {seconds:.3f} s"
          + (f" (first call: {note})" if note else "")
          + f"; {DecodeEngine.rollout_steps - steps0} rollout steps; the "
          f"first replica's call by part (s): {parts_s}")
    if cond is not None:
        save_images(cond, "recon_model_Cond", args["out_dir"], logging=print)
    for st, recon in zip(stages, recons):
        print(f"Model: {int(st['index']):,}")
        save_images(recon, f"recon_model_{st['index']}", args["out_dir"],
                    logging=print)
    return tokens
