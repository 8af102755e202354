"""Cascade image generation (counterpart of ``qaig_tpu/infer/generate.py``).

For each stage "0", "1", ... of the config: load its transformer and
codebooks, generate the stage's tokens by rollout best-of-``num_beam``
sampling, decode them through the HR codebook and the FC decoder, and save
an image grid.  Stage "0" is the base model conditioned on random LR tokens;
each later stage is conditioned on the previous stage's tokens through its
encoder.  One eager loop, in the JAX package's dispatched order.
"""

import time

import torch

from qaig_tpu_torch.infer.decode import DecodeEngine, SamplerSettings
from qaig_tpu_torch.models.transformer import Transformer, TransformerConfig
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


def _random_tokens(shape, high, generator):
    """Uniform random token ids in [0, high) on the generator's device."""
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


@torch.inference_mode()
def run(args):
    """Generate ``num_images`` images through every stage of the config;
    returns the last stage's tokens (N, seq).  ``args`` holds the CLI
    flags; ``device`` defaults to ``cuda``."""
    device = common.select_device(args.get("device") or "cuda")
    out_dir = common.ensure_dir(args["out_dir"])
    num_images = args.get("num_images", 25)
    generator = torch.Generator(device=device).manual_seed(
        args.get("seed") or 0)
    config_dict = common.load_config(args["config_path"])

    status, dec_ckpt = load_model(args["decoder_path"])
    if not status:
        raise RuntimeError(
            "An error occured while loading decoder model checkpoint!")
    decoder, _ = common.decoder_from_checkpoint(dec_ckpt, device)
    # --bf16: serving precision; float32 (reference numerics) is the default
    dtype = torch.bfloat16 if args.get("bf16") else torch.float32
    decoder = common.cast_floats(decoder, dtype)

    def cast(module):
        return common.cast_floats(module, dtype)

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    prev_tokens = None
    for index, stage_cfg in config_dict.items():
        print(f"Model: {int(index):,}")
        st = _load_stage(index, stage_cfg, cast, device,
                         use_ema=bool(args.get("use_ema")))
        synchronize()
        t0 = time.perf_counter()
        if st["is_base"]:
            # random LR conditioning grid over the codebook's token grid
            lr_codebook = st["lr_codebook"]
            init_tokens = _random_tokens(
                (num_images, lr_codebook.seq_len), st["lr_num_embeddings"],
                generator)
            lr_input = None
            cond = decoder(lr_codebook.get_quantized_image(init_tokens))
            save_images(cond.float().cpu().numpy(), "recon_model_Cond",
                        out_dir, logging=print)
        else:
            lr_input = prev_tokens
            init_tokens = torch.full((num_images, 1),
                                     st["hr_num_embeddings"],
                                     dtype=torch.long, device=device)

        tokens = generate_stage_tokens(
            st["model"], stage_cfg, generator, st["is_base"],
            st["lr_num_embeddings"], st["hr_num_embeddings"],
            st["total_seq"], st["sliding_window"], lr_input=lr_input,
            init_tokens=init_tokens)
        recon = decoder(st["hr_codebook"].get_quantized_image(tokens))
        recon = recon.float().cpu().numpy()
        synchronize()
        print(f"Stage {index}: {st['total_seq']} tokens x {num_images} "
              f"images in {time.perf_counter() - t0:.3f} s")
        save_images(recon, f"recon_model_{index}", out_dir, logging=print)
        prev_tokens = tokens
    return prev_tokens
