#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``qaig_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device -- require CUDA, print the card's name and power limit, turn
   TF32 off for matmuls and cuDNN;
2. build -- compile every CUDA kernel of the port from
   ``qaig_tpu_torch/csrc`` (one nvcc per source, in parallel);
3. kernels -- hold each kernel against its plain PyTorch version on the
   card, in bf16, at the generation path's shapes (atol 2e-2), and time
   kernel, plain version and (for full-sequence attention) PyTorch's
   ``scaled_dot_product_attention`` as a yardstick;
4. reference -- a small cascade stage decoded greedily in float32 on the
   card (kernels) and on the CPU (plain versions) must give the same
   tokens;
5. main path -- the full-width 3-stage cascade of ``bench.py --scale full``
   with seeded random weights, written as ``qaig_tpu``-schema checkpoints
   and generated through ``qaig_tpu_torch.infer.generate.run`` in bf16 on
   8 images; then one stage-2 rollout with an int8 prefix.  The kernels'
   launch counts are set to 0 before each run and read after it.

It prints a ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name and power limit, and, last, the device JSON line.
``--json-out PATH`` also writes every per-shape measurement there;
``--profile`` adds a ``torch.profiler`` window over the first 64 stage-2
tokens (device busy share and the kernels that take the time).
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
ATOL = 2e-2                        # bf16 kernel vs plain version
H, DH = 8, 64
DECODE_SHAPES = [  # (N, B, bw, S): stage-0, stage-1/2 and crossing widths
    (16, 32, 16, 32), (16, 4, 8, 96), (16, 4, 8, 256), (16, 4, 7, 256)]
FLASH_N = 8
FLASH_S = (1, 16, 64, 255, 256)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2: device and build
# ---------------------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}"
        f" cudnn={torch.backends.cudnn.allow_tf32}")
    return name, smi


def phase_build():
    from qaig_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.build()
    seconds = time.perf_counter() - t0
    log(f"[build] {', '.join(cuda_build.SOURCES)} built in {seconds:.1f} s "
        f"into {cuda_build.BUILD_DIR}")
    for name in cuda_build.SOURCES:
        report = cuda_build.BUILD_DIR / f"{name}.log"
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

class Timer:
    """Device time of one call, from CUDA events around each call, with the
    L2 cache flushed before it (the path reaches each layer's K/V after
    other layers' work).  A spin kernel first holds the stream while the
    host queues every call, so host-side launch overhead does not show in
    the events: the number is the device's."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.uint8,
                                     device="cuda")

    def __call__(self, fn, iters=20, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        torch.cuda._sleep(200_000_000)   # ~0.1 s: the host runs ahead
        for i in range(iters):
            self.flush_buf.zero_()
            starts[i].record()
            fn()
            ends[i].record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound(nbytes, flops, kind="bf16"):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def check_decode(torch, timer, records):
    from qaig_tpu_torch.ops import decode_attention as da
    from qaig_tpu_torch.ops.kv_quant import quantize_kv_t
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda") * 0.5).to(
            bf16)

    for n, b, bw, s in DECODE_SHAPES:
        q = rnd(n * b, 1, H * DH)
        kt, vt = rnd(n, H, DH, s), rnd(n, H, DH, s)
        kb, vb = rnd(n * b, H, bw, DH), rnd(n * b, H, bw, DH)
        k8, ks = quantize_kv_t(kt)
        v8, vs = quantize_kv_t(vt)
        for index0, block_index in ((1, 0), (s // 2, bw // 2), (s, bw - 1)):
            for kernel in ("shared_prefix_attention_fused_t",
                           "shared_prefix_attention_fused_int8"):
                if kernel.endswith("int8"):
                    args = (q, k8, ks, v8, vs, kb, vb, index0, block_index)
                    plain_args = (q, k8, v8, kb, vb, index0, block_index)
                    plain_kw = {"k_scale": ks, "v_scale": vs}
                    prefix_bytes = 2 * n * H * index0 * (DH + 2)
                else:
                    args = (q, kt, vt, kb, vb, index0, block_index)
                    plain_args = args
                    plain_kw = {}
                    prefix_bytes = 2 * n * H * index0 * DH * 2
                fn = getattr(da, kernel)

                def run_kernel():
                    return fn(*args)

                def run_plain():
                    return da.shared_prefix_attention_reference(
                        *plain_args, **plain_kw)

                got = run_kernel()
                want = run_plain()
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                nbytes = (prefix_bytes + 2 * q.numel() * 2
                          + 2 * n * b * H * (block_index + 1) * DH * 2)
                flops = 4 * n * b * H * DH * (index0 + block_index + 1)
                bound_ms, bound_by = bound(nbytes, flops)
                rec = {"name": kernel, "shape": {
                    "N": n, "B": b, "bw": bw, "S": s, "index0": index0,
                    "block_index": block_index}, "max_abs_err": err,
                    "ms": timer(run_kernel), "plain_ms": timer(run_plain),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None}
                records.append(rec)
                log(f"[kernels] {kernel} N={n} B={b} bw={bw} S={s} "
                    f"index0={index0} block_index={block_index}: "
                    f"max_abs_err={err:.3e} ms={rec['ms']:.4f} "
                    f"plain_ms={rec['plain_ms']:.4f} "
                    f"bound_ms={bound_ms:.5f} ({bound_by})")
                if not err <= ATOL:
                    raise SystemExit(f"{kernel} disagrees with its plain "
                                     f"version: {err} > {ATOL}")


def check_flash(torch, timer, records):
    import torch.nn.functional as F
    from qaig_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)
    n, d = FLASH_N, H * DH
    for s in FLASH_S:
        q, k, v = ((torch.randn(n, s, d, generator=gen, device="cuda")
                    * 0.5).to(torch.bfloat16) for _ in range(3))
        for causal in (True, False):
            def run_kernel():
                return fa.flash_attention(q, k, v, H, causal=causal)

            def run_plain():
                return fa.flash_attention_reference(q, k, v, H, causal)

            def run_library():
                def heads(x):
                    return x.view(n, s, H, DH).transpose(1, 2)
                return F.scaled_dot_product_attention(
                    heads(q), heads(k), heads(v), is_causal=causal)

            got = run_kernel()
            want = run_plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            pairs = s * (s + 1) // 2 if causal else s * s
            bound_ms, bound_by = bound(4 * n * s * d * 2,
                                       4 * n * H * pairs * DH)
            rec = {"name": "flash_attention", "shape": {
                "N": n, "S": s, "H": H, "dh": DH, "causal": causal},
                "max_abs_err": err, "ms": timer(run_kernel),
                "plain_ms": timer(run_plain), "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": timer(run_library)}
            records.append(rec)
            log(f"[kernels] flash_attention N={n} S={s} causal={causal}: "
                f"max_abs_err={err:.3e} ms={rec['ms']:.4f} "
                f"plain_ms={rec['plain_ms']:.4f} "
                f"sdpa_ms={rec['library_ms']:.4f} "
                f"bound_ms={bound_ms:.5f} ({bound_by})")
            if not err <= ATOL:
                raise SystemExit(f"flash_attention disagrees with its plain "
                                 f"version: {err} > {ATOL}")


# ---------------------------------------------------------------------------
# phase 4: a small cascade stage, card (kernels) against CPU (plain)
# ---------------------------------------------------------------------------

def check_reference(torch):
    """Greedy float32 rollouts of a small windowed encoder-decoder stage
    (dh 32; window 8 gives a crossing segment and steady windowed
    segments) must give the same tokens on the card as on the CPU."""
    from qaig_tpu_torch.infer import decode
    from qaig_tpu_torch.models.core import init_parameters
    from qaig_tpu_torch.models.transformer import (Transformer,
                                                   TransformerConfig)

    cfg = TransformerConfig(
        use_encoder=True, use_pos_cond=True, num_enc_layers=2,
        num_dec_layers=2, num_enc_embedding=32, num_dec_embedding=33,
        self_attn_heads=4, cross_attn_heads=4, in_dim=128, out_dim=33,
        hidden_dim=256)
    cpu_model = init_parameters(Transformer(cfg),
                                torch.Generator().manual_seed(3))
    for name, p in cpu_model.named_parameters():
        if "scale" in name or "shift" in name:  # make positions matter
            p.data.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(
                len(name)))
    cpu_model.requires_grad_(False)
    cuda_model = Transformer(cfg, device="cuda").requires_grad_(False)
    cuda_model.load_state_dict(cpu_model.state_dict())
    gen = torch.Generator().manual_seed(4)
    x_enc = torch.randint(0, 32, (2, 16), generator=gen)
    init = torch.full((2, 1), 32, dtype=torch.long)
    settings = decode.SamplerSettings(end_token=32, pos_offset=1)
    sample = decode._categorical
    decode._categorical = lambda logits, generator: logits.argmax(dim=-1)
    try:
        out = {}
        for device, model in (("cpu", cpu_model), ("cuda", cuda_model)):
            out[device] = decode.DecodeEngine(model).rollout_generate(
                init.to(device), 16, torch.Generator(device=device),
                settings, num_beam=3, beam_width=4,
                x_enc=x_enc.to(device), sliding_window=8).cpu()
    finally:
        decode._categorical = sample
    same = bool(torch.equal(out["cpu"], out["cuda"]))
    log(f"[reference] small windowed stage, greedy float32: card tokens "
        f"{'equal' if same else 'DIFFER from'} the CPU's "
        f"({out['cuda'].tolist()[0][:8]}...)")
    if not same:
        raise SystemExit("card and CPU generations disagree")


# ---------------------------------------------------------------------------
# phase 5: the full-width cascade through the entry point
# ---------------------------------------------------------------------------

FULL = dict(in_dim=512, hidden=2048, enc_layers=5, dec_layers=7, heads=8,
            k=512, image_dim=(32, 32), latent_c=4,
            patches=[(32, 32), (8, 8), (4, 4), (2, 2)],
            sliding={2: 256}, beams={0: (32, 16), 1: (4, 8), 2: (4, 8)})


def seq_len(patch):
    (h, w), (ph, pw) = FULL["image_dim"], patch
    return (h // ph) * (w // pw)


def write_full_cascade(torch, root, seed, device="cuda"):
    """Seeded random weights of ``bench.py --scale full``'s cascade,
    written as ``qaig_tpu``-schema checkpoints with the port's writer.
    Returns (config path, decoder path, stage-2 checkpoint path)."""
    from qaig_tpu_torch.convert import to_jax_state
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.models.conv_nets import ConvNetConfig, FCDecoder
    from qaig_tpu_torch.models.core import init_parameters
    from qaig_tpu_torch.models.transformer import (Transformer,
                                                   TransformerConfig)
    from qaig_tpu_torch.utils.checkpoint import save_model

    f = FULL
    gen = torch.Generator(device=device).manual_seed(seed)

    def weights(module):
        return to_jax_state(init_parameters(module, gen))

    dec_cfg = dict(num_layers=2, image_channel=3, min_channel=256,
                   max_channel=512, latent_channel=f["latent_c"],
                   hidden_activation_type="silu")
    decoder = FCDecoder(ConvNetConfig(**dec_cfg), device=device)
    save_model(dict(dec_cfg, use_final_enc_activation=True,
                    encoder_activation_type="silu",
                    use_final_dec_activation=True,
                    decoder_activation_type="tanh",
                    model={f"fc_decoder.{k}": v
                           for k, v in weights(decoder).items()}),
               root, "decoder.pt")
    for i, patch in enumerate(f["patches"]):
        cb = Codebook(patch_dim=patch, image_dim=f["image_dim"],
                      image_channel=f["latent_c"], num_embeddings=f["k"],
                      init_neighbour_range=1, device=device)
        save_model({"patch_dim": patch, "image_dim": f["image_dim"],
                    "image_C": f["latent_c"], "num_embeddings": f["k"],
                    "neighbourhood_range": 1, "checkpoint": weights(cb)},
                   root, f"codebook_{i}.pt")
    config = {}
    for i in range(3):
        base = i == 0
        window = f["sliding"].get(i)
        cfg = TransformerConfig(
            use_encoder=not base, use_pos_cond=window is not None,
            num_enc_layers=0 if base else f["enc_layers"],
            num_dec_layers=f["dec_layers"],
            num_enc_embedding=1 if base else f["k"],
            num_dec_embedding=2 * f["k"] if base else f["k"] + 1,
            self_attn_heads=f["heads"],
            cross_attn_heads=0 if base else f["heads"],
            in_dim=f["in_dim"], out_dim=f["k"] + 1, hidden_dim=f["hidden"])
        model = Transformer(cfg, device=device)
        save_model({
            "train_base_model": base,
            "use_sliding_window": window is not None,
            "sliding_window": window,
            "num_enc_layers": None if base else f["enc_layers"],
            "num_dec_layers": f["dec_layers"],
            "num_enc_embedding": None if base else f["k"],
            "num_dec_embedding": cfg.num_dec_embedding,
            "self_attn_heads": f["heads"],
            "cross_attn_heads": None if base else f["heads"],
            "transformer_in_dim": f["in_dim"],
            "transformer_out_dim": cfg.out_dim,
            "transformer_hidden_dim": f["hidden"],
            "hidden_activation": "silu",
            "model": weights(model)}, root, f"transformer_{i}.pt")
        del model
        num_beam, beam_width = f["beams"][i]
        ckpt = Path(root) / "models_checkpoint"
        config[str(i)] = {
            "model_path": str(ckpt / f"transformer_{i}.pt"),
            "lr_codebook_path": str(ckpt / f"codebook_{i}.pt"),
            "hr_codebook_path": str(ckpt / f"codebook_{i + 1}.pt"),
            "temperature": 1.0, "num_beam": num_beam,
            "beam_width": beam_width}
    config_path = Path(root) / "generate.json"
    config_path.write_text(json.dumps(config, indent=1))
    ckpt = Path(root) / "models_checkpoint"
    return (config_path, ckpt / "decoder.pt", ckpt / "transformer_2.pt")


def synchronize(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_launches():
    from qaig_tpu_torch.ops import decode_attention as da
    from qaig_tpu_torch.ops import flash_attention as fa
    fa.flash_attention.launches = 0
    da.shared_prefix_attention_fused_t.launches = 0
    da.shared_prefix_attention_fused_int8.launches = 0


def read_launches():
    from qaig_tpu_torch.ops import decode_attention as da
    from qaig_tpu_torch.ops import flash_attention as fa
    return {"flash_attention": fa.flash_attention.launches,
            "shared_prefix_attention_fused_t":
                da.shared_prefix_attention_fused_t.launches,
            "shared_prefix_attention_fused_int8":
                da.shared_prefix_attention_fused_int8.launches}


def run_main_path(torch, workdir, seed=0, num_images=8, device="cuda",
                  profile=False):
    """The cascade through ``generate.run`` (bf16), then one stage-2
    rollout with an int8 prefix (and, with ``profile``, a profiled
    stage-2 window).  Returns (launches, timings)."""
    import numpy as np
    from qaig_tpu_torch.infer import generate
    from qaig_tpu_torch.infer.decode import DecodeEngine, SamplerSettings

    t0 = time.perf_counter()
    config_path, decoder_path, stage2_path = write_full_cascade(
        torch, workdir, seed, device)
    log(f"[main] full-width cascade written in "
        f"{time.perf_counter() - t0:.1f} s")

    saved = {}
    save_images = generate.save_images

    def recording_save(images, name, dest, **kw):
        saved[name] = images
        return save_images(images, name, dest, **kw)

    generate.save_images = recording_save
    try:
        synchronize(torch, device)
        reset_launches()
        t0 = time.perf_counter()
        tokens = generate.run({
            "device": device, "config_path": str(config_path),
            "decoder_path": str(decoder_path), "num_images": num_images,
            "seed": seed, "bf16": True,
            "out_dir": str(Path(workdir) / "out")})
        synchronize(torch, device)
        run_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        generate.save_images = save_images
    k = FULL["k"]
    out_seq = seq_len(FULL["patches"][-1])
    cond_seq = seq_len(FULL["patches"][-2])
    side = FULL["image_dim"][0] * 4   # the decoder's two 2x upsamples
    tokens = tokens.cpu()
    log(f"[main] generate.run: {num_images} images in {run_s:.3f} s; "
        f"launches {launches}")
    if tokens.shape != (num_images, out_seq):
        raise SystemExit(f"unexpected token grid {tuple(tokens.shape)}")
    if int(tokens.min()) < 0 or int(tokens.max()) >= k:
        raise SystemExit("tokens out of the HR vocabulary range")
    for name in ("recon_model_Cond", "recon_model_0", "recon_model_1",
                 "recon_model_2"):
        pixels = saved[name]
        if pixels.shape != (num_images, 3, side, side):
            raise SystemExit(f"{name}: unexpected shape {pixels.shape}")
        if not np.isfinite(pixels).all():
            raise SystemExit(f"{name}: non-finite pixels")
    log(f"[main] tokens in [0, {k}), decoded pixels finite, "
        f"{side}x{side}x3")
    for name in ("flash_attention", "shared_prefix_attention_fused_t"):
        if launches[name] <= 0:
            raise SystemExit(f"the main path never launched {name}")

    # int8 prefix: one stage-2 rollout with quantized_prefix=True
    from qaig_tpu_torch.utils.checkpoint import load_model
    status, ckpt = load_model(stage2_path)
    assert status
    model, _ = generate.transformer_from_checkpoint(ckpt, torch.device(
        device))
    model = model.to(torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(seed)
    x_enc = torch.randint(0, k, (num_images, cond_seq), generator=gen,
                          device=device)
    init = torch.full((num_images, 1), k, dtype=torch.long, device=device)
    num_beam, beam_width = FULL["beams"][2]
    synchronize(torch, device)
    reset_launches()
    t0 = time.perf_counter()
    out = DecodeEngine(model, quantized_prefix=True).rollout_generate(
        init, out_seq, gen, SamplerSettings(end_token=k, pos_offset=1),
        num_beam=num_beam, beam_width=beam_width, x_enc=x_enc,
        sliding_window=FULL["sliding"][2])
    synchronize(torch, device)
    int8_s = time.perf_counter() - t0
    int8_launches = read_launches()
    log(f"[main] stage-2 rollout with int8 prefix: {int8_s:.3f} s; "
        f"launches {int8_launches}")
    if out.shape != (num_images, out_seq) or int(out.min()) < 0 \
            or int(out.max()) >= k:
        raise SystemExit("int8-prefix rollout gave invalid tokens")
    if int8_launches["shared_prefix_attention_fused_int8"] <= 0:
        raise SystemExit("the int8-prefix rollout never launched "
                         "shared_prefix_attention_fused_int8")
    launches["shared_prefix_attention_fused_int8"] = \
        int8_launches["shared_prefix_attention_fused_int8"]
    timings = {"run_s": run_s, "int8_stage2_s": int8_s}
    if profile:
        timings["profile"] = profile_window(
            torch, DecodeEngine(model), init, x_enc, gen,
            SamplerSettings(end_token=k, pos_offset=1), num_beam, beam_width,
            FULL["sliding"][2])
    return launches, timings


def profile_window(torch, engine, init, x_enc, gen, settings, num_beam,
                   beam_width, window, tokens=64):
    """Device busy share of a stage-2 window (the first ``tokens`` tokens:
    cached rollout segments, bf16) from ``torch.profiler``: the summed
    time of the kernels the device ran over the wall time of the window,
    and the kernels that took most of it.  The profiler's own host cost
    lengthens the window, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.rollout_generate(init, tokens, gen, settings,
                                num_beam=num_beam, beam_width=beam_width,
                                x_enc=x_enc, sliding_window=window)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    out = {"tokens": tokens, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "busy_share": busy_ms / wall_ms,
           "kernel_launches": sum(e.count for e in kernels),
           "top": [{"name": e.key[:90], "count": e.count,
                    "ms": e.self_device_time_total / 1e3} for e in top]}
    log(f"[profile] stage-2 first {tokens} tokens: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms ({100 * out['busy_share']:.1f}%), "
        f"{out['kernel_launches']} kernel launches")
    for e in out["top"]:
        log(f"[profile]   {e['ms']:8.2f} ms  {e['count']:6d}x  {e['name']}")
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

KERNELS = {
    "flash_attention": {
        "source": "qaig_tpu_torch/csrc/flash_attention.cu",
        "replaces": "qaig_tpu/ops/flash_attention.py:116",
        "summary": {"S": 256, "causal": True}},
    "shared_prefix_attention_fused_t": {
        "source": "qaig_tpu_torch/csrc/decode_attention.cu",
        "replaces": "qaig_tpu/ops/decode_attention.py:155",
        "summary": {"S": 256, "bw": 8, "index0": 256}},
    "shared_prefix_attention_fused_int8": {
        "source": "qaig_tpu_torch/csrc/decode_attention.cu",
        "replaces": "qaig_tpu/ops/decode_attention.py:414",
        "summary": {"S": 256, "bw": 8, "index0": 256}},
}


def kernels_line(records, launches):
    out = []
    for name, meta in KERNELS.items():
        mine = [r for r in records if r["name"] == name]
        summary = next(r for r in mine if all(
            r["shape"].get(k) == v for k, v in meta["summary"].items()))
        out.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": summary["ms"], "plain_ms": summary["plain_ms"],
            "bound_ms": summary["bound_ms"],
            "bound_by": summary["bound_by"],
            "library_ms": summary["library_ms"]})
    return {"kernels": out}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json-out", type=Path, default=None)
    parser.add_argument("--profile", action="store_true",
                        help="also profile a stage-2 window with "
                             "torch.profiler (device busy share)")
    args = parser.parse_args()

    import torch
    name, smi = phase_device(torch)
    repo = Path(__file__).resolve().parent
    if not (repo / "qaig_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no qaig_tpu_torch package beside "
                         f"{Path(__file__).name}; run it from a checkout")
    sys.path.insert(0, str(repo))

    phase_build()
    timer = Timer(torch)
    records = []
    check_decode(torch, timer, records)
    check_flash(torch, timer, records)
    del timer
    check_reference(torch)
    with tempfile.TemporaryDirectory(prefix="qaig_chip_smoke_") as workdir:
        launches, timings = run_main_path(torch, workdir,
                                          profile=args.profile)

    line = kernels_line(records, launches)
    if args.json_out:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps(
            {"device": name, "nvidia_smi": smi, "records": records,
             "timings": timings, **line}, indent=1))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
