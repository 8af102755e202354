"""Rollout (beams) decode cost attribution at the bench's shapes, on the
card (counterpart of ``scripts/profile_rollout.py``).

    python -m qaig_tpu_torch.scripts.profile_rollout [--scale full|smoke]
        [--device cuda|cpu]

Times each cascade stage's ``DecodeEngine.rollout_generate`` alone at
batch 256 (bf16, seeded weights), a stage-0 variant with 8 rollouts, and
stage 2 truncated to 224 and 248 tokens (segments that stay before the
window slides) against the full 256 (whose crossing segment and steady
windowed segments come after): the difference is what the windowed
segments cost.  Each rollout is one CUDA graph on the card (captured at a
warm call; eager on the CPU); a label's figure is the mean of 3 calls,
each re-seeded, host clock to a synchronise.  Prints
``profile_rollout.py``'s lines, ``<label>: <seconds>s``.  ``--scale
smoke`` runs bench.py's smoke widths at batch 4 (labels unchanged).
"""

import argparse
import time

import torch

from qaig_tpu_torch import bench
from qaig_tpu_torch.infer.decode import DecodeEngine, SamplerSettings
from qaig_tpu_torch.infer.graphs import GraphRunner, product_warmup
from qaig_tpu_torch.models.core import init_parameters
from qaig_tpu_torch.models.transformer import Transformer, TransformerConfig
from qaig_tpu_torch.train import common

WIDTHS = {"full": dict(in_dim=512, hidden=2048, heads=8, k=512, enc=5,
                       batch=256, div=1),
          "smoke": dict(in_dim=64, hidden=128, heads=4, k=32, enc=2,
                        batch=4, div=4)}


def plan(scale="full"):
    """(batch, steps, num_beam, beam_width, use_enc, enc_len, window,
    label) of each timed rollout: ``profile_rollout.py``'s, with steps,
    encoder length, window and width divided by 4 at smoke scale."""
    w = WIDTHS[scale]
    b, d = w["batch"], w["div"]

    def cut(x):
        return None if x is None else x // d
    rows = [
        (16, 32, 16, False, 0, None, "stage0 (16 tok, 32x16, base)"),
        (16, 8, 16, False, 0, None, "stage0 variant nb=8"),
        (64, 4, 8, True, 16, None, "stage1 (64 tok, 4x8, enc 16)"),
        (256, 4, 8, True, 64, 256,
         "stage2 full (256 tok, 4x8, enc 64, w256)"),
        (224, 4, 8, True, 64, 256, "stage2 truncated 224 (cached only)"),
        (248, 4, 8, True, 64, 256, "stage2 truncated 248 (cached only)"),
    ]
    return [(b, cut(steps), max(1, nb // d), max(1, bw // d), enc,
             cut(enc_len), cut(window), label)
            for steps, nb, bw, enc, enc_len, window, label in rows]


def stage_model(scale, use_enc, window, device, layers=7, seed=0):
    w = WIDTHS[scale]
    k = w["k"]
    cfg = TransformerConfig(
        use_encoder=use_enc, use_pos_cond=window is not None,
        num_enc_layers=w["enc"] if use_enc else 0,
        num_dec_layers=layers if scale == "full" else 2,
        num_enc_embedding=k if use_enc else 1,
        num_dec_embedding=k + 1 if use_enc else 2 * k,
        self_attn_heads=w["heads"], cross_attn_heads=w["heads"] if use_enc
        else 0, in_dim=w["in_dim"], out_dim=k + 1, hidden_dim=w["hidden"],
        hidden_activation="silu")
    model = init_parameters(Transformer(cfg),
                            torch.Generator().manual_seed(seed))
    return common.cast_floats(model.requires_grad_(False),
                              torch.bfloat16).to(device)


def timed(call, label, device, reps=3, unit="s"):
    """Mean seconds of ``reps`` calls (call(i), re-seeded by the caller)
    after a warm one, to a synchronise; prints ``label``'s line."""
    call(0)
    bench.synchronize([device])
    t0 = time.perf_counter()
    for i in range(reps):
        call(i + 1)
    bench.synchronize([device])
    dt = (time.perf_counter() - t0) / reps
    print(f"{label}: {dt * 1000:.2f} ms" if unit == "ms"
          else f"{label}: {dt:.4f}s", flush=True)
    return dt


def graphed(device):
    """``call(key, fn, inputs, generator)``: ``fn(*inputs)`` from the key's
    CUDA graph on the card (captured at its first call), eagerly on the
    CPU."""
    def warmup():   # cuBLAS set up in this thread before a capture
        for dtype in (torch.bfloat16, torch.float32):
            product_warmup(dtype, device)
    runner = (GraphRunner(device, warmup) if device.type == "cuda"
              else None)

    def call(key, fn, inputs=(), generator=None):
        if runner is None:
            with torch.inference_mode():
                return fn(*inputs)
        return runner(key, fn, inputs=inputs, generator=generator)
    return call


def stage(scale, device, batch, steps, num_beam, beam_width, use_enc,
          enc_len, window, label, reps=3):
    model = stage_model(scale, use_enc, window, device)
    k = WIDTHS[scale]["k"]
    engine = DecodeEngine(model)
    settings = SamplerSettings(temperature=1.0, end_token=k,
                               end_mode="mask", index_shift=0,
                               pos_offset=1 if window is not None else 0)
    init = torch.full((batch, 1), k, dtype=torch.long, device=device)
    x_enc = (torch.zeros((batch, enc_len), dtype=torch.long, device=device)
             if use_enc else None)
    gen = torch.Generator(device=device)
    call = graphed(device)

    def fn():
        return engine.rollout_generate(
            init, steps, gen, settings, num_beam=num_beam,
            beam_width=beam_width, x_enc=x_enc, sliding_window=window)

    def run(i):
        gen.manual_seed(i)
        return call("rollout", fn, generator=gen)
    return timed(run, label, device, reps)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", choices=["full", "smoke"], default="full")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    device = common.select_device(args.device)
    if device.type == "cuda":
        print(f"card: {bench.card_line()}", flush=True)
    return {row[-1]: stage(args.scale, device, *row)
            for row in plan(args.scale)}


if __name__ == "__main__":
    main()
