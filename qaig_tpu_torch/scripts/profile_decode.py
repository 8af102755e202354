"""Decode-step cost attribution on the card (counterpart of
``scripts/profile_decode.py``).

    python -m qaig_tpu_torch.scripts.profile_decode [--scale full|smoke]
        [--device cuda|cpu]

Single-path ``DecodeEngine.generate`` of 256 tokens at batch 128 (bf16,
seeded weights) for the baseline (7 decoder layers, hidden 2048, window
256, an encoder over 64 tokens) and variants that change one thing each:
2 layers, hidden 512, batch 32, no window, and decoder-only without a
window.  Each generation is one CUDA graph on the card (captured at a warm
call; eager on the CPU); a label's figure is the mean of 3 calls, each
re-seeded, host clock to a synchronise.  Prints ``profile_decode.py``'s
lines, ``<label>: <s>s total, <ms> ms/step``.  ``--scale smoke`` runs
bench.py's smoke widths with steps, window and batch divided by 8.
"""

import argparse
import time

import torch

from qaig_tpu_torch import bench
from qaig_tpu_torch.infer.decode import DecodeEngine, SamplerSettings
from qaig_tpu_torch.models.core import init_parameters
from qaig_tpu_torch.models.transformer import Transformer, TransformerConfig
from qaig_tpu_torch.scripts import profile_rollout as pr
from qaig_tpu_torch.train import common

BASE = dict(batch=128, layers=7, hidden=2048, steps=256, window=256,
            heads=8, use_enc=True)


def plan(scale="full"):
    """The keyword arguments of each run, ``profile_decode.py``'s."""
    runs = [dict(label="baseline b128 l7 h2048 w256"),
            dict(layers=2, label="layers=2"),
            dict(hidden=512, label="hidden=512"),
            dict(batch=32, label="batch=32"),
            dict(window=None, use_enc=True,
                 label="no window (plain cached)"),
            dict(use_enc=False, window=None, label="decoder-only no window")]
    out = []
    for r in runs:
        kw = dict(BASE, **r)
        if scale == "smoke":
            kw.update(batch=max(1, kw["batch"] // 8),
                      layers=min(kw["layers"], 2),
                      hidden=kw["hidden"] // 16, steps=kw["steps"] // 8,
                      window=None if kw["window"] is None
                      else kw["window"] // 8, heads=4)
        out.append(kw)
    return out


def run(scale, device, batch, layers, hidden, steps, window, heads, use_enc,
        label):
    w = pr.WIDTHS[scale]
    k = w["k"]
    cfg = TransformerConfig(
        use_encoder=use_enc, use_pos_cond=window is not None,
        num_enc_layers=w["enc"] if use_enc else 0, num_dec_layers=layers,
        num_enc_embedding=k if use_enc else 1,
        num_dec_embedding=k + 1 if use_enc else 2 * k,
        self_attn_heads=heads, cross_attn_heads=heads if use_enc else 0,
        in_dim=w["in_dim"], out_dim=k + 1, hidden_dim=hidden,
        hidden_activation="silu")
    model = common.cast_floats(init_parameters(
        Transformer(cfg), torch.Generator().manual_seed(0)).requires_grad_(
        False), torch.bfloat16).to(device)
    engine = DecodeEngine(model)
    settings = SamplerSettings(temperature=1.0, end_token=k,
                               end_mode="mask", index_shift=0)
    init = torch.full((batch, 1), k, dtype=torch.long, device=device)
    x_enc = (torch.zeros((batch, 64 if scale == "full" else 8),
                         dtype=torch.long, device=device)
             if use_enc else None)
    gen = torch.Generator(device=device)
    call = pr.graphed(device)

    def fn():
        return engine.generate(init, steps, gen, settings, x_enc=x_enc,
                               sliding_window=window)

    def once(i):
        gen.manual_seed(i)
        return call("generate", fn, generator=gen)
    once(0)
    bench.synchronize([device])
    t0 = time.perf_counter()
    reps = 3
    for i in range(reps):
        once(i + 1)
    bench.synchronize([device])
    dt = (time.perf_counter() - t0) / reps
    print(f"{label}: {dt:.3f}s total, {dt / steps * 1000:.3f} ms/step",
          flush=True)
    return dt


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", choices=["full", "smoke"], default="full")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    device = common.select_device(args.device)
    if device.type == "cuda":
        print(f"card: {bench.card_line()}", flush=True)
    return {kw["label"]: run(args.scale, device, **kw)
            for kw in plan(args.scale)}


if __name__ == "__main__":
    main()
