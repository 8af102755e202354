#!/usr/bin/env python
"""Headline benchmark of the port: full coarse-to-fine cascade image
generation on the card (counterpart of ``bench.py``, which stays the JAX
package's bench).

    python -m qaig_tpu_torch.bench [--batch 256] [--iters 10] [--scale full]
        [--no-breakdown] [--no-beams] [--int8-kv] [--flat-decode] [--fp32]
        [--device cuda|cpu]

Measures images/s per card for ``bench.py``'s 3-stage cascade at its shapes
(1 -> 16 -> 64 -> 256 tokens over a 32x32x4 latent; in_dim 512, hidden
2048, 7 decoder layers, 5 encoder layers on the cascade stages, a window of
256 on the last; the reference beam plan), then the codebook lookup and the
FC decoder to 128x128x3 pixels.  Weights are random, drawn from a seeded
``torch.Generator`` (throughput does not depend on their values), in bf16
unless ``--fp32``.

The timed program is the whole cascade as ONE CUDA graph
(``infer/graphs.py::GraphRunner``), captured once before the timed
iterations; each iteration re-seeds the graph's generator, replays and
synchronises every card it used, timed on the host clock.  With more than
one visible card, each card holds a replica and a graph of its own (a
data-only ``parallel/local.py::LocalMesh``); every replay is launched
before the one synchronise, and the per-card figures divide by the cards.
``--breakdown`` (on by default) captures stage 0, 1, 2 and the pixel
decode as graphs of their own and times one replay of each after a warm
one.  ``--int8-kv`` and ``--flat-decode`` build the engine with
``quantized_prefix`` / ``flat_decode`` and are captured the same way.
On the card, decode attention is always the hand-written kernels (B, C,
4), so ``bench.py``'s ``--fused-decode`` (its switch from XLA einsums to
Pallas) has no counterpart here; neither have its XLA-only
``--compilation-cache-dir`` and ``--compiler-options``.

``--device cpu`` runs the same functions eagerly on the CPU (``--scale
full`` then drops to smoke, as in ``bench.py``); with no card and no
``--device cpu`` the bench raises.  Nothing falls back: an error in the
cascade propagates and the exit code is non-zero.

Prints the card's name and power limit (``nvidia-smi``), the graphs'
capture and instantiation seconds and the peak memory on lines of their
own, then, last, ONE JSON line with ``bench.py``'s keys.  ``flops_per_image``
is counted from the shapes the engine runs (:func:`cascade_flops`: every
product of every rollout step, prefill, encoder, cross K/V, windowed
recompute and the pixel decode's convolutions at 2*m*n*k), and ``mfu``
divides it by the card's dense peak for the working dtype
(:data:`PEAK_FLOPS`; null for a card not in the table and on the CPU).
"""

import argparse
import contextlib
import json
import subprocess
import time

import numpy as np
import torch

from qaig_tpu_torch.convert import load_jax_state
from qaig_tpu_torch.infer.decode import (DecodeEngine, SamplerSettings,
                                         _bucket_schedule, _ceil32)
from qaig_tpu_torch.infer.generate import _random_tokens, library_warmup
from qaig_tpu_torch.infer.graphs import GraphRunner
from qaig_tpu_torch.infer.pipeline import CascadePipeline, CascadeStage
from qaig_tpu_torch.models.codebook import Codebook
from qaig_tpu_torch.models.conv_nets import (ConvNetConfig, FCDecoder,
                                             _decoder_channels)
from qaig_tpu_torch.models.core import init_parameters
from qaig_tpu_torch.models.transformer import Transformer, TransformerConfig
from qaig_tpu_torch.parallel.local import LocalMesh, local_devices
from qaig_tpu_torch.train import common

TARGET_IMG_PER_SEC = 20.0

# dense peak FLOP/s of a card by its name (torch.cuda.get_device_name) and
# working dtype: NVIDIA's data sheet, SXM part, no sparsity; float32 is
# outside the tensor cores (every entry point turns TF32 off)
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {torch.bfloat16: 989e12, torch.float32: 67e12},
}


def build_cascade(scale="full", dtype=torch.bfloat16, int8_kv=False,
                  flat_decode=False, device="cpu", params=None, seed=0):
    """``bench.py``'s stage descriptors: (stages, decoder).  Each stage is a
    dict with ``model``, ``engine``, ``lr`` / ``hr`` (codebook modules),
    ``settings``, ``window``, ``total_seq``, ``k``, ``base``, ``num_beam``,
    ``beam_width`` and ``stage`` (the same as a pipeline's
    ``CascadeStage``).  Weights are drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (the same on every device), in
    ``bench.py``'s order (codebooks, stages, decoder), then cast to
    ``dtype`` and moved to ``device``.  ``params`` ({"codebooks": [4],
    "stages": [3], "decoder": tree} of ``qaig_tpu`` parameter trees as
    numpy arrays) replaces the drawn weights (``convert.py``)."""
    if scale == "full":
        in_dim, hidden, enc_l, dec_l, heads, k = 512, 2048, 5, 7, 8, 512
        image_dim, latent_c = (32, 32), 4
        patches = [(32, 32), (8, 8), (4, 4), (2, 2)]
        dec_cfg = ConvNetConfig(num_layers=2, image_channel=3,
                                min_channel=256, max_channel=512,
                                latent_channel=latent_c)
        sliding = {2: 256}
        # reference README generation config: beam rollouts per stage
        beams = {0: (32, 16), 1: (4, 8), 2: (4, 8)}  # (num_beam, beam_width)
    else:  # smoke scale for CPU runs
        in_dim, hidden, enc_l, dec_l, heads, k = 64, 128, 2, 2, 4, 32
        image_dim, latent_c = (8, 8), 2
        patches = [(8, 8), (4, 4), (2, 2), (1, 1)]
        dec_cfg = ConvNetConfig(num_layers=1, image_channel=3,
                                min_channel=16, max_channel=32,
                                latent_channel=latent_c)
        sliding = {2: 16}
        beams = {0: (2, 2), 1: (2, 4), 2: (2, 4)}

    gen = torch.Generator().manual_seed(seed)

    def finish(module, state):
        if state is None:
            init_parameters(module, gen)
        else:
            load_jax_state(module, state, logging=_refuse_skips)
        return common.cast_floats(module.requires_grad_(False),
                                  dtype).to(device)

    codebooks = [finish(Codebook(patch_dim=patch, image_dim=image_dim,
                                 image_channel=latent_c, num_embeddings=k,
                                 init_neighbour_range=1),
                        None if params is None else params["codebooks"][i])
                 for i, patch in enumerate(patches)]
    stages = []
    for i in range(3):
        base = i == 0
        window = sliding.get(i)
        cfg = TransformerConfig(
            use_encoder=not base,
            use_pos_cond=window is not None,
            num_enc_layers=0 if base else enc_l,
            num_dec_layers=dec_l,
            num_enc_embedding=1 if base else k,
            num_dec_embedding=2 * k if base else k + 1,
            self_attn_heads=heads,
            cross_attn_heads=0 if base else heads,
            in_dim=in_dim,
            out_dim=k + 1,
            hidden_dim=hidden,
            hidden_activation="silu")
        model = finish(Transformer(cfg),
                       None if params is None else params["stages"][i])
        settings = SamplerSettings(
            temperature=1.0, end_token=k, end_mode="mask",
            index_shift=k if base else 0)
        num_beam, beam_width = beams[i]
        engine = DecodeEngine(model, quantized_prefix=int8_kv,
                              flat_decode=flat_decode)
        total_seq = codebooks[i + 1].seq_len
        stages.append(dict(
            model=model, engine=engine, lr=codebooks[i], hr=codebooks[i + 1],
            settings=settings, window=window, total_seq=total_seq, k=k,
            base=base, num_beam=num_beam, beam_width=beam_width,
            stage=CascadeStage(
                engine=engine, lr_codebook=codebooks[i],
                hr_codebook=codebooks[i + 1], settings=settings,
                num_beam=num_beam, beam_width=beam_width,
                sliding_window=window, total_seq=total_seq, is_base=base)))
    decoder = finish(FCDecoder(dec_cfg),
                     None if params is None else params["decoder"])
    return stages, decoder


def _refuse_skips(msg):
    raise ValueError(f"bench weights: {msg}")


def pipeline_of(stages, decoder, device):
    """A ``CascadePipeline`` over :func:`build_cascade`'s stages (the
    serving and latency tools' cascade: row-keyed, fused on the card)."""
    return CascadePipeline([st["stage"] for st in stages], decoder, device)


def init_tokens(stages, num_images, generator):
    """Stage 0's conditioning: one random LR token an image."""
    return _random_tokens((num_images, 1), stages[0]["k"], generator)


@torch.inference_mode()
def run_cascade(stages, num_images, generator, use_beams=True):
    """One full cascade's tokens (``bench.py``'s ``run_cascade``): the
    stage-0 init draw, then every stage, all from ``generator``."""
    tokens = init_tokens(stages, num_images, generator)
    for st in stages:
        tokens = st["stage"].rollout(tokens, generator, use_beams=use_beams)
    return tokens


@torch.inference_mode()
def decode_pixels(stages, decoder, tokens):
    """The last stage's tokens to pixels: HR codebook lookup, FC decoder
    (only the last stage is decoded, as in ``bench.py``)."""
    return decoder(stages[-1]["hr"].get_quantized_image(tokens))


def cascade_program(stages, decoder, num_images, generator, use_beams=True):
    """The timed program: (pixels, tokens) of one cascade."""
    tokens = run_cascade(stages, num_images, generator, use_beams)
    return decode_pixels(stages, decoder, tokens), tokens


def token_counts(stages, use_beams):
    """(sampled tokens, computed model token-steps) per image.  Beam
    rollouts run every generated position num_beam times."""
    sampled = sum(st["total_seq"] for st in stages)
    computed = sum(
        st["total_seq"] * (st["num_beam"] if use_beams else 1)
        for st in stages)
    return sampled, computed


# two-sided 95% Student-t critical values by degrees of freedom (iters-1);
# beyond the table the normal 1.96 is within 2%
_T95 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
        7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228, 11: 2.201, 12: 2.179,
        13: 2.160, 14: 2.145, 15: 2.131, 19: 2.093, 24: 2.064, 29: 2.045}


def ci95_half_width(times):
    """Half-width of the 95% confidence interval on the MEAN iteration
    time (Student t over the per-iteration samples); None below two."""
    n = len(times)
    if n < 2:
        return None
    df = n - 1
    t = _T95.get(df, 2.045 if df < 60 else 1.96)
    return t * float(np.std(times, ddof=1)) / np.sqrt(n)


# ---------------------------------------------------------------------------
# FLOPs counted from shapes
#
# Why from shapes, mirroring DecodeEngine's segment schedule, and not
# torch.utils.flop_counter over a run: on the card the decode and flash
# attention are hand-written kernels, not aten operators, so the counter
# does not see them; on the CPU, where attention runs through its plain
# products, one counted pass over the full cascade (at 1 and 2 images: the
# count is affine in the batch, since a decode step's position
# conditioning is one row at any batch) takes about two minutes of an
# H100 host's CPU, longer than the bench's measurement.  A change to the
# engine's control flow must be mirrored here; tests/test_torch_port_bench.py
# holds the count equal to FlopCounterMode's in every engine form.
# ---------------------------------------------------------------------------

class ModelFlops:
    """Product FLOPs (2*m*n*k) of one transformer's decode primitives, as
    the engine calls them: every linear of the 2-layer MLPs (Q/K/V, FFN,
    classifier, position conditioning), the AdaLN-Zero and gate linears of
    a position-conditioned decoder (over the conditioning's rows: one for a
    decode step's scalar position), the residual linears, and both products
    of every attention (over every slot the plain version reads: a cache's
    capacity, a segment's read length and its whole block)."""

    def __init__(self, cfg):
        self.d, self.hid, self.out = cfg.in_dim, cfg.hidden_dim, cfg.out_dim
        self.pos = cfg.use_pos_cond
        self.enc = cfg.use_encoder
        self.layers, self.enc_layers = cfg.num_dec_layers, cfg.num_enc_layers

    def lin(self, rows):
        return 2 * rows * self.d * self.d

    def mlp(self, rows, d_out=None):
        return 2 * rows * self.hid * (self.d + (d_out or self.d))

    def attn(self, rows, keys):
        return 4 * rows * keys * self.d

    def norm(self, cond):
        return 2 * self.lin(cond) if self.pos else 0

    def res(self, rows, cond):
        return self.lin(rows) + (self.lin(cond) if self.pos else 0)

    def ffn(self, rows, cond):
        return self.norm(cond) + self.mlp(rows) + self.res(rows, cond)

    def cond(self, rows):
        return self.mlp(rows) if self.pos else 0

    def classify(self, rows):
        return self.mlp(rows, self.out)

    def block(self, n, s, enc_len):
        """A decoder block over (n, s) tokens, causal, conditioned per
        token."""
        r = n * s
        f = (self.norm(r) + 3 * self.mlp(r) + self.attn(r, s)
             + self.res(r, r))
        if self.enc:
            f += (self.norm(r) + self.mlp(r) + self.attn(r, enc_len)
                  + self.res(r, r))
        return f + self.ffn(r, r)

    def encoder(self, n, s):
        r = n * s
        per = (3 * self.mlp(r) + self.attn(r, s) + self.lin(r)
               + self.mlp(r) + self.lin(r))
        return self.enc_layers * per + self.layers * 2 * self.mlp(r)

    def prefill(self, n, p, enc_len):
        return (self.cond(n * p) + self.layers * self.block(n, p, enc_len)
                + self.classify(n))

    def step(self, rows, keys, enc_len):
        """One decode step of ``rows`` queries against ``keys`` self-attn
        slots (a rollout step: read length + block width)."""
        c = 1 if self.pos else 0
        per = (self.norm(c) + 3 * self.mlp(rows) + self.attn(rows, keys)
               + self.res(rows, c))
        if self.enc:
            per += (self.norm(c) + self.mlp(rows) + self.attn(rows, enc_len)
                    + self.res(rows, c))
        per += self.ffn(rows, c)
        return self.cond(1) + self.layers * per + self.classify(rows)

    def window(self, n, s, enc_len):
        """``window_forward(last_only=True)`` over (n, s) tokens."""
        r = n * s
        f = self.cond(r) + (self.layers - 1) * self.block(n, s, enc_len)
        f += (self.norm(r) + self.mlp(n) + 2 * self.mlp(r)
              + self.attn(n, s) + self.res(n, n))
        if self.enc:
            f += (self.norm(n) + self.mlp(n) + self.attn(n, enc_len)
                  + self.res(n, n))
        return f + self.ffn(n, n) + self.classify(n)

    def window_shared(self, n, nb, s0, s, enc_len):
        """``window_forward_shared``: (n, s0) shared slots, (nb, s) tail."""
        rs, rb = n * s0, nb * s
        f = self.cond(rs) + self.cond(rb)
        for i in range(self.layers):
            last = i == self.layers - 1
            rq = nb * (1 if last else s)
            f += self.norm(rs) + self.norm(rb) + 2 * self.mlp(rs) \
                + 2 * self.mlp(rb)
            if not last:
                f += self.mlp(rs) + self.attn(rs, s0) + self.res(rs, rs)
            f += self.mlp(rq) + self.attn(rq, s0 + s) + self.res(rq, rq)
            if self.enc:
                if not last:
                    f += (self.norm(rs) + self.mlp(rs)
                          + self.attn(rs, enc_len) + self.res(rs, rs))
                f += (self.norm(rq) + self.mlp(rq) + self.attn(rq, enc_len)
                      + self.res(rq, rq))
            if not last:
                f += self.ffn(rs, rs)
            f += self.ffn(rq, rq)
        return f + self.classify(nb)


def stage_flops(st, n, enc_len, use_beams=True):
    """FLOPs of one stage's rollout (or single-path) decode of ``n``
    images, walking ``infer/decode.py::DecodeEngine``'s control flow: the
    encoder and cross K/V, the prefill, then each segment (cached rollout
    segments over their read length, the crossing segment's cached steps
    and windowed recompute, steady windowed segments).  The
    tile-everything path (``legacy_windowed_rollouts``, or a segment as
    wide as the window) is not counted: raises."""
    m = ModelFlops(st["model"].cfg)
    init_len, num_new, window = 1, st["total_seq"], st["window"]
    nb = n * (st["num_beam"] if use_beams else 1)
    bw = st["beam_width"] if use_beams else num_new
    f = m.encoder(n, enc_len) if m.enc else 0
    total = (init_len + num_new if window is None
             else min(init_len + num_new, window))
    cache_len = _bucket_schedule(init_len, total)
    f += m.prefill(n, init_len, enc_len)
    if not use_beams:
        cached = num_new if window is None else min(
            num_new, window - init_len)
        gen = 0
        while gen < cached:
            if cache_len - (init_len + gen) <= 0:
                cache_len = _bucket_schedule(init_len + gen + 1, total)
            steps = min(cached - gen, cache_len - (init_len + gen))
            f += steps * m.step(n, cache_len, enc_len)
            gen += steps
        if cached < num_new:
            f += (num_new - cached) * m.window(n, window - 1, enc_len)
        return f
    if st["engine"].legacy_windowed_rollouts or (
            window is not None and bw >= window):
        raise NotImplementedError("the tile-everything rollout path")
    gen, cached = 0, True
    for _ in range(num_new // bw):
        left = (num_new if window is None
                else max(0, window - init_len - gen))
        n_cached = bw if cached and bw <= left else (left if cached else 0)
        if n_cached:
            if init_len + gen + n_cached > cache_len:
                cache_len = _bucket_schedule(init_len + gen + n_cached, total)
            read = min(cache_len, _ceil32(init_len + gen))
            f += n_cached * m.step(nb, read + n_cached, enc_len)
        if n_cached < bw:
            cached = False
            for s in range(n_cached, bw):
                s0 = window - 1 - s
                f += (m.window(n, s0, enc_len) if s == 0
                      else m.window_shared(n, nb, s0, s, enc_len))
        gen += bw
    return f


def pixel_flops(decoder, n, latent_hw):
    """The FC decoder's convolutions over ``n`` latents of ``latent_hw``:
    3x3 convolutions at their output size, 4x4 transposed ones at their
    input size (as ``torch.utils.flop_counter`` counts them)."""
    h, w = latent_hw
    f = 0
    for cin, cout, kind in _decoder_channels(decoder.cfg):
        f += 2 * n * h * w * cin * cout * (16 if kind == "up" else 9)
        if kind == "up":
            h, w = 2 * h, 2 * w
    return f


def cascade_flops(stages, decoder, num_images, use_beams=True):
    """Product FLOPs of one cascade call of ``num_images`` images (every
    stage, then the last stage's pixel decode)."""
    f, enc_len = 0, 0
    for st in stages:
        f += stage_flops(st, num_images, enc_len, use_beams)
        enc_len = st["total_seq"]
    hr = stages[-1]["hr"]
    return f + pixel_flops(decoder, num_images, hr.image_dim)


def peak_flops(device, dtype):
    """(dense peak FLOP/s of the card for ``dtype`` or None, device kind)."""
    if device.type != "cuda":
        return None, "cpu"
    kind = torch.cuda.get_device_name(device)
    return PEAK_FLOPS.get(kind, {}).get(dtype), kind


def card_line():
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=256,
                        help="images per card per iteration")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--scale", choices=["full", "smoke"], default="full")
    parser.add_argument("--breakdown", dest="breakdown",
                        action="store_true", default=True,
                        help="also time each cascade stage and the pixel "
                             "decode as graphs of their own (fills the "
                             "'stages' JSON field; on by default)")
    parser.add_argument("--no-breakdown", dest="breakdown",
                        action="store_false",
                        help="skip the per-stage graphs")
    parser.add_argument("--no-beams", action="store_true",
                        help="single-path temperature sampling (no rollout "
                             "beam search)")
    parser.add_argument("--int8-kv", action="store_true",
                        help="int8 shared-prefix KV cache (kernel C, or "
                             "kernel 4's int8 form with --flat-decode)")
    parser.add_argument("--flat-decode", action="store_true",
                        help="interleaved prefix for the rollout segments "
                             "the flat kernel (4) takes")
    parser.add_argument("--fp32", action="store_true",
                        help="run the cascade in float32 (reference "
                             "numerics) instead of bf16")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (every visible card; raises without "
                             "one) or cpu (eager, smoke scale)")
    return parser.parse_args(argv)


def bench_mode(args):
    """``bench.py``'s ``mode`` string for these flags."""
    mode = "single" if args.no_beams else "beams"
    if args.int8_kv:
        mode += "_int8kv"
    if args.fp32:
        mode += "_fp32"
    if args.flat_decode:
        mode += "_flat"
    return mode


class Replica:
    """One card's cascade, its generator and its graphs (None on the
    CPU: run eagerly)."""

    def __init__(self, args, dtype, device):
        self.device = device
        self.stages, self.decoder = build_cascade(
            args.scale, dtype=dtype, int8_kv=args.int8_kv,
            flat_decode=args.flat_decode, device=device)
        self.generator = torch.Generator(device=device)
        self.runner = None
        if device.type == "cuda":
            self.runner = GraphRunner(device, library_warmup(
                self.decoder, self.stages[-1]["hr"], dtype, device))

    def call(self, key, fn, seed, inputs=()):
        """``fn(*inputs)`` with the generator seeded: a replay of the
        key's graph (captured at its first call), queued without waiting;
        eagerly on the CPU."""
        self.generator.manual_seed(seed)
        if self.runner is None:
            with torch.inference_mode():
                return fn(*inputs)
        return self.runner(key, fn, inputs=inputs,
                           generator=self.generator)

    def graph(self, key):
        return None if self.runner is None else self.runner.graphs.get(key)


def synchronize(devices):
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def stage_breakdown(replica, batch, use_beams, seed=11):
    """Per-stage seconds: stage 0, 1, 2 and the pixel decode, each its own
    graph (captured, replayed warm, then one timed replay), each stage
    conditioned on the previous one's tokens.  Returns ({name: record},
    {name: (capture s, instantiation s)})."""
    out, captures = {}, {}
    tokens = None
    with torch.inference_mode():
        for i, st in enumerate(replica.stages):
            if st["base"]:
                def fn(st=st):
                    return st["stage"].rollout(init_tokens(
                        replica.stages, batch, replica.generator),
                        replica.generator, use_beams=use_beams)
                inputs = ()
            else:
                def fn(prev, st=st):
                    return st["stage"].rollout(prev, replica.generator,
                                               use_beams=use_beams)
                inputs = (tokens,)
            key = ("stage", i)
            replica.call(key, fn, seed, inputs)     # capture + warm replay
            synchronize([replica.device])
            t0 = time.perf_counter()
            tokens = replica.call(key, fn, seed, inputs)
            synchronize([replica.device])
            out[f"stage{i}"] = {
                "tokens": st["total_seq"],
                "num_beam": st["num_beam"] if use_beams else 1,
                "time_s": round(time.perf_counter() - t0, 4)}
            graph = replica.graph(key)
            if graph is not None:
                captures[f"stage{i}"] = (graph.capture_s, graph.instantiate_s)

        def pixels(t):
            return decode_pixels(replica.stages, replica.decoder, t)
        replica.call("pixel_decode", pixels, seed, (tokens,))
        synchronize([replica.device])
        t0 = time.perf_counter()
        replica.call("pixel_decode", pixels, seed, (tokens,))
        synchronize([replica.device])
        out["pixel_decode"] = {"time_s": round(time.perf_counter() - t0, 4)}
        graph = replica.graph("pixel_decode")
        if graph is not None:
            captures["pixel_decode"] = (graph.capture_s, graph.instantiate_s)
    return out, captures


def run(args):
    """The benchmark; returns the JSON record (``bench.py``'s keys)."""
    device = common.select_device(args.device)
    if device.type == "cpu" and args.scale == "full":
        args.scale = "smoke"
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    devices = (LocalMesh(devices=local_devices(device)).grid
               if device.type == "cuda" else [[device]])
    devices = [row[0] for row in devices]
    n_chips = len(devices)
    if device.type == "cuda":
        print(f"card: {card_line()}", flush=True)
    replicas = []
    for d in devices:
        with (torch.cuda.device(d) if d.type == "cuda"
              else contextlib.nullcontext()):
            replicas.append(Replica(args, dtype, d))
            if d.type == "cuda":   # (the card's allocator exists now)
                torch.cuda.reset_peak_memory_stats(d)
    use_beams = not args.no_beams
    global_batch = args.batch * n_chips

    def program(replica):
        def cascade():
            return cascade_program(replica.stages, replica.decoder,
                                   args.batch, replica.generator, use_beams)
        return cascade

    # capture (or, on the CPU, warm) once, outside the timed iterations
    t0 = time.perf_counter()
    for r, replica in enumerate(replicas):
        replica.call("cascade", program(replica), 7 + r)
    synchronize(devices)
    first_s = time.perf_counter() - t0
    graph = replicas[0].graph("cascade")
    if graph is not None:
        print(f"Cascade graph: capture {graph.capture_s:.3f} s, "
              f"instantiation {graph.instantiate_s:.3f} s (batch "
              f"{args.batch} a card, {n_chips} card(s); first call "
              f"{first_s:.3f} s in all)", flush=True)

    stage_times = None
    if args.breakdown:
        stage_times, captures = stage_breakdown(replicas[0], args.batch,
                                                use_beams)
        if captures:
            print("Breakdown graphs (capture s, instantiation s): "
                  + ", ".join(f"{k} {c:.3f} / {i:.3f}"
                              for k, (c, i) in captures.items()),
                  flush=True)

    times = []
    for it in range(args.iters):
        t0 = time.perf_counter()
        for r, replica in enumerate(replicas):
            replica.call("cascade", program(replica),
                         1000 * (it + 1) + r)
        synchronize(devices)
        times.append(time.perf_counter() - t0)
    if device.type == "cuda":
        peak = max(torch.cuda.max_memory_allocated(d) for d in devices)
        print(f"Peak memory allocated: {peak} bytes "
              f"({peak / 2 ** 30:.2f} GiB) on the busiest card", flush=True)

    times = np.asarray(times)
    elapsed = float(times.sum())
    img_per_sec_chip = global_batch * args.iters / elapsed / n_chips
    sampled_per_img, computed_per_img = token_counts(replicas[0].stages,
                                                     use_beams)
    flops_per_call = n_chips * cascade_flops(
        replicas[0].stages, replicas[0].decoder, args.batch, use_beams)
    peak, kind = peak_flops(devices[0], dtype)
    mfu = None
    if peak:
        mfu = (flops_per_call / float(times.mean())) / (peak * n_chips)
    result = {
        "metric": "cascade_images_per_sec_per_chip",
        "value": round(img_per_sec_chip, 3),
        "unit": "images/sec/chip",
        "vs_baseline": round(img_per_sec_chip / TARGET_IMG_PER_SEC, 3),
        "mode": bench_mode(args),
        "scale": args.scale,
        "n_chips": n_chips,
        "device_kind": kind,
        "batch_per_chip": args.batch,
        "iters": args.iters,
        "decode_tokens_per_sec_per_chip": round(
            img_per_sec_chip * sampled_per_img, 1),
        "model_token_steps_per_sec_per_chip": round(
            img_per_sec_chip * computed_per_img, 1),
        "mfu": round(mfu, 4) if mfu is not None else None,
        "flops_per_image": round(flops_per_call / global_batch),
        "iter_time_mean_s": round(float(times.mean()), 4),
        "iter_time_std_s": round(float(times.std()), 4),
        "iter_time_min_s": round(float(times.min()), 4),
        "iter_time_max_s": round(float(times.max()), 4),
        "stages": stage_times,
    }
    ci = ci95_half_width(times)
    if ci is not None:
        result["iter_time_ci95_s"] = round(ci, 4)
        mean_t = float(times.mean())
        per_iter = global_batch / n_chips
        result["img_per_sec_per_chip_ci95"] = [
            round(per_iter / (mean_t + ci), 3),
            round(per_iter / max(mean_t - ci, 1e-9), 3)]
    return result


def main(argv=None):
    print(json.dumps(run(parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
