#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``qaig_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device -- require CUDA, print the card's name and power limit, turn
   TF32 off for matmuls and cuDNN through the package's own setting
   (``train/common.py::full_float32``, which every entry point calls);
2. build -- compile every CUDA kernel of the port from
   ``qaig_tpu_torch/csrc`` (one nvcc per source, in parallel) and print
   each kernel's registers and spill bytes (``ptxas -v``);
3. kernels -- hold each kernel against its plain PyTorch version on the
   card and time kernel, plain version, bound and a PyTorch yardstick:
   the decode kernels in bf16 and float32 (atol 2e-2 / 1e-5) at the
   generation path's shapes (kernels B and C, one kernel over a working
   or an int8 prefix, each with its launch plan, its bits equal over two
   calls, and timed in the split of 1 or 2 CTAs its plan did not take),
   full-sequence attention there in bf16 and
   float32 (atol 2e-2 / 1e-5; ``scaled_dot_product_attention`` as the
   yardstick); full-sequence attention at the training path's 64
   heads of dim 8 (and at in_dim 512 in heads of 64, 16, 32 and 128),
   forward and gradient, bf16 and float32, with the backward kernel
   against the plain backward
   products (atol 5e-2 bf16, 1e-4 float32) and SDPA's backward (the
   float32 register-blocked form also in the cluster size of 1 or 2 its
   plan did not take); both at
   N * H = 65536 (1024 rows of 64 heads, S 64) and at head dims 256 and
   192 through ``dot_product_attention``, which must launch both kernels
   once; head dim 24 through it, which must not launch kernel A; the
   BMU kernel at the codebook shapes of the cascade in both launch
   geometries, and at D 2, D 8192 and K 8192, index for index outside
   near-ties (``torch.cdist(p, c).argmin(1)`` as the yardstick); the flat
   decode kernel (kernel 4) over
   interleaved caches, bf16 and int8 prefix (atol 2e-2) and float32 (atol
   1e-5), at the stage-1/2 shapes of 16 images, the flat path's own 8
   images at the read lengths and index0 its engine reaches, and the
   stage-0 fan, with its launch plan, its bits equal over two calls, the
   clusters the card holds, and timed in a cluster of another size; the
   fused MLP
   (kernel 6) in bf16 (atol 2e-2) at the probe's packed-QKV and FFN
   shapes, 8192 and 1024 rows and a ragged 1000, beside the same function
   as two cuBLAS products and elementwise calls, with its cluster size,
   the weight bytes it reads from L2 and ``ptxas``'s registers and spills
   (phase 2's build log);
4. reference -- a small cascade stage decoded greedily in float32 on the
   card (kernels) and on the CPU (plain versions) must give the same
   tokens; 4c: the same with ``flat_decode=True``; 4 and 4c again with
   ``quantized_prefix=True`` (kernel C, and kernel 4's int8 form, must
   launch, with the counts the stage gives); 4b: one float32 train
   step of a small windowed cascade on the card (graphed) and on the CPU
   (eager) must give
   the same tokens, loss and gradients, and one bf16 step the same tokens
   and loss and gradients within bf16 tolerances;
5. generation main path -- the full-width 3-stage cascade of ``bench.py
   --scale full`` with seeded random weights, written as
   ``qaig_tpu``-schema checkpoints and generated through
   ``qaig_tpu_torch.infer.generate.run`` in bf16 on 8 images (the
   dispatched loop, ``fused`` False); then one stage-2 rollout with an
   int8 prefix;
5f. fused generation -- the capturable categorical draw against
   ``torch.multinomial``; a capture that reads a device value raises;
   ``python -m qaig_tpu_torch.cli.generate_images --bf16`` in a new
   process (fused by default: a cold capture); then ``generate.run``
   fused with one cache (the whole cascade from one CUDA graph): cold
   (load, capture, instantiation, replay timed), warm at a second seed,
   warm again, the dispatched loop at the second seed, and a warm replay
   under ``--profile-dir``.  Tokens equal the dispatched loop's at both
   seeds, grids and launch counts equal phase 5's, the trace's kernels
   equal the replay's counts;
5b. flat-decode path -- the same checkpoints through
   ``DecodeEngine(flat_decode=True)`` in ``bench.py --flat-decode``'s
   stage order (timed in turns with the slot-minor engine), then a stage-2
   rollout with ``quantized_prefix=True``; launches asserted from the
   config;
6. training main path -- ``qaig_tpu_torch.train.transformer.run`` on
   ``examples/configs/transformer_cascade.json`` (full width, 64 heads)
   over seeded random latents and phase 5's stage-2 codebooks and
   decoder: 6 bf16 steps at batch 8, each step replayed from one CUDA
   graph (the default on the card), checkpoints and previews at steps 0
   and 3, a replay's launches asserted (A and its backward once per
   layer, BMU twice) and the graph's kernel nodes as many; then 6 steps
   of ``make_train_step`` graphed against 6 eager on one seed (losses and
   parameters bit-equal; seconds per step of both, capture and
   instantiation seconds; the distance to the host-side Adam of the eager
   steps before graphs, at most 1e-6 in float32; A, A' and BMU in the
   graph's kernel nodes as often as a replay counts them); then the same
   in
   float32 (the trainer's default), which runs the backward kernel's
   float32 form;
7. serving -- ``CascadePipeline`` on phase 5's cascade cut to 1 encoder
   and 2 decoder layers (``SHALLOW``, as phases 11 (c) and 12 are), fused,
   one CUDA graph per batch size: float32
   composition invariance of row-keyed sampling (asserted) and the bf16
   share of equal tokens (reported), fused tokens equal to the
   dispatched loop's in both; a bf16 1-image request fused (first call,
   then warm) against the dispatched loop, in turns; then ``python -m
   qaig_tpu_torch.cli.serve_generation --bf16`` as a subprocess: /healthz,
   four concurrent /generate requests, /metrics, a PNG, SIGTERM;
8. probe path -- ``qaig_tpu_torch.scripts.probe_mlp_fused.main()`` at its
   full shapes (D 512, hidden 2048, 8192 and 1024 rows, 7 layers of
   packed QKV and FFN), kernel 6's launches asserted from its control flow;
9. front of the pipeline -- 64 seeded 128x128x3 PNGs through the four
   stage CLIs as subprocesses with ``--device cuda``: the autoencoder of
   ``examples/configs/autoencoder.json`` (6 float32 steps, then 6 bf16
   steps, batch 8), feature maps of all 64 images, codebooks on
   ``codebook_hr.json`` and ``codebook_lr.json`` (6 steps each, previews
   through the new decoder), pruning of the HR codebook; the trainers'
   steps replayed from CUDA graphs; every file checked, the BMU launches
   (and the LR codebook's small-M geometry) asserted from the control
   flow, one a codebook step's replay; then each trainer's
   ``make_train_step`` at these configs, 6 graphed steps against 6 eager
   on one seed (as in phase 6: bit-equal, the host-side Adam's distance,
   BMU's row-tiled and small-M kernels among the graph's nodes, seconds
   per step of both); 9 (c): in a new process, a traced replay each of
   phase 6 (b)'s bf16 transformer step and of the codebook steps must
   hold A, A' and BMU (row tiles, small M) as a replay counts them;
4d. reference, front -- one float32 autoencoder step and one codebook step
   on the card and on the CPU (loss, gradients, BMU indices outside
   near-ties; the autoencoder step also with cuDNN's TF32 on, reported),
   and phase 9's latents against the CPU's encoder (the card's steps
   graphed, the CPU's eager);
10. interchange -- phase 5's checkpoints and phase 6's ``model_3.pt``
   exported to the reference's torch ``.pt`` format by ``python -m
   qaig_tpu_torch.cli.export_torch`` in new processes; ``generate.run``
   fused from the archives at phase 5f's seed (tokens and grids bit-equal
   to phase 5f's from the pickles); 2 graphed bf16 train steps resumed
   from the exported ``model_3.pt`` and its reference Adam state, the
   Adam step count and learning rate held to the ones the state implies;
11. parallel -- the port's multi-process forms (``qaig_tpu_torch/
   parallel``): (a) phase 6's bf16 run through ``--multihost
   --num-processes 1`` (NCCL, groups of one rank), plain and with
   ``--zero-opt``, bit-equal to phase 6, the train step's graph holding
   NCCL's nodes as predicted; (b) DP 2, TP 2 and DP 2 + ZeRO-1 training
   in 2 processes sharing the card (gloo over CUDA tensors, eager steps),
   float32, 3 steps, at ``SHALLOW``'s depth, against a 1-process eager
   run (PP 2 is left out: gloo's send/recv cannot take CUDA tensors; its
   refusal is checked); (c) ``generate.run`` on the ``SHALLOW`` cascade
   in 2 processes, data 2 (tokens equal to 1 process) and
   ``--num-model-shards 2`` at greedy;
   (d) phase 6's run with ``--checkpoint-backend pickle-async``: save
   seconds, overlapping steps, files byte-equal, a resume.
12. serving over several cards in one process -- ``CascadePipeline``
   (the ``SHALLOW`` cascade) on ``parallel/local.py::LocalMesh`` meshes
   that repeat the one card: (a) data 2, bf16, fused (a graph a
   replica), 8 images, each replica's block bit-equal to the one-card
   pipeline at batch 4, A 2 x 9 and B 2 x 670 a call, cold and warm;
   float32 tokens equal to one card's at 8;
   (b) data 1 x model 2, float32, greedy, dispatched, 4 images: tokens
   equal to one card's, MLP shards of hidden/2 rows, ``fused=True``
   raises; (d) the serve CLI with ``--shard-batch`` as a subprocess
   (``data=1 x model=1``, a request's tokens), and ``--num-model-shards
   2``'s refusal on one card;
13. data plane -- the native batch loaders (``qaig_tpu_torch/native``,
   built with ``g++``): (a) 64 seeded 128x128x3 PNGs whose rows use all
   five filters, mostly Paeth and Average, decoded by the plain decoder
   (``utils/png.py``) and by ``load_image_batch``, bit-equal, seconds per
   image of both and the ``DataLoader``'s batches per second at batch 8;
   (b) ``train_autoencoder`` (6 bf16 steps) and ``generate_fmap_dataset``
   over those files as subprocesses, the feature maps' seconds split into
   process start, checkpoint load, decoding and device work; (c) ``python
   -m qaig_tpu_torch.scripts.eval_quality``'s ``main`` on the card over
   phase 9's codebooks and a copy of its autoencoder whose weights are 3x
   (one BMU launch a batch a codebook, the LR codebook's small-M), PSNRs
   within 1e-3 dB of a CPU run, the codebook PSNRs more than 0.01 dB from
   the reconstruction's; (d) ``generate.run`` with ``devices=[cuda:0,
   cuda:0]`` (data 2), float32, greedy, dispatched by default: tokens
   equal the one-card run's, the mesh line printed, ``fused=True``
   raises;
14. quality -- ``python -m qaig_tpu_torch.scripts.quality_run``'s
   ``main`` in this process at its full widths (128x128 images, AE 256
   -> 512, K 512, in_dim 512 / hidden 2048 / 7 + 5 layers / 64 heads,
   window 256, the reference beam plan) on 64 images with few steps
   (``QUALITY``), then ``sampling_sweep`` (one temperature) and
   ``quality_bf16_ab`` (2 steps) on its run and ``render_quality`` over
   it: the report's schema as ``tests/test_quality_run.py`` asserts it,
   every PSNR and CE finite, BMU, A, A' and B launched as predicted from
   the control flow, the reserved memory after each later stage within
   24 MiB of the first transformer stage's (every trainer's graphs and
   pools let go); then the last cascade stage's step (remat, EMA 0.999,
   clip 1.0, float32) graphed against eager at full width, bit for bit.

Each phase's wall seconds are printed on a line of their own
(``[seconds] phase ...``), and the run's total after the last.  The
kernels' launch counts are set to 0 before each main path's run and
read after it.  It prints a ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name and power limit, and, last, the device JSON line.
``--json-out PATH`` also writes every per-shape measurement there;
``--profile`` adds ``torch.profiler`` windows over the first 64 stage-2
tokens and over train steps 2-5 (device busy share and the kernels that
take the time).  ``--parallel-only``, ``--serving-only``, ``--data-only``
and ``--quality-only`` run phases 1-2 and one phase (with what it needs).
"""

import argparse
import contextlib
import ctypes
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
DECODE_SHAPES = [  # (N, B, bw, S, (index0, block_index) pairs): stage-0,
    # stage-1/2 and crossing widths at 16 images, each at index0 1, S / 2
    # and S; then the generation path's 8 images (8 heads: 64 (image, head)
    # clusters) at stage 1/2's index0 64 and 256 and at stage 0's S 32
    (16, 32, 16, 32, None), (16, 4, 8, 96, None), (16, 4, 8, 256, None),
    (16, 4, 7, 256, None), (8, 4, 8, 256, ((64, 3), (256, 7))),
    (8, 32, 16, 32, ((32, 15),))]
FLASH_N = 8
FLASH_S = (1, 16, 64, 255, 256)
TRAIN_H, TRAIN_DH = 64, 8          # transformer_cascade.json: 512 / 64
# attention gradients, kernel path against the plain version's autograd:
# bf16 atol 5e-2 (the kernel's bf16 output enters delta = sum(dO * O) and
# every gradient is rounded to bf16); float32 atol 1e-4 (sums over up to
# 256 keys in another order)
GRAD_ATOL = {"bf16": 5e-2, "f32": 1e-4}
FWD_ATOL = {"bf16": ATOL, "f32": 1e-5}
BMU_SHAPES = [  # (M, D, K): HR at batch 8, LR, stage-1 HR, stage-0 LR, ragged
    # (row tiles); then the small-M geometry at one row and at 31; then
    # bench.py's smoke D 2, codebook_lr.json at image_C 8 (D 8192) in
    # both geometries' reach, and K 8192
    (2048, 16, 512), (512, 64, 512), (128, 256, 512), (8, 4096, 512),
    (300, 16, 64), (1, 4096, 512), (31, 4096, 512), (2048, 2, 512),
    (8, 8192, 512), (32, 8192, 512), (2048, 16, 8192), (8, 4096, 8192)]
# backward shapes: the decoder's and the encoder's layers of
# transformer_cascade.json, the generation path's 8 heads of dim 64, and
# in_dim 512 in heads of 16, 32 and 128, so that every head dim the
# kernels instantiate has a time (192 and 256: FLASH_WIDE_DH)
FLASH_TRAIN_SHAPES = [  # (H, dh, S, causal)
    (TRAIN_H, TRAIN_DH, 256, True), (TRAIN_H, TRAIN_DH, 64, False),
    (H, DH, 256, True), (32, 16, 256, True), (16, 32, 256, True),
    (4, 128, 256, True)]
# N * H = 65536, past the 65535 of a grid's y axis: 1024 rows of the
# training path's 64 heads; S 64 keeps the plain version's N*H*S^2 float32
# scores at 1 GB
FLASH_WIDE = dict(N=1024, H=TRAIN_H, dh=TRAIN_DH, S=64)
# head dims past 128 that qaig_tpu's Pallas kernel takes (in_dim 512 in 2
# heads, 768 in 4), at the generation path's N and longest S
FLASH_WIDE_DH = [dict(N=FLASH_N, H=2, dh=256, S=256),
                 dict(N=FLASH_N, H=4, dh=192, S=256)]


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2: device and build
# ---------------------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA GPU")
    repo = Path(__file__).resolve().parent
    if not (repo / "qaig_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no qaig_tpu_torch package beside "
                         f"{Path(__file__).name}; run it from a checkout")
    sys.path.insert(0, str(repo))
    from qaig_tpu_torch.train.common import full_float32
    full_float32()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}"
        f" cudnn={torch.backends.cudnn.allow_tf32} (qaig_tpu_torch.train."
        f"common.full_float32)")
    return name, smi


def phase_build():
    from qaig_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.build()
    seconds = time.perf_counter() - t0
    log(f"[build] {', '.join(cuda_build.SOURCES)} built in {seconds:.1f} s "
        f"into {cuda_build.BUILD_DIR}")
    for name in cuda_build.SOURCES:
        if (cuda_build.BUILD_DIR / f"{name}.log").exists():
            for k in ptxas_report(name):
                log(f"[build] {name} {kernel_name(k['function'])}: "
                    f"{k.get('registers')} registers, "
                    f"{k.get('spill_store_bytes')} / "
                    f"{k.get('spill_load_bytes')} bytes spilled (stores / "
                    f"loads)")


def kernel_name(mangled):
    """A kernel's name and template arguments from its mangled symbol
    (``flash_bwd_dq_f32_kernel<128>``), or the symbol where the pattern
    does not fit."""
    import re
    m = re.match(r"_ZN?", mangled)
    at, name = (m.end() if m else 0), None
    while at < len(mangled) and mangled[at].isdigit():
        size = re.match(r"\d+", mangled[at:]).group()
        at += len(size)
        name, at = mangled[at:at + int(size)], at + int(size)
    if name is None:
        return mangled
    rest, args = mangled[at:], []
    if not rest.startswith("I"):
        return name
    rest = rest[1:]
    types = {"f": "float", "a": "int8", "i": "int", "13__nv_bfloat16": "bf16"}
    while rest and not rest.startswith("E"):
        lit = re.match(r"L[a-z](\d+)E", rest)
        typ = next((t for t in types if rest.startswith(t)), None)
        sub = re.match(r"S\d*_", rest)
        if sub and args:   # a substitution: here, the type named before
            args.append(args[-1])
            rest = rest[sub.end():]
        elif lit:
            args.append(lit.group(1))
            rest = rest[lit.end():]
        elif typ:
            args.append(types[typ])
            rest = rest[len(typ):]
        else:
            return mangled
    return f"{name}<{', '.join(args)}>"


def ptxas_report(name):
    """Registers and spill bytes of each kernel of one source, from the
    ``-Xptxas -v`` report that phase 2's build keeps beside the library."""
    from qaig_tpu_torch.ops import cuda_build
    kernels, current = [], None
    report = (cuda_build.BUILD_DIR / f"{name}.log").read_text()
    for line in report.splitlines():
        if "Compiling entry function" in line:
            current = {"function": line.split("'")[1]}
            kernels.append(current)
        elif current is not None and "spill stores" in line:
            words = line.replace(",", "").split()
            current["spill_store_bytes"] = int(words[words.index("spill") - 2])
            current["spill_load_bytes"] = int(words[-4])
        elif current is not None and "Used" in line and "registers" in line:
            words = line.split()
            current["registers"] = int(words[words.index("registers,") - 1]
                                       if "registers," in words else
                                       words[words.index("registers") - 1])
    return kernels


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
        # ~0.5 s of load and a few timed rounds first, so the first kernel
        # timed meets neither an idle clock nor a cold flush
        torch.cuda._sleep(1_000_000_000)
        self(lambda: self.flush_buf[:16].zero_(), iters=10)

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
    """Kernels B and C against their plain version at ``DECODE_SHAPES``,
    bf16 (atol 2e-2) and float32 (atol 1e-5; serving's phase 7 (a) runs B
    in float32).  Each with its launch plan, its bits equal over two
    calls, and timed in the split its plan did not take (1 or 2 CTAs a
    cluster).  A checkout from before kernel B's split has no
    ``launch_plan``, and one from before kernel C ran on B's kernel no
    int8 plan: their records carry none, so this check times the old
    kernels there."""
    import inspect
    from qaig_tpu_torch.ops import cuda_build
    from qaig_tpu_torch.ops import decode_attention as da
    from qaig_tpu_torch.ops.kv_quant import quantize_kv_t
    gen = torch.Generator(device="cuda").manual_seed(0)
    split = hasattr(da, "launch_plan")
    int8_split = split and "prefix_itemsize" in inspect.signature(
        da.launch_plan).parameters

    for kind, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        size = 2 if kind == "bf16" else 4

        def rnd(*shape):
            return (torch.randn(*shape, generator=gen, device="cuda")
                    * 0.5).to(dtype)

        for n, b, bw, s, steps in DECODE_SHAPES:
            q = rnd(n * b, 1, H * DH)
            kt, vt = rnd(n, H, DH, s), rnd(n, H, DH, s)
            kb, vb = rnd(n * b, H, bw, DH), rnd(n * b, H, bw, DH)
            k8, ks = quantize_kv_t(kt)
            v8, vs = quantize_kv_t(vt)
            for index0, block_index in steps or ((1, 0), (s // 2, bw // 2),
                                                  (s, bw - 1)):
                for kernel, planned in (
                        ("shared_prefix_attention_fused_t", split),
                        ("shared_prefix_attention_fused_int8", int8_split)):
                    check_decode_call(
                        torch, timer, records, da, cuda_build, kernel, kind,
                        (q, kt, vt, kb, vb, k8, ks, v8, vs), bw, s, index0,
                        block_index, size, planned)


def check_decode_call(torch, timer, records, da, cuda_build, kernel, kind,
                      tensors, bw, s, index0, block_index, size, planned):
    """One decode kernel at one step: held to its plain version, timed
    beside it and its bound; with ``planned`` (the split kernel) its bits
    equal over two calls and its other split timed too."""
    q, kt, vt, kb, vb, k8, ks, v8, vs = tensors
    n = kt.shape[0]
    b = q.shape[0] // n
    atol = FWD_ATOL[kind]
    quant = kernel.endswith("int8")
    if quant:
        args = (q, k8, ks, v8, vs, kb, vb, index0, block_index)
        plain_args = (q, k8, v8, kb, vb, index0, block_index)
        plain_kw = {"k_scale": ks, "v_scale": vs}
        split_args = (q, k8, v8, kb, vb, index0, block_index)
        prefix_bytes = 2 * n * H * index0 * (DH + 2)
        pelem = 1
    else:
        args = (q, kt, vt, kb, vb, index0, block_index)
        plain_args = split_args = args
        plain_kw = {}
        prefix_bytes = 2 * n * H * index0 * DH * size
        pelem = size
    fn = getattr(da, kernel)

    def run_kernel():
        return fn(*args)

    def run_plain():
        return da.shared_prefix_attention_reference(*plain_args, **plain_kw)

    got = run_kernel()
    want = run_plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    plan = None
    if planned:
        # the split kernel combines its CTAs in rank order: same bits
        if not torch.equal(got, run_kernel()):
            raise SystemExit(f"{kernel} {kind} N={n} B={b} index0={index0}: "
                             f"two calls differ")
        plan = da.launch_plan(n, b, H, DH, index0,
                              cuda_build.sm_count(q.device), size,
                              block_index, *((pelem,) if quant else ()))
    nbytes = (prefix_bytes + 2 * q.numel() * size
              + 2 * n * b * H * (block_index + 1) * DH * size)
    flops = 4 * n * b * H * DH * (index0 + block_index + 1)
    bound_ms, bound_by = bound(nbytes, flops, kind)
    rec = {"name": kernel, "shape": {
        "N": n, "B": b, "bw": bw, "S": s, "index0": index0,
        "block_index": block_index, "dtype": kind}, "max_abs_err": err,
        "ms": timer(run_kernel), "plain_ms": timer(run_plain),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    note = ""
    if plan is not None:
        rec["launch_plan"] = plan
        rec["alternatives"] = []
        other = 3 - plan["splits"]
        scales = {"k_scale": ks, "v_scale": vs} if quant else {}
        try:
            alt = da._plan(n, b, H, DH, index0, cuda_build.sm_count(q.device),
                           size, block_index, other,
                           *((pelem,) if quant else ()))
        except ValueError:   # no split of index0 in two non-empty ranges
            alt = None
        if alt is not None:
            e = (da._launch_split(*split_args, alt, **scales).float()
                 - want.float()).abs().max().item()
            if not e <= atol:
                raise SystemExit(f"{kernel} {kind} in {other} CTAs "
                                 f"disagrees: {e}")
            rec["alternatives"].append({
                "label": f"splits {other}", "launch_plan": alt,
                "max_abs_err": e,
                "ms": timer(lambda: da._launch_split(*split_args, alt,
                                                     **scales))})
        note = (f" splits={plan['splits']} chunk={plan['chunk']} "
                f"stages={plan['stages']}"
                + "".join(f" ({a['label']}: ms={a['ms']:.4f})"
                          for a in rec["alternatives"])
                + " (equal bits over two calls)")
    records.append(rec)
    log(f"[kernels] {kernel} {kind} N={n} B={b} bw={bw} S={s} "
        f"index0={index0} block_index={block_index}: "
        f"max_abs_err={err:.3e} ms={rec['ms']:.4f} "
        f"plain_ms={rec['plain_ms']:.4f} "
        f"bound_ms={bound_ms:.5f} ({bound_by}){note}")
    if not err <= atol:
        raise SystemExit(f"{kernel} ({kind}) disagrees with its plain "
                         f"version: {err} > {atol}")


FLAT_SHAPES = [  # (N, B, bw, S, index0, block_index): stage-1/2 widths at
    # 16 images at a full, a partly filled and an empty prefix; the flat
    # path's own 8 images at the read lengths and index0 its engine reaches
    # (stage 1: S 64, index0 57; stage 2: S 256, index0 129 and 241); the
    # stage-0 fan (H*B 256, which the engine does not route to the flat
    # kernel)
    (16, 4, 8, 256, 256, 7), (16, 4, 8, 256, 96, 3), (16, 4, 8, 256, 1, 0),
    (8, 4, 8, 64, 57, 7), (8, 4, 8, 256, 129, 7), (8, 4, 8, 256, 241, 7),
    (16, 32, 16, 32, 32, 15)]


def check_flat(torch, timer, records):
    """The flat kernel against its plain version on interleaved caches:
    bf16 and the int8 prefix (atol 2e-2), float32 (atol 1e-5), with its
    launch plan, its bits equal over two calls, and timed in a cluster
    twice (at 8, half) the size its plan took.  A checkout
    from before the flat kernel's single launch has no
    ``flat_launch_plan``: its records carry none, so this check times the
    old kernel there.  Bound: the live prefix K/V (plus the int8 scales),
    the live block slots, q and out, over the HBM rate (and the flops over
    the peak, the larger)."""
    from qaig_tpu_torch.ops import cuda_build
    from qaig_tpu_torch.ops import decode_attention as da
    from qaig_tpu_torch.ops.kv_quant import quantize_kv_t
    gen = torch.Generator(device="cuda").manual_seed(4)
    flat = da.shared_prefix_attention_fused_flat
    planned = hasattr(da, "flat_launch_plan")
    for n, b, bw, s, index0, block_index in FLAT_SHAPES:
        for kind, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            def rnd(*shape):
                return (torch.randn(*shape, generator=gen, device="cuda")
                        * 0.5).to(dtype)
            q = rnd(n * b, 1, H * DH)
            kt, vt = rnd(n, H, DH, s), rnd(n, H, DH, s)
            kb, vb = rnd(n * b, H, bw, DH), rnd(n * b, H, bw, DH)
            (k8, ks), (v8, vs) = quantize_kv_t(kt), quantize_kv_t(vt)
            size = 2 if kind == "bf16" else 4
            for name in ("shared_prefix_attention_fused_flat",
                         "shared_prefix_attention_fused_flat_int8"):
                if name.endswith("int8"):
                    args = (q, da.interleave_t(k8), da.interleave_t(v8), kb,
                            vb, index0, block_index, H)
                    kw = {"k_scale": da.interleave_scale(ks),
                          "v_scale": da.interleave_scale(vs)}
                    prefix_bytes = 2 * n * H * index0 * (DH + 2)
                    pelem = 1
                else:
                    args = (q, da.interleave_t(kt), da.interleave_t(vt), kb,
                            vb, index0, block_index, H)
                    kw = {}
                    prefix_bytes = 2 * n * H * index0 * DH * size
                    pelem = size

                def run_kernel():
                    return flat(*args, **kw)

                def run_plain():
                    return da.shared_prefix_attention_flat_reference(
                        *args, **kw)

                got = run_kernel()
                want = run_plain()
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                nbytes = (prefix_bytes + 2 * q.numel() * size
                          + 2 * n * b * H * (block_index + 1) * DH * size)
                flops = 4 * n * b * H * DH * (index0 + block_index + 1)
                bound_ms, bound_by = bound(nbytes, flops, kind)
                rec = {"name": name, "shape": {
                    "N": n, "B": b, "bw": bw, "S": s, "index0": index0,
                    "block_index": block_index, "dtype": kind},
                    "max_abs_err": err, "ms": timer(run_kernel),
                    "plain_ms": timer(run_plain), "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None}
                note = ""
                if planned:
                    if not torch.equal(got, run_kernel()):
                        raise SystemExit(f"{name} {kind} N={n} B={b} "
                                         f"index0={index0}: two calls "
                                         f"differ")
                    plan = da.flat_launch_plan(
                        n, b, H, DH, index0, cuda_build.sm_count(q.device),
                        pelem, block_index, size)
                    rec["launch_plan"] = plan
                    held = cuda_build.function(
                        "decode_attention_flat",
                        "qaig_flat_attention_max_clusters",
                        [ctypes.c_int] * 8)
                    rec["clusters_held"] = held(
                        plan["rollouts"], H, DH, plan["tile"],
                        int(kind == "bf16"), int(pelem == 1),
                        plan["splits"], plan["stages"])
                    rec["alternatives"] = []
                    # the cluster twice (or, at 8, half) the plan's size
                    other = (plan["splits"] * 2 if plan["splits"] * 2
                             <= da.FLAT_MAX_SPLITS else plan["splits"] // 2)
                    try:
                        alt = da._flat_plan(
                            n, b, H, DH, index0,
                            cuda_build.sm_count(q.device), pelem,
                            block_index, size, other)
                    except ValueError:   # not that many non-empty ranges
                        alt = None
                    if alt is not None and other:
                        e = (da._launch_flat(*args[:3], kw.get("k_scale"),
                                             kw.get("v_scale"), *args[3:],
                                             plan=alt).float()
                             - want.float()).abs().max().item()
                        if not e <= FWD_ATOL[kind]:
                            raise SystemExit(f"{name} {kind} in {other} "
                                             f"CTAs disagrees: {e}")
                        rec["alternatives"].append({
                            "label": f"splits {other}", "launch_plan": alt,
                            "clusters_held": held(
                                alt["rollouts"], H, DH, alt["tile"],
                                int(kind == "bf16"), int(pelem == 1),
                                alt["splits"], alt["stages"]),
                            "max_abs_err": e, "ms": timer(
                                lambda: da._launch_flat(
                                    *args[:3], kw.get("k_scale"),
                                    kw.get("v_scale"), *args[3:],
                                    plan=alt))})
                    note = (f" splits={plan['splits']} "
                            f"tile={plan['tile']} stages={plan['stages']} "
                            f"smem={plan['smem']} clusters held "
                            f"{rec['clusters_held']}"
                            + "".join(
                                f" ({a['label']}: tile="
                                f"{a['launch_plan']['tile']} clusters held "
                                f"{a['clusters_held']} ms={a['ms']:.4f})"
                                for a in rec["alternatives"])
                            + " (equal bits over two calls)")
                records.append(rec)
                log(f"[kernels] {name} {kind} N={n} B={b} bw={bw} S={s} "
                    f"index0={index0} block_index={block_index}: "
                    f"max_abs_err={err:.3e} ms={rec['ms']:.4f} "
                    f"plain_ms={rec['plain_ms']:.4f} "
                    f"bound_ms={bound_ms:.5f} ({bound_by}){note}")
                if not err <= FWD_ATOL[kind]:
                    raise SystemExit(f"{name} ({kind}) disagrees with its "
                                     f"plain version: {err}")


def check_flash(torch, timer, records):
    import torch.nn.functional as F
    from qaig_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)
    n, d = FLASH_N, H * DH
    for kind, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        size = 2 if kind == "bf16" else 4
        for s in FLASH_S:
            q, k, v = ((torch.randn(n, s, d, generator=gen, device="cuda")
                        * 0.5).to(dtype) for _ in range(3))
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
                bound_ms, bound_by = bound(4 * n * s * d * size,
                                           4 * n * H * pairs * DH, kind)
                rec = {"name": "flash_attention", "shape": {
                    "N": n, "S": s, "H": H, "dh": DH, "causal": causal,
                    "dtype": kind},
                    "max_abs_err": err, "ms": timer(run_kernel),
                    "plain_ms": timer(run_plain), "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": timer(run_library)}
                records.append(rec)
                log(f"[kernels] flash_attention N={n} S={s} causal={causal} "
                    f"{kind}: max_abs_err={err:.3e} ms={rec['ms']:.4f} "
                    f"plain_ms={rec['plain_ms']:.4f} "
                    f"sdpa_ms={rec['library_ms']:.4f} "
                    f"bound_ms={bound_ms:.5f} ({bound_by})")
                if not err <= FWD_ATOL[kind]:
                    raise SystemExit(f"flash_attention ({kind}) disagrees "
                                     f"with its plain version: {err}")


def check_flash_wide(torch, timer, records):
    """Kernel A forward and backward, causal, bf16 and float32, against the
    plain versions and beside SDPA (forward, and its backward through
    autograd): at N * H = 65536 (``FLASH_WIDE``), and at head dims 256 and
    192 (``FLASH_WIDE_DH``) reached through ``dot_product_attention``, which
    must launch both kernels once.  Then head dim 24, which
    ``dot_product_attention`` routes to its plain products without launching
    kernel A (the routing of ``qaig_tpu/ops/flash_attention.py::supported``,
    which sends it to XLA einsums)."""
    import torch.nn.functional as F
    from qaig_tpu_torch.ops import attention, cuda_build
    from qaig_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [(FLASH_WIDE, False, 5)] + [(c, True, 20) for c in FLASH_WIDE_DH]
    for case, via_attention, iters in cases:
        n, h, dh, s = (case[key] for key in ("N", "H", "dh", "S"))
        for kind, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            size = 2 if kind == "bf16" else 4
            q, k, v, dout = ((torch.randn(n, s, h * dh, generator=gen,
                                          device="cuda") * 0.5).to(dtype)
                             for _ in range(4))
            if via_attention:
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                before = (fa.flash_attention.launches,
                          fa.fused_flash_attention_backward.launches)
                out = attention.dot_product_attention(*leaves, h,
                                                      causal=True)
                out.backward(dout)
                moved = (fa.flash_attention.launches - before[0],
                         fa.fused_flash_attention_backward.launches
                         - before[1])
                log(f"[kernels] dot_product_attention dh={dh} ({h} heads, "
                    f"N={n} S={s}) {kind}: kernel A launches {moved[0]}, "
                    f"backward kernel launches {moved[1]}")
                if moved != (1, 1):
                    raise SystemExit(f"dot_product_attention at head dim "
                                     f"{dh} launched kernel A and its "
                                     f"backward {moved} times, not once")
                out = out.detach()
            else:
                out = fa.flash_attention(q, k, v, h, causal=True)

            def run_kernel():
                return fa.flash_attention(q, k, v, h, causal=True)

            def run_plain():
                return fa.flash_attention_reference(q, k, v, h, True)

            def run_backward():
                return fa.fused_flash_attention_backward(q, k, v, out, dout,
                                                         h, True)

            def run_plain_backward():
                return fa.flash_attention_backward(q, k, v, out, dout, h,
                                                   True)

            def heads(x):
                return x.view(n, s, h, dh).transpose(1, 2)

            def run_library():
                return F.scaled_dot_product_attention(
                    heads(q), heads(k), heads(v), is_causal=True)

            # SDPA's backward through autograd, its forward (and graph) made
            # once, outside the timed window
            lib_leaves = [heads(x).detach().requires_grad_()
                          for x in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*lib_leaves,
                                                     is_causal=True)

            def run_library_backward():
                return torch.autograd.grad(lib_out, lib_leaves, heads(dout),
                                           retain_graph=True)

            err = (out.float() - run_plain().float()).abs().max().item()
            bwd_err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(run_backward(),
                                          run_plain_backward()))
            torch.cuda.synchronize()
            pairs = s * (s + 1) // 2
            shape = {"N": n, "S": s, "H": h, "dh": dh, "causal": True,
                     "dtype": kind}
            plan = fa.backward_launch_plan(dtype, dh, s, h, n,
                                           cuda_build.sm_count(q.device))
            alternatives = backward_alternatives(
                torch, timer, fa, (q, k, v, out, dout, h, True), plan,
                run_plain_backward)
            bwd_err = max([bwd_err] + [a["max_abs_err"]
                                       for a in alternatives])
            for name, e, fn, plain, library, nbytes, flops in (
                    ("flash_attention", err, run_kernel, run_plain,
                     run_library, 4 * n * s * h * dh * size,
                     4 * n * h * pairs * dh),
                    ("flash_attention_backward", bwd_err, run_backward,
                     run_plain_backward, run_library_backward,
                     8 * n * s * h * dh * size, 10 * n * h * pairs * dh)):
                bound_ms, bound_by = bound(nbytes, flops, kind)
                rec = {"name": name, "shape": shape, "max_abs_err": e,
                       "ms": timer(fn, iters=iters),
                       "plain_ms": timer(plain, iters=iters),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": timer(library, iters=iters)}
                other = ""
                if name == "flash_attention_backward":
                    rec.update(launch_plan=plan, alternatives=alternatives)
                    other = "".join(f" ({a['label']}: ms={a['ms']:.4f})"
                                    for a in alternatives)
                records.append(rec)
                log(f"[kernels] {name} N={n} H={h} (N*H={n * h}) dh={dh} "
                    f"S={s} causal=True {kind}: max_abs_err={e:.3e} "
                    f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                    f"sdpa_ms={rec['library_ms']:.4f} "
                    f"bound_ms={bound_ms:.5f} ({bound_by}){other}")
            if not err <= FWD_ATOL[kind]:
                raise SystemExit(f"flash_attention at N*H {n * h} dh {dh} "
                                 f"({kind}) disagrees with its plain "
                                 f"version: {err}")
            if not bwd_err <= GRAD_ATOL[kind]:
                raise SystemExit(f"flash_attention_backward at N*H {n * h} "
                                 f"dh {dh} ({kind}) disagrees with the "
                                 f"plain products: {bwd_err}")
            del q, k, v, dout, out, lib_leaves, lib_out
            torch.cuda.empty_cache()
    heads, dh = 16, 24
    for kind, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        q, k, v = ((torch.randn(FLASH_N, 64, heads * dh, generator=gen,
                                device="cuda") * 0.5).to(dtype)
                   for _ in range(3))
        for causal in (True, False):
            launches = fa.flash_attention.launches
            got = attention.dot_product_attention(q, k, v, heads,
                                                  causal=causal)
            want = fa.flash_attention_reference(q, k, v, heads, causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            moved = fa.flash_attention.launches - launches
            log(f"[kernels] dot_product_attention dh={dh} ({heads} heads, "
                f"N={FLASH_N} S=64) causal={causal} {kind}: plain products, "
                f"max_abs_err={err:.3e} against flash_attention_reference; "
                f"kernel A launches {moved}")
            if moved or fa.supported(q, k, v, heads, causal, None, None):
                raise SystemExit(f"dot_product_attention at head dim {dh} "
                                 f"launched kernel A")
            if not err <= FWD_ATOL[kind]:
                raise SystemExit(f"dot_product_attention at head dim {dh} "
                                 f"({kind}) disagrees with the plain "
                                 f"version: {err}")


def check_flash_train(torch, timer, records):
    """Kernel A at the training path's head dim (64 heads of 8; decoder S
    256 causal, encoder S 64) and at 8 heads of 64, 32 of 16, 16 of 32 and
    4 of 128 (S 256 causal), forward and gradient, bf16 and float32.  The
    backward kernel is held against the plain
    ``_flash_bwd`` products on the same (q, k, v, out, dout) and timed
    beside them, SDPA's backward and its bound."""
    import torch.nn.functional as F
    from qaig_tpu_torch.ops import cuda_build
    from qaig_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(2)
    n = FLASH_N
    for h, dh, s, causal in FLASH_TRAIN_SHAPES:
        for kind, dtype in (("bf16", torch.bfloat16),
                            ("f32", torch.float32)):
            q, k, v = ((torch.randn(n, s, h * dh, generator=gen,
                                    device="cuda") * 0.5).to(dtype)
                       for _ in range(3))
            weight = torch.randn(n, s, h * dh, generator=gen, device="cuda")

            def heads(x):
                return x.view(n, s, h, dh).transpose(1, 2)

            def run_kernel():
                return fa.flash_attention(q, k, v, h, causal=causal)

            def run_plain():
                return fa.flash_attention_reference(q, k, v, h, causal)

            def run_library():
                return F.scaled_dot_product_attention(
                    heads(q), heads(k), heads(v), is_causal=causal)

            err = (run_kernel().float() - run_plain().float()).abs().max()
            err = err.item()
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            got = torch.autograd.grad(
                (fa.flash_attention(qg, kg, vg, h, causal=causal).float()
                 * weight).sum(), (qg, kg, vg))
            want = torch.autograd.grad(
                (fa.flash_attention_reference(qg, kg, vg, h, causal)
                 .float() * weight).sum(), (qg, kg, vg))
            grad_err = max((a.float() - b.float()).abs().max().item()
                           for a, b in zip(got, want))
            out = run_kernel()
            dout = torch.randn_like(out)

            def run_backward():
                return fa.fused_flash_attention_backward(q, k, v, out, dout,
                                                         h, causal)

            def run_plain_backward():
                return fa.flash_attention_backward(q, k, v, out, dout, h,
                                                   causal)

            bwd_err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(run_backward(),
                                          run_plain_backward()))
            # the yardstick: SDPA's backward through autograd, its forward
            # (and graph) made once, outside the timed window
            leaves = [heads(x).detach().requires_grad_() for x in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*leaves,
                                                     is_causal=causal)
            lib_dout = heads(dout.to(dtype))

            def run_library_backward():
                return torch.autograd.grad(lib_out, leaves, lib_dout,
                                           retain_graph=True)

            pairs = s * (s + 1) // 2 if causal else s * s
            size = 2 if kind == "bf16" else 4
            bound_ms, bound_by = bound(4 * n * s * h * dh * size,
                                       4 * n * h * pairs * dh, kind)
            # backward: q, k, v, out, dout read, dq, dk, dv written; five
            # products over the live pairs (scores, dP, dV, dQ, dK)
            bwd_bound_ms, bwd_bound_by = bound(8 * n * s * h * dh * size,
                                               10 * n * h * pairs * dh, kind)
            shape = {"N": n, "S": s, "H": h, "dh": dh, "causal": causal,
                     "dtype": kind}
            plan = fa.backward_launch_plan(dtype, dh, s, h, n,
                                           cuda_build.sm_count(q.device))
            bwd = {"name": "flash_attention_backward", "shape": shape,
                   "max_abs_err": bwd_err, "ms": timer(run_backward),
                   "plain_ms": timer(run_plain_backward),
                   "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by,
                   "library_ms": timer(run_library_backward),
                   "launch_plan": plan}
            bwd["alternatives"] = backward_alternatives(
                torch, timer, fa, (q, k, v, out, dout, h, causal), plan,
                run_plain_backward)
            bwd_err = max([bwd_err] + [a["max_abs_err"]
                                       for a in bwd["alternatives"]])
            rec = {"name": "flash_attention", "shape": shape,
                   "max_abs_err": err, "grad_max_abs_err": grad_err,
                   "ms": timer(run_kernel), "plain_ms": timer(run_plain),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": timer(run_library),
                   "backward_ms": bwd["ms"],
                   "plain_backward_ms": bwd["plain_ms"],
                   "backward_bound_ms": bwd_bound_ms,
                   "backward_bound_by": bwd_bound_by,
                   "backward_library_ms": bwd["library_ms"]}
            records += [rec, bwd]
            log(f"[kernels] flash_attention H={h} dh={dh} N={n} S={s} "
                f"causal={causal} {kind}: max_abs_err={err:.3e} "
                f"grad_max_abs_err={grad_err:.3e} ms={rec['ms']:.4f} "
                f"plain_ms={rec['plain_ms']:.4f} "
                f"sdpa_ms={rec['library_ms']:.4f} "
                f"bound_ms={bound_ms:.5f} ({bound_by})")
            other = "".join(
                f" ({a['label']}: ms={a['ms']:.4f})"
                for a in bwd["alternatives"])
            log(f"[kernels] flash_attention_backward H={h} dh={dh} N={n} "
                f"S={s} causal={causal} {kind} {plan['form']} cluster "
                f"{plan['cluster']}: max_abs_err="
                f"{bwd_err:.3e} ms={bwd['ms']:.4f} "
                f"plain_ms={bwd['plain_ms']:.4f} "
                f"sdpa_backward_ms={bwd['library_ms']:.4f} "
                f"bound_ms={bwd_bound_ms:.5f} ({bwd_bound_by}){other}")
            if not err <= FWD_ATOL[kind]:
                raise SystemExit(f"flash_attention (dh {dh}, {kind}) "
                                 f"disagrees with its plain version: {err}")
            if not grad_err <= GRAD_ATOL[kind]:
                raise SystemExit(f"flash_attention gradient (dh {dh}, "
                                 f"{kind}) disagrees with the plain "
                                 f"version's: {grad_err}")
            if not bwd_err <= GRAD_ATOL[kind]:
                raise SystemExit(f"flash_attention_backward (dh {dh}, "
                                 f"{kind}) disagrees with the plain "
                                 f"products: {bwd_err}")


def backward_alternatives(torch, timer, fa, args, plan, run_plain):
    """The float32 register-blocked backward in the cluster size its plan
    did not take (1 or 2 CTAs sharing a block's streamed rows), held to
    the plain products and timed beside the plan's: the measurement
    behind the plan's rule."""
    from qaig_tpu_torch.ops import cuda_build
    if plan["form"] != "f32_fma":
        return []
    q, k, v, out, dout, h, causal = args
    n, s, d = q.shape
    cluster = 3 - plan["cluster"]
    other = fa._backward_plan(torch.float32, d // h, s, h, n,
                              cuda_build.sm_count(q.device), cluster)

    def run_other():
        return fa._backward(*args, plan=other)

    err = max((a - b).abs().max().item()
              for a, b in zip(run_other(), run_plain()))
    return [{"label": f"cluster {cluster}", "launch_plan": other,
             "ms": timer(run_other), "max_abs_err": err}]


def check_bmu(torch, timer, records):
    """The BMU kernel against its plain version at the codebook shapes of
    the cascade, and on codebooks with duplicated rows in both geometries
    (first index, exactly)."""
    from qaig_tpu_torch.ops import bmu
    gen = torch.Generator(device="cuda").manual_seed(3)
    for m, d, k in BMU_SHAPES:
        plan = bmu.launch_plan(m, d, k)
        patches = torch.randn(m, d, generator=gen, device="cuda")
        codes = torch.randn(k, d, generator=gen, device="cuda") * 0.5

        def run_kernel():
            return bmu.fused_bmu(patches, codes)

        def run_plain():
            return bmu.bmu_argmin_reference(patches, codes)

        def run_library():
            return torch.cdist(patches, codes).argmin(1)

        agree = bmu.near_tie_agreement(patches, codes, run_kernel(),
                                       run_plain())
        bound_ms, bound_by = bound((m * d + k * d) * 4 + m * 8,
                                   2 * m * k * d, "f32")
        # max_abs_err: the largest float64 gap between the distance of the
        # kernel's pick and the true minimum (0 where every pick is a best)
        rec = {"name": "fused_bmu", "shape": {"M": m, "D": d, "K": k},
               "plan": plan, "max_abs_err": agree["max_gap"],
               "near_tie_rows": agree["near_tie_rows"],
               "differing_rows": agree["differing_rows"],
               "ms": timer(run_kernel), "plain_ms": timer(run_plain),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": timer(run_library)}
        records.append(rec)
        log(f"[kernels] fused_bmu M={m} D={d} K={k} ({plan['geometry']}, "
            f"{plan['blocks']} blocks): indices differ on "
            f"{agree['differing_rows']} rows, all within the "
            f"{agree['near_tie_rows']} near-tie rows; largest distance gap "
            f"{agree['max_gap']:.3e}; ms={rec['ms']:.4f} "
            f"plain_ms={rec['plain_ms']:.4f} "
            f"cdist_argmin_ms={rec['library_ms']:.4f} "
            f"bound_ms={bound_ms:.5f} ({bound_by})")
    for m, d in ((2048, 16), (8, 4096), (8, 8192)):  # row tiles; small M
        codes = torch.randn(64, d, generator=gen, device="cuda")
        rows = torch.randint(0, 64, (m,), generator=gen, device="cuda")
        patches = (codes[rows] + 1e-3 * torch.randn(
            m, d, generator=gen, device="cuda")).contiguous()
        copies = torch.cat([codes] * 8).contiguous()
        got = bmu.fused_bmu(patches, copies)
        if bool((got >= 64).any()):
            raise SystemExit(f"fused_bmu (M {m}, D {d}): a duplicated "
                             f"codebook did not give the first index")
        agree = bmu.near_tie_agreement(patches, codes, got,
                                       bmu.bmu_argmin_reference(patches,
                                                                codes))
        log(f"[kernels] fused_bmu duplicated codes (64 x 8 copies, M={m}, "
            f"D={d}, {bmu.launch_plan(m, d, 512)['geometry']}): first "
            f"index on every row; against the 64 distinct codes, indices "
            f"differ on {agree['differing_rows']} rows, "
            f"{agree['near_tie_rows']} near-tie rows, largest distance gap "
            f"{agree['max_gap']:.3e}")


MLP_SHAPES = [  # (N, S, act_last): the probe's packed QKV and FFN at 8192
    # and 1024 rows, and a ragged N
    (8192, 3, False), (8192, 1, True), (1024, 3, False), (1024, 1, True),
    (1000, 3, False), (1000, 1, True)]
MLP_D, MLP_H = 512, 2048


def check_mlp(torch, timer, records):
    """Kernel 6 against its plain version in bf16 (atol 2e-2) at the
    probe's shapes.  Bound: the function's operations (both products, no
    recomputation) and bytes (x, weights, biases read once, out written
    once).  No single PyTorch call computes the function, so the yardstick
    is the same arithmetic as two cuBLAS products plus elementwise calls
    (``library_chain_ms``; ``library_ms`` stays null)."""
    import torch.nn.functional as F
    from qaig_tpu_torch.ops import mlp_fused as mf
    gen = torch.Generator(device="cuda").manual_seed(6)
    d, hid = MLP_D, MLP_H
    resident = mf.resident_blocks(d, d, torch.device("cuda", 0))
    log(f"[kernels] mlp2_fused resident blocks by cluster size: {resident}")
    for kernel in ptxas_report("mlp2_fused"):
        log(f"[kernels] mlp2_fused ptxas {kernel['function']}: "
            f"{kernel.get('registers')} registers, spill stores / loads "
            f"{kernel.get('spill_store_bytes')} / "
            f"{kernel.get('spill_load_bytes')} bytes")
    for n, s, act_last in MLP_SHAPES:
        def rnd(*shape):
            return (torch.randn(*shape, generator=gen, device="cuda")
                    * 0.05).to(torch.bfloat16)
        x, w0, b0 = rnd(n, d), rnd(s * hid, d), rnd(s * hid)
        w1, b1 = rnd(s, d, hid), rnd(s, d)

        def run_kernel():
            return mf.mlp2_fused(x, w0, b0, w1, b1, act_last=act_last)

        def run_plain():
            return mf.mlp2_fused_reference(x, w0, b0, w1, b1, act_last)

        def run_library_chain():
            h = F.silu(F.linear(x, w0, b0)).view(n, s, hid).transpose(0, 1)
            o = torch.baddbmm(b1[:, None], h, w1.transpose(1, 2))
            return F.silu(o) if act_last else o

        err = (run_kernel().float() - run_plain().float()).abs().max().item()
        chain_err = (run_library_chain().float()
                     - run_plain().float()).abs().max().item()
        flops = 2 * n * d * s * hid + 2 * n * s * hid * d
        nbytes = 2 * (n * d + s * hid * d + s * hid + s * d * hid + s * d
                      + s * n * d)
        bound_ms, bound_by = bound(nbytes, flops)
        geo = mf.launch_geometry(n, s, hid, resident)
        rec = {"name": "mlp2_fused", "shape": {
            "N": n, "S": s, "act_last": act_last, "D": d, "H": hid,
            "D2": d}, "blocks": geo.grid_x * s * geo.parts,
            "hidden_parts": geo.parts, "cluster": geo.cluster,
            "weight_l2_bytes": mf.weight_l2_bytes(n, d, s, hid, d, resident),
            "ptxas": ptxas_report("mlp2_fused"),
            "max_abs_err": err, "library_chain_max_abs_err": chain_err,
            "ms": timer(run_kernel), "plain_ms": timer(run_plain),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library_chain_ms": timer(run_library_chain)}
        if n == 8192:  # the same call in each cluster size
            rec["ms_by_cluster"] = {c: timer(lambda: mf.mlp2_fused(
                x, w0, b0, w1, b1, act_last=act_last, cluster=c))
                for c in (1, 2, 4)}
            sweep = []
            for c, ms in rec["ms_by_cluster"].items():
                gb = mf.weight_l2_bytes(n, d, s, hid, d, resident, c) / 1e9
                sweep.append(f"{c}: {ms:.4f} ms ({gb:.3f} GB)")
            log(f"[kernels] mlp2_fused N={n} S={s} by cluster size: "
                + ", ".join(sweep))
        records.append(rec)
        log(f"[kernels] mlp2_fused N={n} S={s} act_last={act_last} "
            f"({rec['blocks']} blocks in clusters of {geo.cluster}, hidden "
            f"in {geo.parts} parts, {rec['weight_l2_bytes'] / 1e9:.3f} GB "
            f"of weights from L2): "
            f"max_abs_err={err:.3e} (library chain {chain_err:.3e}) "
            f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
            f"library_chain_ms={rec['library_chain_ms']:.4f} "
            f"bound_ms={bound_ms:.5f} ({bound_by})")
        if not err <= ATOL:
            raise SystemExit(f"mlp2_fused disagrees with its plain version: "
                             f"{err} > {ATOL}")


# ---------------------------------------------------------------------------
# phase 4: a small cascade stage, card (kernels) against CPU (plain)
# ---------------------------------------------------------------------------

def _greedy_small_stage(torch, steps, beam_width, window, device="cuda",
                        **engine_kw):
    """Greedy float32 rollouts of a small windowed encoder-decoder stage
    (dh 32) on the CPU and on ``device`` from the same weights; returns
    ({"cpu": tokens, "card": tokens}, the second run's launches)."""
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
    cuda_model = Transformer(cfg, device=device).requires_grad_(False)
    cuda_model.load_state_dict(cpu_model.state_dict())
    gen = torch.Generator().manual_seed(4)
    x_enc = torch.randint(0, 32, (2, 16), generator=gen)
    init = torch.full((2, 1), 32, dtype=torch.long)
    settings = decode.SamplerSettings(end_token=32, pos_offset=1)
    sample = decode._categorical
    decode._categorical = lambda logits, rng: logits.argmax(dim=-1)
    try:
        out = {}
        for key, dev, model in (("cpu", "cpu", cpu_model),
                                ("card", device, cuda_model)):
            synchronize(torch, dev)
            reset_launches()
            out[key] = decode.DecodeEngine(
                model, **engine_kw).rollout_generate(
                    init.to(dev), steps, torch.Generator(device=dev),
                    settings, num_beam=3, beam_width=beam_width,
                    x_enc=x_enc.to(dev), sliding_window=window).cpu()
            synchronize(torch, dev)
        launches = read_launches()
    finally:
        decode._categorical = sample
    return out, launches


def check_reference(torch, device="cuda", quantized_prefix=False):
    """Phase 4: window 8 and segments of 4 give a crossing segment and
    steady windowed segments; the card's tokens must equal the CPU's.
    With ``quantized_prefix`` the cached segments read an int8 prefix, so
    they must launch kernel C (and not B)."""
    out, launches = _greedy_small_stage(torch, 16, 4, 8, device,
                                        quantized_prefix=quantized_prefix)
    same = bool(torch.equal(out["cpu"], out["card"]))
    label = "int8 prefix, " if quantized_prefix else ""
    log(f"[reference] small windowed stage, {label}greedy float32: card "
        f"tokens {'equal' if same else 'DIFFER from'} the CPU's "
        f"({out['card'].tolist()[0][:8]}...); card launches {launches}")
    if not same:
        raise SystemExit(f"card and CPU generations disagree ({label}"
                         f"phase 4)")
    quant = launches["shared_prefix_attention_fused_int8"]
    if quantized_prefix and (
            quant <= 0 or launches["shared_prefix_attention_fused_t"]):
        raise SystemExit(f"int8-prefix stage launched {launches}: expected "
                         f"kernel C and no kernel B")


def check_flat_reference(torch, device="cuda", quantized_prefix=False):
    """Phase 4c: the same stage with ``flat_decode=True``, window 20 and
    segments of 8: two cached segments through the flat kernel (2 layers x
    16 steps on the card), then a 3-step crossing on kernel B (C with
    ``quantized_prefix``, and the flat kernel's int8 form) and windowed
    recompute.  The card's tokens must equal the CPU's."""
    out, launches = _greedy_small_stage(torch, 24, 8, 20, device,
                                        flat_decode=True,
                                        quantized_prefix=quantized_prefix)
    same = bool(torch.equal(out["cpu"], out["card"]))
    label = "int8 prefix, " if quantized_prefix else ""
    log(f"[reference] flat decode, {label}small windowed stage, greedy "
        f"float32: card tokens {'equal' if same else 'DIFFER from'} the "
        f"CPU's ({out['card'].tolist()[0][:8]}...); card launches "
        f"{launches}")
    if not same:
        raise SystemExit(f"card and CPU flat-decode generations disagree "
                         f"({label}phase 4c)")
    flat, slot_minor = (
        ("shared_prefix_attention_fused_flat_int8",
         "shared_prefix_attention_fused_int8") if quantized_prefix else
        ("shared_prefix_attention_fused_flat",
         "shared_prefix_attention_fused_t"))
    want = {name: 0 for name in (
        "shared_prefix_attention_fused_flat", "shared_prefix_attention_"
        "fused_flat_int8", "shared_prefix_attention_fused_t",
        "shared_prefix_attention_fused_int8")}
    want.update({flat: 2 * 16, slot_minor: 2 * 3})
    if any(launches[name] != n for name, n in want.items()):
        raise SystemExit(f"flat-decode stage launched {launches}, expected "
                         f"{want}")


def check_train_reference(torch, device="cuda", bf16=False):
    """Phase 4b: one float32 ``make_train_step`` step of a small windowed
    cascade (in_dim 128 in 16 heads of dim 8, as on the main path; K 32
    codebooks over 4x16x16 latents, window 32) on the card (kernels, the
    step captured as a CUDA graph and replayed) and on the CPU (plain,
    eager) from the same weights, batch and window starts.  SGD(lr=1), so
    old minus new parameters are the gradients.  Tokens equal, loss within
    relative 1e-5, gradients within atol 1e-4 (float32 sums in another
    order through four layers).  On the card each layer's self-attention
    gradient is one launch of the backward kernel (its float32 form).
    With ``bf16`` the step runs ``bf16=True`` on both (kernel A's bf16
    forward and the backward's tensor-core form on the card, which round p
    and ds to bf16 where the plain products keep float32), held at the
    bf16 tolerances of ``tests/test_torch_port_train.py``: loss within
    relative 1e-3, gradients within 3e-2 of the CPU's largest."""
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.models.core import init_parameters
    from qaig_tpu_torch.ops import flash_attention as fa
    from qaig_tpu_torch.models.transformer import (Transformer,
                                                   TransformerConfig)
    from qaig_tpu_torch.train import transformer as train

    k, window = 32, 32
    cfg = TransformerConfig(
        use_encoder=True, use_pos_cond=True, num_enc_layers=2,
        num_dec_layers=2, num_enc_embedding=k, num_dec_embedding=k + 1,
        self_attn_heads=16, cross_attn_heads=16, in_dim=128, out_dim=k + 1,
        hidden_dim=256)
    cpu_gen = torch.Generator().manual_seed(5)
    weights = init_parameters(Transformer(cfg), cpu_gen).state_dict()
    batch = torch.randn(4, 4, 16, 16, generator=cpu_gen)
    books = [Codebook(patch_dim=patch, image_dim=(16, 16), image_channel=4,
                      num_embeddings=k).init(cpu_gen).state_dict()
             for patch in ((4, 4), (2, 2))]
    out = {}
    for device in ("cpu", device):
        model = Transformer(cfg, device=device)
        model.load_state_dict(weights)
        lr_cb, hr_cb = (Codebook(patch_dim=patch, image_dim=(16, 16),
                                 image_channel=4, num_embeddings=k,
                                 device=device).requires_grad_(False)
                        for patch in ((4, 4), (2, 2)))
        lr_cb.load_state_dict(books[0])
        hr_cb.load_state_dict(books[1])
        x = batch.to(device)
        starts = train.draw_window_starts(
            torch.Generator().manual_seed(6), x.shape[0],
            train.sequence_length(x, lr_cb, hr_cb, False), window)
        tokens = train.tokenize_batch(x, starts.to(device), lr_cb, hr_cb,
                                      False, k, k, window)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = train.make_train_step(
            model, torch.optim.SGD(model.parameters(), lr=1.0), lr_cb,
            hr_cb, False, k, k, window, bf16=bf16)
        if (step.runner is not None) != (device != "cpu"):
            raise SystemExit(f"the train step on {device} is not graphed "
                             f"on the card and eager on the CPU")
        backward = fa.fused_flash_attention_backward.launches
        loss = float(step(x, torch.Generator().manual_seed(6)))
        backward = fa.fused_flash_attention_backward.launches - backward
        grads = {n: (before[n] - p.detach()).cpu()
                 for n, p in model.named_parameters()}
        out[device] = ([t.cpu() for t in tokens], loss, grads)
    cpu, card = out["cpu"], out[device]
    same_tokens = all(torch.equal(a, b) for a, b in zip(cpu[0], card[0]))
    loss_rel = abs(card[1] - cpu[1]) / abs(cpu[1])
    grad_err = max((card[2][n] - g).abs().max().item()
                   for n, g in cpu[2].items())
    grad_max = max(g.abs().max().item() for g in cpu[2].values())
    kind = "bf16" if bf16 else "float32"
    loss_tol, grad_tol = (1e-3, 3e-2 * grad_max) if bf16 else (1e-5, 1e-4)
    log(f"[reference] train step, small windowed cascade, {kind} (one "
        f"graphed step on the card, eager on the CPU): tokens "
        f"{'equal' if same_tokens else 'DIFFER'}; loss card {card[1]:.7f} "
        f"cpu {cpu[1]:.7f} (rel {loss_rel:.2e}, tolerance {loss_tol:.0e}); "
        f"max |grad card - grad cpu| {grad_err:.3e} (tolerance "
        f"{grad_tol:.3e}; largest CPU gradient {grad_max:.3e}); backward "
        f"kernel launches {backward}")
    layers = cfg.num_enc_layers + cfg.num_dec_layers
    if device != "cpu" and backward != layers:
        raise SystemExit(f"the card's train step launched the backward "
                         f"kernel {backward} times, expected {layers}")
    if not same_tokens:
        raise SystemExit("card and CPU train steps tokenize differently")
    if not loss_rel <= loss_tol:
        raise SystemExit(f"card and CPU {kind} losses differ: rel "
                         f"{loss_rel}")
    if not grad_err <= grad_tol:
        raise SystemExit(f"card and CPU {kind} gradients differ: "
                         f"{grad_err}")
    return {"loss_rel": loss_rel, "grad_max_abs_err": grad_err,
            "grad_max": grad_max}


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


def write_full_cascade(torch, root, seed, device="cuda", layers=None):
    """Seeded random weights of ``bench.py --scale full``'s cascade,
    written as ``qaig_tpu``-schema checkpoints with the port's writer;
    ``layers``: (encoder, decoder) layers in place of FULL's (the depth cut
    of phases 7, 11 (c) and 12: ``SHALLOW``).  Returns (config path,
    decoder path, stage-2 checkpoint path)."""
    from qaig_tpu_torch.convert import to_jax_state
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.models.conv_nets import ConvNetConfig, FCDecoder
    from qaig_tpu_torch.models.core import init_parameters
    from qaig_tpu_torch.models.transformer import (Transformer,
                                                   TransformerConfig)
    from qaig_tpu_torch.utils.checkpoint import save_model

    f = dict(FULL)
    if layers is not None:
        f["enc_layers"], f["dec_layers"] = layers
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


def _counted():
    from qaig_tpu_torch.infer.graphs import launch_counters
    return launch_counters()


def reset_launches():
    for _, fn, attr in _counted():
        setattr(fn, attr, 0)


def read_launches():
    return {name: getattr(fn, attr) for name, fn, attr in _counted()}


def run_main_path(torch, workdir, paths, seed=0, num_images=8,
                  device="cuda", profile=False):
    """The cascade of ``paths`` (``write_full_cascade``) through
    ``generate.run`` (bf16, the dispatched loop: ``fused`` False), then one
    stage-2 rollout with an int8 prefix (and, with ``profile``, a profiled
    stage-2 window).  Returns (launches, timings, the dispatched run's
    tokens, saved grids and launches for ``run_fused_path``)."""
    import numpy as np
    from qaig_tpu_torch.infer import generate
    from qaig_tpu_torch.infer.decode import DecodeEngine, SamplerSettings

    config_path, decoder_path, stage2_path = paths
    saved = {}
    save_images = generate.save_images
    stage_fn = generate.generate_stage_tokens
    stage_s = []

    def recording_save(images, name, dest, **kw):
        saved[name] = images
        return save_images(images, name, dest, **kw)

    def timed_stage(*a, **kw):
        synchronize(torch, device)
        t0 = time.perf_counter()
        out = stage_fn(*a, **kw)
        synchronize(torch, device)
        stage_s.append(time.perf_counter() - t0)
        return out

    generate.save_images = recording_save
    generate.generate_stage_tokens = timed_stage
    try:
        synchronize(torch, device)
        reset_launches()
        t0 = time.perf_counter()
        tokens = generate.run({
            "device": device, "config_path": str(config_path),
            "decoder_path": str(decoder_path), "num_images": num_images,
            "seed": seed, "bf16": True, "fused": False,
            "out_dir": str(Path(workdir) / "out")})
        synchronize(torch, device)
        run_s = time.perf_counter() - t0
        launches = read_launches()
        reference = {"tokens": tokens.cpu(), "saved": dict(saved),
                     "launches": dict(launches), "run_s": run_s}
    finally:
        generate.save_images = save_images
        generate.generate_stage_tokens = stage_fn
    k = FULL["k"]
    out_seq = seq_len(FULL["patches"][-1])
    cond_seq = seq_len(FULL["patches"][-2])
    side = FULL["image_dim"][0] * 4   # the decoder's two 2x upsamples
    tokens = tokens.cpu()
    log(f"[main] generate.run: {num_images} images in {run_s:.3f} s "
        f"(stage rollouts {[round(x, 3) for x in stage_s]} s); launches "
        f"{launches}")
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
    timings = {"run_s": run_s, "stage_s": stage_s, "int8_stage2_s": int8_s}
    if profile:
        timings["profile"] = profile_window(
            torch, DecodeEngine(model), init, x_enc, gen,
            SamplerSettings(end_token=k, pos_offset=1), num_beam, beam_width,
            FULL["sliding"][2])
    return launches, timings, reference


def profile_window(torch, engine, init, x_enc, gen, settings, num_beam,
                   beam_width, window, tokens=64):
    """Device busy share of a stage-2 window (the first ``tokens`` tokens:
    cached rollout segments, bf16) from ``torch.profiler``: the summed
    time of the kernels the device ran over the wall time of the window,
    and the kernels that took most of it.  The profiler's own host cost
    lengthens the window, so the busy share is a lower bound."""
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
    kernels = device_kernels(prof)
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
# phase 5f: the same cascade fused (one CUDA graph, captured then replayed)
# ---------------------------------------------------------------------------

def check_categorical(torch, device="cuda"):
    """The capturable draw of batch-keyed sampling (``decode._categorical``:
    argmax(p / E), E ~ Exp(1)) against ``torch.multinomial(p, 1)`` from the
    same generator state on the card: equal tokens, equal state after."""
    from qaig_tpu_torch.infer.decode import _categorical
    gen = torch.Generator(device=device).manual_seed(3)
    for rows in (8, 64, 256):
        logits = torch.randn(rows, FULL["k"] + 1, generator=gen,
                             device=device)
        for seed in (0, 7):
            g1 = torch.Generator(device=device).manual_seed(seed)
            g2 = torch.Generator(device=device).manual_seed(seed)
            want = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                     generator=g1)[:, 0]
            if not torch.equal(_categorical(logits, g2), want) or \
                    not torch.equal(g1.get_state(), g2.get_state()):
                raise SystemExit(f"_categorical draws other tokens than "
                                 f"torch.multinomial at {rows} rows")
    log(f"[fused] _categorical == torch.multinomial(p, 1) on the card at "
        f"8/64/256 x {FULL['k'] + 1}, seeds 0 and 7")


def trace_kernels(trace_path):
    """Kernel events of a ``torch.profiler`` Chrome trace: launches by
    kernel, and the device busy share over the span from the first kernel's
    start to the last one's end."""
    events = [e for e in json.loads(Path(trace_path).read_text())
              ["traceEvents"] if e.get("cat") == "kernel"]
    if not events:
        raise SystemExit(f"{trace_path}: no kernel events")
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    busy = sum(e["dur"] for e in events)
    return {"kernels": len(events),
            "flash_attention": sum("flash_attention_fwd" in e["name"]
                                   for e in events),
            "shared_prefix_attention_fused_t": sum(
                "prefix_split_kernel" in e["name"] for e in events),
            "span_ms": (end - start) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (end - start)}


def failed_capture(torch, device="cuda"):
    """A capture that reads a device value on the host must raise, count
    nothing and keep no graph; the runner captures afterwards."""
    from qaig_tpu_torch.infer.graphs import GraphRunner, read_counts
    runner = GraphRunner(device)
    x = torch.ones(4, device=device)
    before = read_counts()
    try:
        runner("bad", lambda t: t * float(t.sum()), inputs=(x,))
    except Exception as e:   # PyTorch raises its own capture error types
        error = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    else:
        raise SystemExit("a capture that syncs with the host did not raise")
    if runner.graphs or read_counts() != before:
        raise SystemExit("a failed capture kept a graph or counted launches")
    if not torch.equal(runner("good", lambda t: (t * 2,), inputs=(x,))[0],
                       x * 2):
        raise SystemExit("the runner does not capture after a failure")
    log(f"[fused] a capture that reads a device value raised ({error}); no "
        f"graph kept, no launch counted, the next capture replays")


def run_generate_cli(torch, workdir, paths, seed, num_images):
    """``python -m qaig_tpu_torch.cli.generate_images --bf16`` in a new
    process: the fused path by default, so its capture runs where no
    library or kernel was used before.  Returns its seconds, its cascade
    line and its output directory."""
    config_path, decoder_path, _ = paths
    out = Path(workdir) / "cli_out"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "qaig_tpu_torch.cli.generate_images",
         "--bf16", "--config-path", str(config_path), "--decoder-path",
         str(decoder_path), "--num-images", str(num_images), "--seed",
         str(seed), "--out-dir", str(out)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or \
            "Fused single-dispatch cascade: 3 stages" not in lines:
        raise SystemExit(f"generate_images CLI failed ({proc.returncode}):"
                         f"\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    line = next(ln for ln in lines if ln.startswith("Cascade:"))
    return {"seconds": seconds, "line": line, "out": out}


def run_fused_path(torch, workdir, paths, reference, seed=0, num_images=8,
                   device="cuda"):
    """Phase 5f: ``generate.run`` fused (the whole cascade from one CUDA
    graph) on phase 5's checkpoints, with one cache: cold at phase 5's seed
    (load, capture, instantiation, replay), warm at another seed, warm at
    phase 5's seed again, the dispatched loop at the other seed, and a warm
    replay under ``--profile-dir``.  Tokens, saved grids and launches are
    held to the dispatched runs' at the same seed, the two seeds must
    differ, one graph must serve every call, and the trace's kernels must
    equal the replay's counts.  Returns (a warm replay's launches,
    timings, the cold run's tokens and saved grids)."""
    import numpy as np
    from qaig_tpu_torch.infer import generate

    check_categorical(torch, device)
    config_path, decoder_path, _ = paths
    saved, load_s = {}, []
    save_images, load_stage = generate.save_images, generate._load_stage

    def recording_save(images, name, dest, **kw):
        saved[name] = images
        return save_images(images, name, dest, **kw)

    def timed_load(*a, **kw):
        t0 = time.perf_counter()
        out = load_stage(*a, **kw)
        load_s.append(time.perf_counter() - t0)
        return out

    def run(run_seed, fused, cache=None, **extra):
        saved.clear()
        synchronize(torch, device)
        reset_launches()
        t0 = time.perf_counter()
        tokens = generate.run(dict(
            device=device, config_path=str(config_path),
            decoder_path=str(decoder_path), num_images=num_images,
            seed=run_seed, bf16=True, fused=fused,
            out_dir=str(Path(workdir) / "fused_out"), **extra), cache=cache)
        synchronize(torch, device)
        seconds = time.perf_counter() - t0
        return tokens.cpu(), dict(saved), read_launches(), seconds

    failed_capture(torch, device)
    cli = run_generate_cli(torch, workdir, paths, seed, num_images)
    generate.save_images, generate._load_stage = recording_save, timed_load
    cache = {}
    try:
        cold = run(seed, True, cache)
        cold_load_s = sum(load_s)
        other = run(seed + 1, True, cache)
        warm = run(seed, True, cache)
        dispatched_other = run(seed + 1, False)
        traced = run(seed, True, cache,
                     profile_dir=str(Path(workdir) / "fused_trace"))
    finally:
        generate.save_images, generate._load_stage = save_images, load_stage
    runner = cache["runner"]
    if list(runner.graphs) != [num_images]:
        raise SystemExit(f"expected one graph, got keys {list(runner.graphs)}")
    graph = runner.graphs[num_images]
    for name, result in (("cold", cold), ("warm", warm), ("traced", traced)):
        if not torch.equal(result[0], reference["tokens"]):
            raise SystemExit(f"fused {name} tokens differ from the "
                             f"dispatched loop's at seed {seed}")
        for count, want in reference["launches"].items():
            if result[2][count] != want:
                raise SystemExit(f"fused {name} run counted {count} "
                                 f"{result[2][count]}, dispatched {want}")
    if not torch.equal(other[0], dispatched_other[0]):
        raise SystemExit(f"fused tokens differ from the dispatched loop's at "
                         f"seed {seed + 1}")
    if torch.equal(other[0], cold[0]):
        raise SystemExit("seeds 0 and 1 replayed the same tokens")
    grid_err = max(float(np.abs(cold[1][name] - images).max())
                   for name, images in reference["saved"].items())
    if set(cold[1]) != set(reference["saved"]) or grid_err > ATOL:
        raise SystemExit(f"fused grids differ from the dispatched ones "
                         f"({sorted(cold[1])}, max abs err {grid_err})")
    for name in ("flash_attention", "shared_prefix_attention_fused_t"):
        if warm[2][name] <= 0:
            raise SystemExit(f"the fused replay never launched {name}")
    trace = trace_kernels(Path(workdir) / "fused_trace" / "trace_0.json")
    for name in ("flash_attention", "shared_prefix_attention_fused_t"):
        if trace[name] != warm[2][name]:
            raise SystemExit(f"the replay's trace holds {trace[name]} "
                             f"{name} kernels, its count {warm[2][name]}")
    for grid in ("recon_model_Cond", "recon_model_2"):
        mine = (Path(workdir) / "fused_out" / "images" / f"{grid}.jpg")
        if mine.read_bytes() != (cli["out"] / "images"
                                 / f"{grid}.jpg").read_bytes():
            raise SystemExit(f"the CLI's {grid}.jpg differs from the fused "
                             f"run's at seed {seed}")
    replay_s = (cold[3] - cold_load_s - graph.capture_s
                - graph.instantiate_s)
    timings = {"dispatched_s": reference["run_s"], "cold_s": cold[3],
               "cold_load_s": cold_load_s, "capture_s": graph.capture_s,
               "instantiate_s": graph.instantiate_s,
               "cold_replay_rest_s": replay_s,
               "warm_s": [other[3], warm[3]],
               "dispatched_other_s": dispatched_other[3],
               "cli_process_s": cli["seconds"], "cli_cascade": cli["line"],
               "grid_max_abs_err": grid_err, "trace": trace}
    log(f"[fused] generate.run {num_images} images: dispatched "
        f"{reference['run_s']:.3f} s / {dispatched_other[3]:.3f} s; fused "
        f"cold {cold[3]:.3f} s (load {cold_load_s:.3f}, capture "
        f"{graph.capture_s:.3f}, instantiation {graph.instantiate_s:.3f}, "
        f"replay and the rest {replay_s:.3f}); warm {other[3]:.3f} s (seed "
        f"{seed + 1}), {warm[3]:.3f} s (seed {seed}); tokens equal the "
        f"dispatched loop's at both seeds, grids max abs err {grid_err}")
    log(f"[fused] the CLI in a new process (fused by default, cold): "
        f"{cli['seconds']:.3f} s with start and load; {cli['line']}; its "
        f"grids equal the fused run's at seed {seed}")
    log(f"[fused] replay launches {warm[2]}; traced replay: "
        f"{trace['kernels']} kernels, {trace['flash_attention']} "
        f"flash_attention_fwd, {trace['shared_prefix_attention_fused_t']} "
        f"prefix_split_kernel; device busy {trace['busy_ms']:.1f} ms of a "
        f"{trace['span_ms']:.1f} ms span ({100 * trace['busy_share']:.1f}%)")
    return warm[2], timings, {"tokens": cold[0], "saved": cold[1]}


# ---------------------------------------------------------------------------
# phase 10: the reference's torch checkpoints (export, generate, resume)
# ---------------------------------------------------------------------------

def export_checkpoints(sources, out_dir, timeout=600):
    """``python -m qaig_tpu_torch.cli.export_torch`` on each of ``sources``
    (pickle checkpoints), one new process each, all at once; returns
    ({source: its ``.pt`` archive in ``out_dir``}, seconds)."""
    import os
    repo = Path(__file__).resolve().parent
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for source in sources:
        dest = out_dir / f"ref_{Path(source).name}"
        procs[source] = (dest, subprocess.Popen(
            [sys.executable, "-m", "qaig_tpu_torch.cli.export_torch",
             "--model-path", str(source), "--out-path", str(dest)],
            cwd=repo, env=dict(os.environ), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for source, (dest, proc) in procs.items():
        try:
            output, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            output, _ = proc.communicate()
        if proc.returncode != 0 or not dest.is_file() \
                or dest.read_bytes()[:2] != b"PK":
            failed.append(f"{source} (exit {proc.returncode}):\n"
                          f"{output[-2000:]}")
    if failed:
        raise SystemExit("export_torch failed: " + "\n".join(failed))
    return ({source: dest for source, (dest, _) in procs.items()},
            time.perf_counter() - t0)


def run_interchange_path(torch, workdir, paths, fused_ref, seed=0,
                         num_images=8, device="cuda"):
    """Phase 10.  (a) Phase 5's checkpoints (the decoder, the four
    codebooks, the three stages) and phase 6's bf16 ``model_3.pt`` (with
    its optax Adam state) exported to the reference's torch format by the
    export CLI, in new processes.  (b) ``generate.run`` fused, bf16, from
    the ``.pt`` archives at phase 5f's seed: tokens and grids bit-equal to
    phase 5f's from the pickles (the same float32 weights).  (c) two
    graphed bf16 train steps resumed from the exported ``model_3.pt``, its
    reference Adam state and the exported codebooks and decoder, with
    ``lr_step`` 2: the Adam step count and learning rate before the first
    step are the ones the state's step implies (4 updates: ``1e-4 *
    0.5``), and two updates later 6 and ``1e-4 * 0.25``.  Returns
    (launches of (b), timings)."""
    import numpy as np
    from qaig_tpu_torch.infer import generate
    from qaig_tpu_torch.train import optim
    from qaig_tpu_torch.train import transformer as train
    from qaig_tpu_torch.utils.checkpoint import load_model

    config_path, decoder_path, _ = paths
    config = json.loads(Path(config_path).read_text())
    keys = ("model_path", "lr_codebook_path", "hr_codebook_path")
    trained = Path(workdir) / "train" / "out" / "models_checkpoint" / \
        f"model_{TRAIN['checkpoint_step']}.pt"
    sources = sorted({str(decoder_path), str(trained), *(
        stage[key] for stage in config.values() for key in keys)})
    exported, export_s = export_checkpoints(sources,
                                            Path(workdir) / "reference")
    for stage in config.values():
        for key in keys:
            stage[key] = str(exported[stage[key]])
    ref_config = Path(workdir) / "reference" / "generate.json"
    ref_config.write_text(json.dumps(config, indent=1))
    log(f"[interchange] {len(sources)} checkpoints exported to torch .pt "
        f"archives by python -m qaig_tpu_torch.cli.export_torch, one new "
        f"process each, in parallel: {export_s:.1f} s")

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
        tokens = generate.run(dict(
            device=device, config_path=str(ref_config),
            decoder_path=str(exported[str(decoder_path)]),
            num_images=num_images, seed=seed, bf16=True, fused=True,
            out_dir=str(Path(workdir) / "reference_out")), cache={})
        synchronize(torch, device)
        generate_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        generate.save_images = save_images
    if not torch.equal(tokens.cpu(), fused_ref["tokens"]):
        raise SystemExit("tokens from the .pt archives differ from phase "
                         "5f's from the pickles")
    if set(saved) != set(fused_ref["saved"]) or not all(
            np.array_equal(saved[k], fused_ref["saved"][k]) for k in saved):
        raise SystemExit("grids from the .pt archives differ from phase "
                         "5f's from the pickles")
    log(f"[interchange] generate.run fused from the .pt archives (seed "
        f"{seed}, {num_images} images, cold) in {generate_s:.3f} s: tokens "
        f"and grids {sorted(saved)} bit-equal to phase 5f's from the "
        f"pickles; launches {launches}")

    ok, ckpt = load_model(exported[str(trained)])
    state = ckpt["model_optimizer"] if ok else None
    if not isinstance(state, dict) or "param_groups" not in state:
        raise SystemExit("the exported model_3.pt carries no torch Adam "
                         "state")
    implied = int(max(float(e["step"]) for e in state["state"].values()))
    base_lr, lr_step, steps = 1e-4, 2, 2
    factor = optim.halving_factor(lr_step)
    seen, made = [], []
    make_train_step = train.make_train_step

    def observed_make_train_step(model, optimizer, *a, **kw):
        step = make_train_step(model, optimizer, *a, **kw)
        made.append((step, optimizer))

        def observed(*args):
            seen.append(_adam_position(optimizer))
            return step(*args)
        observed.runner = step.runner
        return observed

    train.make_train_step = observed_make_train_step
    out_dir = Path(workdir) / "resume"
    try:
        synchronize(torch, device)
        t0 = time.perf_counter()
        train.run({
            "device": device, "dataset_path": str(
                Path(workdir) / "train" / "fmaps" / "all_dataset.json"),
            "decoder_path": str(exported[str(decoder_path)]),
            "lr_codebook_path": config["2"]["lr_codebook_path"],
            "hr_codebook_path": config["2"]["hr_codebook_path"],
            "config_path": str(Path(__file__).resolve().parent
                               / TRAIN["config"]),
            "out_dir": str(out_dir), "bf16": True,
            "batch_size": TRAIN["batch"], "max_steps": steps,
            "checkpoint_step": 1000, "skip_preview": True, "seed": seed,
            "model_path": str(exported[str(trained)]), "load_optim": True,
            "lr_step": lr_step})
        synchronize(torch, device)
        resume_s = time.perf_counter() - t0
    finally:
        train.make_train_step = make_train_step
    if len(made) != 1 or made[0][0].runner is None:
        raise SystemExit("the resumed run did not train graphed")
    after = _adam_position(made[0][1])
    # the learning rate is a float32 tensor on the card
    want = [(implied, base_lr * factor(implied)),
            (implied + steps, base_lr * factor(implied + steps))]
    got = [seen[0], after]
    if implied != 4 or any(g[0] != {w[0]} or np.float32(g[1])
                           != np.float32(w[1]) for g, w in zip(got, want)):
        raise SystemExit(f"resumed from a reference Adam state at step "
                         f"{implied}: (Adam steps, lr) {got}, expected "
                         f"{want}")
    losses = [json.loads(line)["ce_loss"] for line in
               (out_dir / "metrics.jsonl").read_text().splitlines()]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise SystemExit(f"resumed losses not all finite: {losses}")
    log(f"[interchange] train.run resumed from the exported model_3.pt "
        f"(reference Adam state, step {implied}), {steps} graphed bf16 "
        f"steps in {resume_s:.3f} s: Adam steps and lr before "
        f"{sorted(got[0][0])} / {got[0][1]:.3e}, after {sorted(got[1][0])} "
        f"/ {got[1][1]:.3e}, as the state implies at lr_step {lr_step}; "
        f"losses {[round(x, 4) for x in losses]}")
    return launches, {"export_s": export_s, "generate_s": generate_s,
                      "resume_s": resume_s, "implied_step": implied,
                      "adam_before": [sorted(got[0][0]), got[0][1]],
                      "adam_after": [sorted(got[1][0]), got[1][1]],
                      "resumed_losses": losses}


def _adam_position(optimizer):
    """({the Adam step counts of its parameters}, the first group's
    learning rate)."""
    return ({int(float(s["step"])) for s in optimizer.state.values()},
            float(optimizer.param_groups[0]["lr"]))


# ---------------------------------------------------------------------------
# phase 5b: the flat-decode cascade (bench.py --flat-decode [--int8-kv])
# ---------------------------------------------------------------------------

def expected_decode_launches(flat, dec_layers=FULL["dec_layers"]):
    """Decode-kernel launches of the cascade, from FULL and the engine's
    control flow: per stage, cached rollout segments of ``beam_width``
    steps, then (with a window) one crossing segment whose cached part has
    the steps left before the window fills; every cached step runs each
    decoder layer once.  A segment goes to the flat kernel when
    ``flat_decode`` is on and its heads x rollouts are at most 64 and its
    width a positive multiple of 8 (``qaig_tpu/ops/decode_attention.py::
    flat_segment_supported``), else to the slot-minor kernel.  Returns
    {stage: {"flat": n, "slot_minor": n}}."""
    out = {}
    for i in range(3):
        num_beam, bw = FULL["beams"][i]
        total, window = seq_len(FULL["patches"][i + 1]), FULL["sliding"].get(i)
        counts = {"flat": 0, "slot_minor": 0}
        gen, cached = 0, True
        while gen < total:
            left = total if window is None else max(0, window - 1 - gen)
            steps = 0
            if cached:
                steps = bw if bw <= left else left
                cached = bw <= left
            if steps:
                route = ("flat" if flat and FULL["heads"] * num_beam <= 64
                         and steps % 8 == 0 else "slot_minor")
                counts[route] += dec_layers * steps
            gen += bw
        out[i] = counts
    return out


def run_flat_path(torch, paths, seed=0, num_images=8, device="cuda"):
    """Phase 5's checkpoints, loaded once in bf16, run stage by stage in
    ``bench.py``'s order through ``DecodeEngine(flat_decode=...)``: the
    slot-minor engine and the flat one in turns (slot-minor, flat, flat,
    slot-minor; the first flat cascade is the counted path), then one
    stage-2 rollout with ``quantized_prefix=True, flat_decode=True``.
    Returns (launches, timings)."""
    import numpy as np
    from qaig_tpu_torch.infer import generate
    from qaig_tpu_torch.infer.decode import DecodeEngine, SamplerSettings
    from qaig_tpu_torch.train import common
    from qaig_tpu_torch.utils.checkpoint import load_model

    config_path, decoder_path, _ = paths
    config = json.loads(Path(config_path).read_text())
    dev = torch.device(device)

    def cast(module):
        return common.cast_floats(module, torch.bfloat16)

    stages = [generate._load_stage(i, config[i], cast, dev)
              for i in sorted(config, key=int)]
    ok, dec_ckpt = load_model(decoder_path)
    assert ok
    decoder = cast(common.decoder_from_checkpoint(dec_ckpt, dev)[0])
    k = FULL["k"]

    def settings(st):
        return SamplerSettings(temperature=1.0, end_token=k, end_mode="mask",
                               index_shift=k if st["is_base"] else 0)

    @torch.inference_mode()
    def cascade(engine_kw):
        gen = torch.Generator(device=device).manual_seed(seed)
        tokens = torch.randint(0, k, (num_images, 1), generator=gen,
                               device=device)
        per_stage, seconds = [], []
        for st in stages:
            init = tokens if st["is_base"] else torch.full(
                (num_images, 1), k, dtype=torch.long, device=device)
            synchronize(torch, device)
            t0 = time.perf_counter()
            out = DecodeEngine(st["model"], **engine_kw).rollout_generate(
                init, st["total_seq"], gen, settings(st),
                num_beam=st["stage_cfg"]["num_beam"],
                beam_width=st["stage_cfg"]["beam_width"],
                x_enc=None if st["is_base"] else tokens,
                sliding_window=st["sliding_window"])
            synchronize(torch, device)
            seconds.append(time.perf_counter() - t0)
            tokens = out - settings(st).index_shift
            per_stage.append(tokens)
        return per_stage, seconds

    runs = {"slot_minor": [], "flat": []}
    launches = None
    for kind in ("slot_minor", "flat", "flat", "slot_minor"):
        counted = kind == "flat" and launches is None
        if counted:
            synchronize(torch, device)
            reset_launches()
        per_stage, seconds = cascade({"flat_decode": kind == "flat"})
        if counted:
            launches = read_launches()
            flat_tokens = per_stage
        runs[kind].append(seconds)
    log(f"[flat] bf16 cascade, {num_images} images, stage rollout seconds "
        f"in turns: slot-minor {[round(x, 3) for x in runs['slot_minor'][0]]}"
        f", flat {[round(x, 3) for x in runs['flat'][0]]}, flat "
        f"{[round(x, 3) for x in runs['flat'][1]]}, slot-minor "
        f"{[round(x, 3) for x in runs['slot_minor'][1]]}; launches "
        f"{launches}")

    with torch.inference_mode():
        pixels = decoder(stages[-1]["hr_codebook"].get_quantized_image(
            flat_tokens[-1])).float().cpu().numpy()
    side = FULL["image_dim"][0] * 4
    final = flat_tokens[-1]
    if final.shape != (num_images, seq_len(FULL["patches"][-1])) or \
            int(final.min()) < 0 or int(final.max()) >= k:
        raise SystemExit("flat-decode cascade gave invalid tokens")
    if pixels.shape != (num_images, 3, side, side) or \
            not np.isfinite(pixels).all():
        raise SystemExit("flat-decode cascade gave bad pixels")

    st = stages[-1]
    synchronize(torch, device)
    reset_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = DecodeEngine(st["model"], quantized_prefix=True,
                           flat_decode=True).rollout_generate(
            torch.full((num_images, 1), k, dtype=torch.long, device=device),
            st["total_seq"], torch.Generator(device=device).manual_seed(seed),
            settings(st), num_beam=st["stage_cfg"]["num_beam"],
            beam_width=st["stage_cfg"]["beam_width"], x_enc=flat_tokens[1],
            sliding_window=st["sliding_window"])
    synchronize(torch, device)
    int8_s = time.perf_counter() - t0
    int8_launches = read_launches()
    log(f"[flat] stage-2 rollout, int8 prefix + flat: {int8_s:.3f} s; "
        f"launches {int8_launches}")
    if int(out.min()) < 0 or int(out.max()) >= k:
        raise SystemExit("int8 flat-decode rollout gave invalid tokens")

    want = expected_decode_launches(flat=True)
    expect = {
        "shared_prefix_attention_fused_flat":
            (launches, sum(c["flat"] for c in want.values())),
        "shared_prefix_attention_fused_t":
            (launches, sum(c["slot_minor"] for c in want.values())),
        "shared_prefix_attention_fused_flat_int8": (int8_launches,
                                                    want[2]["flat"]),
        "shared_prefix_attention_fused_int8": (int8_launches,
                                               want[2]["slot_minor"])}
    for name, (counts, n) in expect.items():
        if counts[name] != n:
            raise SystemExit(f"the flat-decode path launched {name} "
                             f"{counts[name]} times, expected {n}")
    for counts, absent in ((launches, ("shared_prefix_attention_fused_int8",
                                       "shared_prefix_attention_fused_flat_"
                                       "int8")),
                           (int8_launches, ("shared_prefix_attention_fused_t",
                                            "shared_prefix_attention_fused_"
                                            "flat"))):
        for name in absent:
            if counts[name]:
                raise SystemExit(f"{name} launched on the wrong run")
    log(f"[flat] launch counts as derived from the config: "
        f"{ {name: n for name, (_, n) in expect.items()} }; tokens in "
        f"[0, {k}), pixels finite, {side}x{side}x3")
    total = {name: launches[name] + int8_launches[name] for name in launches}
    return total, {"stage_s": runs, "int8_stage2_s": int8_s}


# ---------------------------------------------------------------------------
# phase 7: serving (CascadePipeline, then the HTTP server's CLI)
# ---------------------------------------------------------------------------

def decode_png(data):
    """(H, W, C) uint8 pixels of an 8-bit PNG with filter 0 on every row
    (what the port's server writes), read with the standard library."""
    import struct
    import zlib
    import numpy as np
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise SystemExit("not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
    width, height, depth, color = header[:4]
    channels = {0: 1, 2: 3}[color]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        height, 1 + width * channels)
    if depth != 8 or rows[:, 0].any():
        raise SystemExit("unexpected PNG depth or row filter")
    return rows[:, 1:].reshape(height, width, channels)


def run_serve_path(torch, paths, device="cuda"):
    """Phase 7.  (a) The library-level ``CascadePipeline``, float32: the 3
    rows of ``generate(3, seed=7)`` equal the same rows inside a coalesced
    8-row ``row_keys`` batch (another request's 2 rows and 3 padding rows,
    keyed as the server keys them); the counted path.  The bf16 share of
    equal tokens is reported, not asserted.  (b) ``python -m
    qaig_tpu_torch.cli.serve_generation --bf16`` as a subprocess: /healthz,
    four concurrent /generate requests, /metrics, one warm 1-image
    request, a PNG, SIGTERM.  Returns (launches, timings)."""
    import base64
    import os
    import signal
    import threading
    import urllib.error
    import urllib.request
    import numpy as np
    from qaig_tpu_torch.infer.pipeline import (CascadePipeline,
                                               derive_row_keys)

    config_path, decoder_path, _ = paths
    config = json.loads(Path(config_path).read_text())
    merged_keys = torch.cat([derive_row_keys(7, 3), derive_row_keys(11, 2),
                             derive_row_keys(0, 3, start=1 << 20)])
    equal = {}
    for kind, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        pipe = CascadePipeline.from_config(config, decoder_path,
                                           device=device, dtype=dtype)
        synchronize(torch, device)
        if kind == "f32":
            reset_launches()
        t0 = time.perf_counter()
        _, solo = pipe.generate(3, seed=7)
        _, merged = pipe.generate(8, row_keys=merged_keys)
        synchronize(torch, device)
        seconds = time.perf_counter() - t0
        if kind == "f32":
            launches = read_launches()
        equal[kind] = (solo.cpu() == merged[:3].cpu()).double().mean().item()
        log(f"[serve] CascadePipeline {kind}: generate(3, seed=7) and the "
            f"same rows in a coalesced 8-row batch: {100 * equal[kind]:.2f}% "
            f"of tokens equal ({seconds:.3f} s for both calls, fused: each "
            f"captures its graph)")
        _, dispatched = pipe.generate(3, seed=7, fused=False)
        if not torch.equal(solo, dispatched):
            raise SystemExit(f"CascadePipeline {kind}: fused tokens differ "
                             f"from the dispatched loop's")
        if kind == "bf16":
            fused_timing = time_pipeline_request(torch, pipe, device)
        del pipe
    log(f"[serve] pipeline path launches (float32 calls): {launches}")
    if equal["f32"] != 1.0:
        raise SystemExit("float32 row-keyed generation is not "
                         "composition-invariant on the card")
    for name in ("flash_attention", "shared_prefix_attention_fused_t"):
        if launches[name] <= 0:
            raise SystemExit(f"the pipeline path never launched {name}")
    torch.cuda.empty_cache()

    repo = Path(__file__).resolve().parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "qaig_tpu_torch.cli.serve_generation",
         "--device", device, "--bf16", "--port", "0", "--warmup-batch", "1",
         "--max-batch", "8", "--config-path", str(config_path),
         "--decoder-path", str(decoder_path)],
        cwd=repo, env=dict(os.environ), text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    lines = []
    pump = threading.Thread(target=lambda: lines.extend(proc.stdout),
                            daemon=True)
    pump.start()

    def call(path, payload=None, timeout=600):
        """(status, JSON body) of one request; an HTTP error's status and
        body are returned too."""
        data = None if payload is None else json.dumps(payload).encode()
        try:
            with urllib.request.urlopen(urllib.request.Request(
                    base + path, data=data), timeout=timeout) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode(errors="replace")

    def server_fault(msg):
        return SystemExit(f"{msg}\nserver output:\n"
                          + "".join(lines)[-3000:])

    try:
        t0 = time.perf_counter()
        while not any("serving on http" in ln for ln in lines):
            if proc.poll() is not None:
                raise server_fault("the server exited early")
            if time.perf_counter() - t0 > 300:
                raise SystemExit("the server never came up")
            time.sleep(0.2)
        start_s = time.perf_counter() - t0
        serving = next(ln for ln in lines if "serving on http" in ln)
        base = f"http://127.0.0.1:{int(serving.rsplit(':', 1)[1])}"
        log(f"[serve] server up in {start_s:.1f} s (load, warm-up at batch "
            f"1): {serving.strip()}")
        if call("/healthz") != (200, {"status": "ok"}):
            raise server_fault("/healthz did not answer ok")

        sizes = (1, 2, 3, 2)
        results = {}

        def post(i):
            try:
                results[i] = call("/generate", {
                    "num_images": sizes[i], "seed": 1 + i,
                    "return_images": i == 1})
            except Exception as e:   # reported below, with the server's log
                results[i] = (None, repr(e))

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(sizes))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        burst_s = time.perf_counter() - t0
        k, out_seq = FULL["k"], seq_len(FULL["patches"][-1])
        for i, num in enumerate(sizes):
            status, out = results[i]
            if status != 200:
                raise server_fault(f"request {i} failed: {status} {out}")
            tokens = np.asarray(out["tokens"])
            if tokens.shape != (num, out_seq) or tokens.min() < 0 or \
                    tokens.max() >= k:
                raise SystemExit(f"request {i}: bad tokens {tokens.shape}")
        _, metrics = call("/metrics")
        if metrics["coalesced_dispatches_total"] < 1:
            raise SystemExit(f"no coalesced dispatch: {metrics}")
        t0 = time.perf_counter()
        status, out = call("/generate", {"num_images": 1, "seed": 9})
        warm_s = time.perf_counter() - t0
        if status != 200:
            raise server_fault(f"warm request failed: {status} {out}")
        pixels = decode_png(base64.b64decode(
            results[1][1]["images_png_b64"][0]))
        side = FULL["image_dim"][0] * 4
        if pixels.shape != (side, side, 3):
            raise SystemExit(f"bad PNG {pixels.shape}")
        by_batch = {size: e["seconds_total"] / e["count"]
                    for size, e in metrics["dispatches_by_batch"].items()}
        log(f"[serve] 4 concurrent requests (1, 2, 3, 2 images) in "
            f"{burst_s:.3f} s: {metrics['dispatches_total']} dispatches, "
            f"{metrics['coalesced_dispatches_total']} coalesced, "
            f"{metrics['padded_rows_total']} padded rows; seconds per "
            f"dispatch by padded batch size "
            f"{ {s: round(t, 4) for s, t in by_batch.items()} }; warm "
            f"1-image request {warm_s:.3f} s; PNG {side}x{side}x3")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        pump.join(timeout=10)
        if rc != 0 or not any("drained; bye." in ln for ln in lines):
            raise server_fault(f"the server did not drain cleanly (exit "
                               f"{rc})")
        log("[serve] SIGTERM: drained; bye., exit 0")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return launches, {"pipeline_equal_share": equal, "server_start_s":
                      start_s, "burst_s": burst_s, "warm_request_s": warm_s,
                      "dispatch_s_by_batch": by_batch, "metrics": metrics,
                      "pipeline_request": fused_timing}


def time_pipeline_request(torch, pipe, device, seed=9, turns=2):
    """A 1-image request as the server's batcher makes it
    (``pipe.generate(1, row_keys=...)``), bf16: the fused call's first call
    of the key (capture, instantiation, replay), then warm fused and
    dispatched calls in turns (fused, dispatched, dispatched, fused, ...),
    each to a synchronised end; fused and dispatched tokens must be
    equal."""
    from qaig_tpu_torch.infer.pipeline import derive_row_keys
    keys = derive_row_keys(seed, 1)

    def call(fused):
        synchronize(torch, device)
        t0 = time.perf_counter()
        _, tokens = pipe.generate(1, row_keys=keys, fused=fused)
        synchronize(torch, device)
        return time.perf_counter() - t0, tokens.cpu()

    cold_s, want = call(True)
    graph = pipe._graphs.graphs[(1, None)]
    times = {True: [], False: []}
    for turn in range(2 * turns):
        fused = turn % 4 in (0, 3)
        seconds, tokens = call(fused)
        if not torch.equal(tokens, want):
            kind = "fused" if fused else "dispatched"
            raise SystemExit(f"1-image request: {kind} tokens differ from "
                             f"the first fused call's")
        times[fused].append(seconds)
    out = {"cold_s": cold_s, "capture_s": graph.capture_s,
           "instantiate_s": graph.instantiate_s, "warm_fused_s": times[True],
           "dispatched_s": times[False]}
    log(f"[serve] 1-image request, bf16 CascadePipeline: fused first call "
        f"{cold_s:.3f} s (capture {graph.capture_s:.3f}, instantiation "
        f"{graph.instantiate_s:.3f}); warm fused "
        f"{[round(t, 4) for t in times[True]]} s, dispatched "
        f"{[round(t, 4) for t in times[False]]} s (in turns); tokens equal")
    return out


# ---------------------------------------------------------------------------
# phase 6: transformer training through the entry point
# ---------------------------------------------------------------------------

TRAIN = dict(latents=64, batch=8, steps=6, checkpoint_step=3, previews=4,
             config="examples/configs/transformer_cascade.json")
TRAINED = {}   # phase 6's runs by precision: losses, output, parameters


def run_train_path(torch, workdir, seed=0, device="cuda", profile=False,
                   bf16=True):
    """``train.transformer.run`` on the cascade example config over seeded
    random 4x32x32 latents, with phase 5's stage-2 codebooks (LR patch 4,
    HR patch 2) and FC decoder: bf16 (or, with ``bf16=False``, float32,
    the trainer's default), batch 8, 6 steps, checkpoints and previews at
    steps 0 and 3.  Returns (launches, timings)."""
    import numpy as np
    from qaig_tpu_torch.data.manifest import write_manifest
    from qaig_tpu_torch.infer.generate import transformer_from_checkpoint
    from qaig_tpu_torch.train import transformer as train
    from qaig_tpu_torch.utils.checkpoint import load_model

    t = TRAIN
    kind = "bf16" if bf16 else "float32"
    root = Path(workdir) / ("train" if bf16 else "train_f32")
    (root / "fmaps").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(t["latents"]):
        path = root / "fmaps" / f"{i}.npy"
        np.save(path, rng.standard_normal(
            (FULL["latent_c"],) + FULL["image_dim"]).astype(np.float32))
        rows.append({"fmap_path": str(path), "image_path": ""})
    manifest = write_manifest(root / "fmaps" / "all_dataset.json", rows)
    ckpt = Path(workdir) / "models_checkpoint"
    config = Path(__file__).resolve().parent / t["config"]

    # time each train step (synchronised) and, with ``profile``, trace
    # steps 2-5 one by one, so the checkpoint at step 3 stays out
    step_s, traces, made = [], [], []
    make_train_step = train.make_train_step

    def timed_make_train_step(*a, **kw):
        step = make_train_step(*a, **kw)
        made.append(step)

        def timed(*args):
            index = len(step_s)
            tracing = profile and 2 <= index <= 5
            if tracing:
                traces.append(start_trace(torch))
            synchronize(torch, device)
            t0 = time.perf_counter()
            loss = step(*args)
            synchronize(torch, device)
            step_s.append(time.perf_counter() - t0)
            if tracing:
                traces[-1] = stop_trace(traces[-1], step_s[-1])
            return loss
        return timed

    train.make_train_step = timed_make_train_step
    save_checkpoint, save_s = train.save_checkpoint, []

    def timed_save(*a, **kw):   # the checkpoint step: gather, snapshot, save
        synchronize(torch, device)
        t0 = time.perf_counter()
        status = save_checkpoint(*a, **kw)
        save_s.append(time.perf_counter() - t0)
        return status

    train.save_checkpoint = timed_save
    out_dir = root / "out"
    try:
        synchronize(torch, device)
        reset_launches()
        t0 = time.perf_counter()
        with dumpable_graphs(torch):
            model = train.run({
                "device": device, "dataset_path": manifest,
                "decoder_path": str(ckpt / "decoder.pt"),
                "lr_codebook_path": str(ckpt / "codebook_2.pt"),
                "hr_codebook_path": str(ckpt / "codebook_3.pt"),
                "config_path": str(config), "out_dir": str(out_dir),
                "bf16": bf16, "batch_size": t["batch"],
                "max_steps": t["steps"],
                "checkpoint_step": t["checkpoint_step"],
                "test_num_sample": t["previews"], "seed": seed})
        synchronize(torch, device)
        run_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        train.make_train_step = make_train_step
        train.save_checkpoint = save_checkpoint
    log(f"[train] train.run: {t['steps']} {kind} steps at batch "
        f"{t['batch']} in {run_s:.3f} s; launches {launches}; checkpoint "
        f"steps (gather, snapshot and synchronous save) "
        f"{[round(x, 3) for x in save_s]} s")

    losses = [json.loads(line)["ce_loss"] for line in
              (out_dir / "metrics.jsonl").read_text().splitlines()]
    if len(losses) != t["steps"] or not np.isfinite(losses).all():
        raise SystemExit(f"training losses not all finite: {losses}")
    log(f"[train] losses {[round(x, 4) for x in losses]}")
    # phase 11 holds its runs to this one's losses and parameters
    TRAINED[kind] = {"losses": losses, "out_dir": out_dir,
                     "manifest": manifest, "step_mean_s": None,
                     "save_s": save_s, "params": [
                         p.detach().clone() for p in model.parameters()]}
    checkpoints = list(range(0, t["steps"], t["checkpoint_step"]))
    for n in checkpoints:
        status, state = load_model(out_dir / "models_checkpoint"
                                   / f"model_{n}.pt")
        if not status or not {"model", "model_optimizer",
                              "global_steps"} <= set(state) \
                or state["global_steps"] != n:
            raise SystemExit(f"model_{n}.pt is missing or incomplete")
        transformer_from_checkpoint(state, torch.device(device),
                                    logging=_no_skips)
        for name in ("ground_truth", "low_res_cond", "high_res_example",
                     "high_res_recon"):
            if not (out_dir / "images" / f"{name}_{n}.jpg").exists():
                raise SystemExit(f"preview {name}_{n}.jpg was not written")
    log(f"[train] checkpoints {checkpoints} load back through the port; "
        f"previews written")
    # kernel A runs every equal-shape self-attention: per step the
    # encoder's and the decoder's layers, forward and backward (one launch
    # of the backward kernel pair per layer); per preview
    # the encoder, the prefill of <start>, and each windowed step once the
    # context fills the window (its last layer reads one query: not A)
    cfg = json.loads(config.read_text())
    enc, dec = cfg["num_enc_layers"], cfg["num_dec_layers"]
    windowed = max(0, 1 + seq_len(FULL["patches"][-1])
                   - cfg["sliding_window"])
    want = {"fused_bmu": 2 * t["steps"] + 3 * len(checkpoints),
            "flash_attention": (enc + dec) * t["steps"] + len(checkpoints)
            * (enc + dec + windowed * (dec - 1)),
            "flash_attention_backward": (enc + dec) * t["steps"],
            "flash_attention_backward_calls": (enc + dec) * t["steps"],
            "fused_bmu_small_m": 0}
    for name, n in want.items():
        if launches[name] != n:
            raise SystemExit(f"the training path launched {name} "
                             f"{launches[name]} times, expected {n}")
    # one graph (batch 8 of 4x32x32, one dtype) replayed at every step; a
    # replay launches one step's kernels
    graph = replay_graph(made, f"the {kind} trainer")
    per_replay = {"flash_attention": enc + dec,
                  "flash_attention_backward": enc + dec,
                  "flash_attention_backward_calls": enc + dec,
                  "fused_bmu": 2, "fused_bmu_small_m": 0}
    for name, n in per_replay.items():
        if graph["launches"][name] != n:
            raise SystemExit(f"a {kind} train step's replay launches {name} "
                             f"{graph['launches'][name]} times, expected {n}")
    graph["kernel_nodes"] = graph_kernel_nodes(made[0].runner)
    for name in TRACED_KERNELS:
        if graph["kernel_nodes"][name] != per_replay[name]:
            raise SystemExit(f"the {kind} train step's graph holds "
                             f"{graph['kernel_nodes'][name]} {name} kernel "
                             f"nodes, a replay counts {per_replay[name]}")
    per_step = sum(step_s[1:]) / len(step_s[1:])
    TRAINED[kind]["step_mean_s"] = per_step
    log(f"[train] {kind}: seconds per step, graphed (step 0, with its "
        f"warm-up, capture and instantiation, left out): {per_step:.4f} "
        f"(steps {[round(x, 4) for x in step_s]}); capture "
        f"{graph['capture_s']:.3f} s, instantiation "
        f"{graph['instantiate_s']:.3f} s; a replay launches "
        f"{ {k: graph['launches'][k] for k in per_replay} }, the graph "
        f"holds as many kernel nodes of each")
    timings = {"run_s": run_s, "step_s": step_s, "step_mean_s": per_step,
               "losses": losses, "graph": graph, "save_s": save_s}
    if profile:
        wall = sum(tr["wall_ms"] for tr in traces)
        busy = sum(tr["device_busy_ms"] for tr in traces)
        timings["profile"] = {"steps": [2, 5], "wall_ms": wall,
                              "device_busy_ms": busy,
                              "busy_share": busy / wall, "per_step": traces}
        log(f"[profile] train steps 2-5 (graph replays): wall {wall:.1f} "
            f"ms, device busy {busy:.1f} ms ({100 * busy / wall:.1f}%), "
            f"{sum(tr['kernel_launches'] for tr in traces)} kernel launches; "
            f"the port's kernels in each traced step "
            f"{[tr['ours'] for tr in traces]}")
        # kernel A and its backward must show in the trace of a replay;
        # the BMU kernels are reported only: traces in this process have
        # listed none of them (what drops them is open), while the
        # graph's kernel nodes hold them (asserted above) and phase 9
        # (c)'s traces in a new process list them
        for tr in traces:
            for name in ("flash_attention", "flash_attention_backward"):
                if tr["ours"][name] != per_replay[name]:
                    raise SystemExit(f"a traced {kind} replay ran "
                                     f"{tr['ours'][name]} {name} kernels, "
                                     f"its count {per_replay[name]}")
        for e in traces[-1]["top"]:
            log(f"[profile]   step 5: {e['ms']:8.2f} ms  {e['count']:6d}x  "
                f"{e['name']}")
    return launches, timings


def replay_graph(steps, what):
    """The one graph of the one train step in ``steps`` (what
    ``make_train_step`` returned): its capture and instantiation seconds
    and the launches of a replay, by counter."""
    if len(steps) != 1 or steps[0].runner is None \
            or len(steps[0].runner.graphs) != 1:
        raise SystemExit(f"{what} did not run one graphed train step")
    graph, = steps[0].runner.graphs.values()
    return {"capture_s": graph.capture_s,
            "instantiate_s": graph.instantiate_s,
            "launches": dict(zip(read_launches(), graph.launches))}


def _train_run(torch, build, inputs, steps, device, graphed,
               capturable=True):
    """``steps`` synchronised steps of ``build(graphed, capturable)`` on
    ``inputs(i)``: (losses, parameters, seconds per step, the step)."""
    step, model = build(graphed, capturable)
    losses, step_s = [], []
    for i in range(steps):
        synchronize(torch, device)
        t0 = time.perf_counter()
        losses.append(step(*inputs(i)))
        synchronize(torch, device)
        step_s.append(time.perf_counter() - t0)
    return torch.stack(losses).cpu(), list(model.parameters()), step_s, step


def _max_diff(a, b):
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def graphed_against_eager(torch, what, build, inputs, steps, device,
                          deterministic=False, float32=True):
    """``build(graphed, capturable) -> (step, model)`` run ``steps`` steps
    of ``inputs(i)`` graphed, eager, eager again, and eager on the
    host-side Adam of the eager steps before graphs (``capturable=False``),
    each from the same seeded state.  Graphed and eager (one capturable
    Adam, the same kernels) must give equal losses and parameters, bit for
    bit, as the two eager runs must.  The host-side Adam's distance is
    bounded at ``HOST_ADAM_ATOL`` when the step runs in ``float32`` (a
    fault in the capturable Adam's bias correction or its learning-rate
    tensor moves parameters by about the learning rate) and reported in
    bf16.  The graph's kernel nodes (:func:`graph_kernel_nodes`) must
    hold the port's kernels as often as a replay counts them.
    ``deterministic``: all four
    runs under ``cudnn.deterministic`` (cuDNN's default backward
    convolutions may sum in an order that changes from run to run).
    Returns seconds per step (steps 1 on) and the differences."""
    runs = {}
    torch.backends.cudnn.deterministic = deterministic
    try:
        for name, graphed, capturable in (
                ("graphed", True, True), ("eager", False, True),
                ("eager_again", False, True),
                ("eager_host_adam", False, False)):
            with dumpable_graphs(torch, graphed):
                runs[name] = _train_run(torch, build, inputs, steps,
                                        device, graphed, capturable)
    finally:
        torch.backends.cudnn.deterministic = False
    (lg, pg, sg, step), (le, pe, se, _), (la, pa, _, _), (lh, ph, _, _) = (
        runs["graphed"], runs["eager"], runs["eager_again"],
        runs["eager_host_adam"])
    for other, (lo, po) in (("eager", (le, pe)), ("eager again", (la, pa))):
        if not torch.equal(lg, lo) or _max_diff(pg, po) != 0:
            raise SystemExit(f"{what}: graphed and {other} steps differ: "
                             f"losses {lg.tolist()} against {lo.tolist()}, "
                             f"max |param diff| {_max_diff(pg, po):.3e}")
    host_adam = _max_diff(pe, ph)
    if float32 and host_adam > HOST_ADAM_ATOL:
        raise SystemExit(f"{what}: the capturable Adam's parameters are "
                         f"{host_adam:.3e} from the host-side Adam's after "
                         f"{steps} float32 steps (bound {HOST_ADAM_ATOL})")
    graph = replay_graph([step], what)
    nodes = graph_kernel_nodes(step.runner)
    for name, tags in TRACED_KERNELS.items():
        if nodes[name] != graph["launches"][name]:
            raise SystemExit(f"{what}: the graph holds {nodes[name]} "
                             f"{name} kernel nodes ({'/'.join(tags)}), a "
                             f"replay counts {graph['launches'][name]}")
    out = {"graphed_step_s": _step_mean(sg), "eager_step_s": _step_mean(se),
           "graphed_steps": sg, "eager_steps": se, "losses": lg.tolist(),
           "capture_s": graph["capture_s"],
           "instantiate_s": graph["instantiate_s"],
           "cudnn_deterministic": deterministic,
           "host_adam_max_param_diff": host_adam,
           "host_adam_max_loss_diff": (le - lh).abs().max().item(),
           "graph_kernel_nodes": nodes}
    log(f"[compare] {what}, {steps} steps of make_train_step on one seed"
        f"{' (cudnn.deterministic)' if deterministic else ''}: graphed, "
        f"eager and eager again: losses and parameters equal bit for bit; "
        f"seconds per step (steps 1-{steps - 1}) graphed "
        f"{out['graphed_step_s']:.4f}, eager {out['eager_step_s']:.4f}; "
        f"capture {out['capture_s']:.3f} s, instantiation "
        f"{out['instantiate_s']:.3f} s; against the host-side Adam "
        f"(capturable=False): max |param diff| "
        f"{out['host_adam_max_param_diff']:.3e}"
        f"{f' (bound {HOST_ADAM_ATOL})' if float32 else ''}, max |loss "
        f"diff| {out['host_adam_max_loss_diff']:.3e}; the graph's kernel "
        f"nodes {nodes}, as a replay counts them")
    return out


# the capturable Adam against the host-side one after 6 float32 steps
# (largest reading 2.384e-07, the transformer in float32, NVIDIA H100 80GB
# HBM3, 700.00 W); a wrong bias correction or a stale learning rate moves
# parameters by about the learning rate, 1e-5 to 1e-4 in these configs
HOST_ADAM_ATOL = 1e-6


def dumpable_graphs(torch, on=True):
    """While open (and ``on``), every ``torch.cuda.CUDAGraph`` made keeps
    its captured graph (``keep_graph``) for ``debug_dump`` and is still
    instantiated as it ends its capture, so that nothing a replay runs,
    nor the time ``capture_end`` takes, changes."""
    import contextlib

    @contextlib.contextmanager
    def patched():
        base = torch.cuda.CUDAGraph

        class Dumpable(base):
            def __init__(self, *args, **kwargs):
                super().__init__(keep_graph=True)

            def capture_end(self):
                super().capture_end()
                self.instantiate()

        torch.cuda.CUDAGraph = Dumpable
        try:
            yield
        finally:
            torch.cuda.CUDAGraph = base
    return patched() if on else contextlib.nullcontext()


def graph_kernel_nodes(runner):
    """The port's kernels among the kernel nodes of ``runner``'s one graph
    (captured under :func:`dumpable_graphs`), by ``TRACED_KERNELS``' names,
    read from the graph's DOT dump (``cudaGraphDebugDotPrint``)."""
    graph, = runner.graphs.values()
    with tempfile.TemporaryDirectory(prefix="qaig_graph_") as tmp:
        path = Path(tmp) / "graph.dot"
        graph.graph.debug_dump(str(path))
        statements = path.read_text().split("];")
    if len(statements) < 2:
        raise SystemExit("the graph's DOT dump lists no node")
    return {name: sum(any(tag in st for tag in tags) for st in statements)
            for name, tags in TRACED_KERNELS.items()}


def traced_replay(torch, step, inputs, device):
    """One more call of a graphed ``step`` (a replay) in a
    ``torch.profiler`` window of its own: :func:`stop_trace`'s reading."""
    synchronize(torch, device)
    prof = start_trace(torch)
    t0 = time.perf_counter()
    step(*inputs)
    synchronize(torch, device)
    return stop_trace(prof, time.perf_counter() - t0)


def transformer_steps(torch, workdir, bf16=True, seed=0, device="cuda"):
    """Phase 6 (b)'s steps: ``TRAIN``'s full-width model through
    ``make_train_step`` on seeded batches and window starts, with phase
    5's stage-2 codebooks.  Returns (``build(graphed, capturable) ->
    (step, model)``, ``inputs(i)``, steps)."""
    import numpy as np
    from qaig_tpu_torch.models.core import init_parameters
    from qaig_tpu_torch.models.transformer import Transformer
    from qaig_tpu_torch.train import common, optim
    from qaig_tpu_torch.train import transformer as train
    from qaig_tpu_torch.utils.checkpoint import load_model

    t = TRAIN
    config = json.loads((Path(__file__).resolve().parent
                         / t["config"]).read_text())
    ckpt = Path(workdir) / "models_checkpoint"
    lr_cb, hr_cb = (common.codebook_from_checkpoint(
        load_model(ckpt / f"codebook_{i}.pt")[1], torch.device(device))
        for i in (2, 3))
    k = FULL["k"]
    cfg = train.build_transformer_config(config, False, k, k)
    rng = np.random.default_rng(seed + 7)
    batches = [torch.from_numpy(rng.standard_normal(
        (t["batch"], FULL["latent_c"]) + FULL["image_dim"])
        .astype(np.float32)).to(device) for _ in range(t["steps"])]

    def build(graphed, capturable):
        model = init_parameters(Transformer(cfg, device=device),
                                torch.Generator(device=device)
                                .manual_seed(seed))
        optimizer, scheduler = optim.make_adam(
            model.parameters(), config["model_lr"], 50_000,
            capturable=capturable)
        step = train.make_train_step(
            model, optimizer, lr_cb, hr_cb, False, k, k,
            config["sliding_window"], bf16=bf16, scheduler=scheduler,
            graphed=graphed)
        windows = torch.Generator().manual_seed(seed)

        def windowed(batch):
            return step(batch, windows)
        windowed.runner = step.runner
        return windowed, model

    return build, lambda i: (batches[i],), t["steps"]


def compare_train_steps(torch, workdir, bf16=True, seed=0, device="cuda"):
    """Phase 6 (b): :func:`transformer_steps` graphed against eager
    (:func:`graphed_against_eager`)."""
    return graphed_against_eager(
        torch, f"transformer {'bf16' if bf16 else 'float32'}",
        *transformer_steps(torch, workdir, bf16, seed, device), device,
        float32=not bf16)


def codebook_steps(torch, name, seed=0, device="cuda"):
    """Phase 9 (b)'s steps of ``FRONT``'s ``name`` codebook (hr, lr)
    through ``make_train_step`` on seeded latents of its config's shape,
    the neighbourhood range shrinking by one a step.  Returns
    (``build(graphed, capturable) -> (step, model)``, ``inputs(i)``,
    steps)."""
    import numpy as np
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.train import codebook, optim

    f = FRONT
    c = json.loads((Path(__file__).resolve().parent
                    / f["codebooks"][name]).read_text())
    rng = np.random.default_rng(seed + 12 + list(f["codebooks"]).index(name))
    latents = [torch.from_numpy(rng.standard_normal(
        (f["batch"], c["image_C"], c["image_H"], c["image_W"]))
        .astype(np.float32)).to(device) for _ in range(f["steps"])]
    half = c["num_embeddings"] // 2

    def build(graphed, capturable):
        model = Codebook(
            patch_dim=(c["patch_H"], c["patch_W"]),
            image_dim=(c["image_H"], c["image_W"]),
            image_channel=c["image_C"],
            num_embeddings=c["num_embeddings"], device=device).init(
            torch.Generator(device=device).manual_seed(seed))
        optimizer, scheduler = optim.make_adam(
            model.parameters(), c["model_lr"], 100_000,
            capturable=capturable)
        return codebook.make_train_step(
            model, optimizer, scheduler, graphed=graphed), model

    return build, lambda i: (latents[i], float(half - i)), f["steps"]


def compare_front_steps(torch, seed=0, device="cuda"):
    """Phase 9 (b): the front trainers' steps through ``make_train_step``
    at ``FRONT``'s configs, graphed against eager
    (:func:`graphed_against_eager`): the autoencoder in float32 and bf16
    on seeded 128x128x3 images (under ``cudnn.deterministic``; with
    cuDNN's default algorithms two eager runs are compared too), the HR
    and LR codebooks (:func:`codebook_steps`); batch 8, 6 steps each."""
    import numpy as np
    from qaig_tpu_torch.models.core import init_parameters
    from qaig_tpu_torch.train import autoencoder, optim

    f, repo = FRONT, Path(__file__).resolve().parent
    rng = np.random.default_rng(seed + 11)
    out = {}
    ae_cfg = json.loads((repo / f["autoencoder"]).read_text())
    images = [torch.from_numpy(rng.uniform(
        -1, 1, (f["batch"], 3, f["side"], f["side"])).astype(np.float32))
        .to(device) for _ in range(f["steps"])]
    for kind in ("float32", "bf16"):
        def build(graphed, capturable, bf16=kind == "bf16"):
            model, _ = autoencoder.build_autoencoder(ae_cfg, device)
            init_parameters(model, torch.Generator(device=device)
                            .manual_seed(seed))
            optimizer, scheduler = optim.make_adam(
                model.parameters(), ae_cfg["model_lr"], 50_000,
                capturable=capturable)
            return autoencoder.make_train_step(
                model, optimizer, bf16=bf16, scheduler=scheduler,
                graphed=graphed), model
        out[f"autoencoder_{kind}"] = graphed_against_eager(
            torch, f"autoencoder {kind}", build, lambda i: (images[i],),
            f["steps"], device, deterministic=True,
            float32=kind == "float32")
        # cuDNN's default algorithms, eager twice: how far two runs of the
        # same steps land apart without cudnn.deterministic
        eager = [_train_run(torch, build, lambda i: (images[i],),
                            f["steps"], device, False) for _ in range(2)]
        spread = _max_diff(eager[0][1], eager[1][1])
        out[f"autoencoder_{kind}"]["default_eager_max_param_diff"] = spread
        log(f"[compare] autoencoder {kind}, cuDNN's default algorithms: "
            f"two eager runs of the same {f['steps']} steps, max |param "
            f"diff| {spread:.3e}")
    for name in f["codebooks"]:
        out[f"codebook_{name}"] = graphed_against_eager(
            torch, f"codebook {name}", *codebook_steps(torch, name, seed,
                                                       device), device)
    return out


# in a new process: one graphed step (the capture) and a traced replay of
# each of phase 6 (b)'s bf16 transformer step and phase 9 (b)'s codebook
# steps; prints each replay's launches and the trace's kernels, last
TRACE_RUNNER = """
import json, sys
import torch
import chip_smoke
from qaig_tpu_torch.train.common import full_float32
full_float32()
workdir, device = sys.argv[1], sys.argv[2]
steps = {"transformer bf16": chip_smoke.transformer_steps(
             torch, workdir, device=device),
         "codebook hr": chip_smoke.codebook_steps(torch, "hr", device=device),
         "codebook lr": chip_smoke.codebook_steps(torch, "lr", device=device)}
out = {}
for what, (build, inputs, _) in steps.items():
    step, _ = build(True, True)
    step(*inputs(0))
    replay = chip_smoke.replay_graph([step], what)["launches"]
    trace = chip_smoke.traced_replay(torch, step, inputs(1), device)
    out[what] = {"replay": {k: replay[k] for k in chip_smoke.TRACED_KERNELS},
                 "trace": trace["ours"], "wall_ms": trace["wall_ms"],
                 "device_busy_ms": trace["device_busy_ms"]}
print("TRACED " + json.dumps(out))
"""


def traced_replays_alone(workdir, device="cuda"):
    """Phase 9 (c): ``TRACE_RUNNER`` in a new process.  Each traced
    replay must hold A, A' and BMU (row tiles and small M) as often as a
    replay counts them.  (In this script's own process, after phases 3-9,
    traces of the same replays list A and A' but no BMU kernel, while the
    graphs' kernel nodes hold them: what drops them from those traces is
    open.)  Returns the readings."""
    import os
    proc = subprocess.run(
        [sys.executable, "-c", TRACE_RUNNER, str(workdir), device],
        cwd=Path(__file__).resolve().parent, env=dict(os.environ),
        capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("TRACED ")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"the traced replays failed (exit "
                         f"{proc.returncode}):\n"
                         + (proc.stdout + proc.stderr)[-4000:])
    out = json.loads(lines[-1][len("TRACED "):])
    for what, r in out.items():
        if r["trace"] != r["replay"]:
            raise SystemExit(f"a traced replay of the {what} step in a new "
                             f"process ran {r['trace']}, a replay counts "
                             f"{r['replay']}")
        log(f"[trace] {what}, a replay traced in a new process: kernels "
            f"{r['trace']} as a replay counts them (wall "
            f"{r['wall_ms']:.2f} ms, device busy "
            f"{r['device_busy_ms']:.2f} ms)")
    return out


def _no_skips(msg):
    raise SystemExit(f"checkpoint does not load back cleanly: {msg}")


def start_trace(torch):
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def device_kernels(prof):
    """The kernels in a trace's device events: user annotations (such as
    the optimizer's ``Optimizer.step`` range) also show there and are
    not device work."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("Optimizer.", "ProfilerStep"))]


def stop_trace(prof, wall_s):
    """Device time of the kernels a traced step ran, against its wall
    time (the profiler's host cost lengthens it: a lower bound)."""
    prof.__exit__(None, None, None)
    kernels = device_kernels(prof)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {"wall_ms": wall_s * 1e3,
            "device_busy_ms": sum(e.self_device_time_total
                                  for e in kernels) / 1e3,
            "kernel_launches": sum(e.count for e in kernels),
            "ours": {name: sum(e.count for e in kernels
                               if any(tag in e.key for tag in tags))
                     for name, tags in TRACED_KERNELS.items()},
            "top": [{"name": e.key[:90], "count": e.count,
                     "ms": e.self_device_time_total / 1e3} for e in top]}


# a train step's kernels by their names in a device trace or a graph's
# kernel nodes, one per counted launch (one backward launch runs a dq and
# a dk/dv kernel, one BMU launch a kernel and, when it splits the codes,
# a reduction: the first of each is counted)
TRACED_KERNELS = {"flash_attention": ("flash_attention_fwd",),
                  "flash_attention_backward": ("flash_bwd_dq",),
                  "fused_bmu": ("bmu_kernel", "bmu_small_m_kernel"),
                  "fused_bmu_small_m": ("bmu_small_m_kernel",)}


# ---------------------------------------------------------------------------
# phase 8: the probe of kernel 6
# ---------------------------------------------------------------------------

PROBE = dict(rows=(8192, 1024), layers=7, reps=20)


def run_probe_path(torch, device="cuda"):
    """``probe_mlp_fused.main()`` at its full shapes.  Per row count the
    probe runs a 1-layer kernel chain once, then the full chain once to
    warm up and ``reps`` times timed; each layer of a chain launches the
    kernel twice (packed QKV, FFN).  Returns (launches, the probe's
    results)."""
    from qaig_tpu_torch.scripts import probe_mlp_fused as probe

    synchronize(torch, device)
    reset_launches()
    t0 = time.perf_counter()
    results = probe.main(device=device, rows=PROBE["rows"],
                         layers=PROBE["layers"], reps=PROBE["reps"])
    synchronize(torch, device)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    want = len(PROBE["rows"]) * 2 * (1 + PROBE["layers"]
                                     * (1 + PROBE["reps"]))
    log(f"[probe] probe_mlp_fused.main() in {seconds:.1f} s; launches "
        f"{launches}")
    if launches["mlp2_fused"] != want:
        raise SystemExit(f"the probe launched mlp2_fused "
                         f"{launches['mlp2_fused']} times, expected {want}")
    for r in results:
        log(f"[probe] rows={r['rows']}: 1-layer max err {r['max_err']:.5f}; "
            f"~{r['hbm_mb_avoided']:.0f} MB of hidden-activation round "
            f"trip avoided per chain; chain of {r['layers']} layers: "
            f"library {r['library_ms']:.3f} ms, kernel "
            f"{r['kernel_ms']:.3f} ms")
        if not r["max_err"] <= ATOL:
            raise SystemExit(f"the probe's kernel chain disagrees with the "
                             f"library chain: {r['max_err']}")
    return launches, {"seconds": seconds, "results": results}


# ---------------------------------------------------------------------------
# phase 9: the front of the pipeline through the four stage CLIs
# ---------------------------------------------------------------------------

FRONT = dict(images=64, side=128, batch=8, steps=6, checkpoint_step=3,
             autoencoder="examples/configs/autoencoder.json",
             codebooks={"hr": "examples/configs/codebook_hr.json",
                        "lr": "examples/configs/codebook_lr.json"},
             prune_threshold=1)

# runs one CLI's main() in a fresh process, its train steps timed
# (synchronised), and prints the kernels' launch counts, and the train
# step's graph (capture and instantiation seconds, launches of a replay),
# last
CLI_RUNNER = """
import importlib, json, sys, time
import torch
import chip_smoke
module, stage, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
device = argv[argv.index("--device") + 1]
def sync():
    chip_smoke.synchronize(torch, device)
steps, made = [], []
if stage:
    train = importlib.import_module(f"qaig_tpu_torch.train.{stage}")
    make = train.make_train_step
    def timed_make(*a, **kw):
        step = make(*a, **kw)
        made.append(step)
        def timed(*args):
            sync()
            t0 = time.perf_counter()
            out = step(*args)
            sync()
            steps.append(time.perf_counter() - t0)
            return out
        return timed
    train.make_train_step = timed_make
cli = importlib.import_module(f"qaig_tpu_torch.cli.{module}")
sync()
chip_smoke.reset_launches()
t0 = time.perf_counter()
cli.main(argv)
sync()
seconds = time.perf_counter() - t0
out = {"launches": chip_smoke.read_launches(), "step_s": steps,
       "seconds": seconds}
if stage:
    out["graph"] = chip_smoke.replay_graph(made, stage)
print("LAUNCHES " + json.dumps(out))
"""


def run_cli(module, stage, argv, device="cuda"):
    """``python -m qaig_tpu_torch.cli.<module> <argv> --device <device>``
    through ``CLI_RUNNER``; returns its launches, step seconds and
    seconds."""
    import os
    repo = Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, "-c", CLI_RUNNER, module, stage or "",
         *[str(a) for a in argv], "--device", device],
        cwd=repo, env=dict(os.environ), capture_output=True, text=True,
        timeout=900)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("LAUNCHES ")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"{module} failed (exit {proc.returncode}):\n"
                         + (proc.stdout + proc.stderr)[-4000:])
    return json.loads(lines[-1][len("LAUNCHES "):])


def write_images(root, n, side, seed=0):
    """``n`` seeded side x side x 3 PNGs (``utils/png.py``) and their
    manifest."""
    import numpy as np
    from qaig_tpu_torch.data.manifest import write_manifest
    from qaig_tpu_torch.utils import png
    folder = Path(root) / "images"
    folder.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        # smooth colour fields plus noise: something an autoencoder can fit
        yy, xx = np.mgrid[0:side, 0:side] / side
        phase = rng.uniform(0, 2 * np.pi, 3)
        base = 127.5 + 100 * np.sin(2 * np.pi * (xx[..., None] * phase / 3
                                                 + yy[..., None]) + phase)
        pixels = np.clip(base + rng.normal(0, 10, (side, side, 3)), 0, 255)
        path = folder / f"{i}.png"
        path.write_bytes(png.encode(pixels.astype(np.uint8)))
        rows.append({"image_fpath": str(path), "labels": []})
    return write_manifest(Path(root) / "dataset.json", rows)


def _finite_losses(out_dir, n):
    import numpy as np
    losses = [json.loads(line)["recon_loss"] for line in
              (Path(out_dir) / "metrics.jsonl").read_text().splitlines()]
    if len(losses) != n or not np.isfinite(losses).all():
        raise SystemExit(f"{out_dir}: losses not all finite: {losses}")
    return losses


def _step_mean(step_s):
    return sum(step_s[1:]) / len(step_s[1:])


def run_front_path(torch, workdir, device="cuda"):
    """Phase 9.  Returns (launches by path, timings, paths)."""
    import numpy as np
    from qaig_tpu_torch.utils.checkpoint import load_model

    f = FRONT
    repo = Path(__file__).resolve().parent
    root = Path(workdir) / "front"
    t0 = time.perf_counter()
    dataset = write_images(root, f["images"], f["side"])
    log(f"[front] {f['images']} PNGs of {f['side']}x{f['side']}x3 written "
        f"in {time.perf_counter() - t0:.1f} s")
    checkpoints = list(range(0, f["steps"], f["checkpoint_step"]))
    common = ["--batch-size", f["batch"], "--max-steps", f["steps"],
              "--checkpoint-step", f["checkpoint_step"]]
    launches, timings = {}, {}

    for kind, extra in (("f32", []), ("bf16", ["--bf16"])):
        out = root / f"ae_{kind}"
        res = run_cli("train_autoencoder", "autoencoder", [
            "--dataset-path", dataset, "--config-path",
            repo / f["autoencoder"], "--out-dir", out, *common, *extra],
            device)
        losses = _finite_losses(out, f["steps"])
        for n in checkpoints:
            ok, ckpt = load_model(out / "models_checkpoint" / f"model_{n}.pt")
            if not ok or ckpt["global_steps"] != n or \
                    ckpt["model_optimizer"] is None:
                raise SystemExit(f"ae_{kind}: model_{n}.pt is missing or "
                                 f"incomplete")
            for grid in ("ground_truth", "recon"):
                if not (out / "images" / f"{grid}_{n}.jpg").exists():
                    raise SystemExit(f"ae_{kind}: {grid}_{n}.jpg missing")
        timings[f"autoencoder_{kind}"] = {
            "step_s": res["step_s"], "step_mean_s": _step_mean(res["step_s"]),
            "seconds": res["seconds"], "losses": losses,
            "graph": res["graph"]}
        log(f"[front] train_autoencoder {kind}: {f['steps']} graphed steps "
            f"at batch {f['batch']}, {_step_mean(res['step_s']):.4f} s per "
            f"step (steps 1-5; all {[round(x, 4) for x in res['step_s']]}; "
            f"capture {res['graph']['capture_s']:.3f} s, instantiation "
            f"{res['graph']['instantiate_s']:.3f} s); losses "
            f"{[round(x, 5) for x in losses]}; checkpoints and grids "
            f"{checkpoints}")
    decoder = root / "ae_f32" / "models_checkpoint" / \
        f"model_{checkpoints[-1]}.pt"

    fmaps = root / "fmaps"
    res = run_cli("generate_fmap_dataset", None, [
        "--dataset-path", dataset, "--model-path", decoder, "--out-dir",
        fmaps, "--batch-size", f["batch"]], device)
    from qaig_tpu_torch.data.manifest import Manifest
    rows = Manifest(fmaps / "all_dataset.json").rows
    if len(rows) != f["images"]:
        raise SystemExit(f"fmap manifest has {len(rows)} rows")
    for row in rows:
        latent = np.load(row["fmap_path"])
        if latent.shape != (4, 32, 32) or latent.dtype != np.float32 or \
                not np.isfinite(latent).all():
            raise SystemExit(f"bad latent {row['fmap_path']}: "
                             f"{latent.shape} {latent.dtype}")
    timings["fmap_s"] = res["seconds"]
    log(f"[front] generate_fmap_dataset: {len(rows)} latents (4, 32, 32) "
        f"in {res['seconds']:.3f} s")

    books = {}
    for name, config in f["codebooks"].items():
        out = root / f"codebook_{name}"
        res = run_cli("train_codebook", "codebook", [
            "--dataset-path", fmaps / "all_dataset.json", "--decoder-path",
            decoder, "-c", repo / config, "--out-dir", out, *common], device)
        _finite_losses(out, f["steps"])
        for n in checkpoints:
            ok, ckpt = load_model(out / "models_checkpoint"
                                  / f"codebook_{n}.pt")
            if not ok or ckpt["global_steps"] != n or \
                    "model_optimizer" not in ckpt:
                raise SystemExit(f"codebook_{name}: codebook_{n}.pt is "
                                 f"missing or incomplete")
            for grid in ("image_plot", "quant_image_plot"):
                if not (out / "images" / f"{grid}_{n}.jpg").exists():
                    raise SystemExit(f"codebook_{name}: {grid}_{n}.jpg "
                                     f"missing")
        # one BMU call per train step and per preview; the LR codebook's
        # (M 8, D 4096) in the small-M geometry, the HR's (M 128) in row
        # tiles
        want = f["steps"] + len(checkpoints)
        want_small = want if name == "lr" else 0
        launches[f"train_codebook_{name}"] = res["launches"]
        replay = res["graph"]["launches"]
        if res["launches"]["fused_bmu"] != want or \
                res["launches"]["fused_bmu_small_m"] != want_small or \
                replay["fused_bmu"] != 1 or \
                replay["fused_bmu_small_m"] != (name == "lr"):
            raise SystemExit(f"train_codebook {name} launched fused_bmu "
                             f"{res['launches']['fused_bmu']} times "
                             f"({res['launches']['fused_bmu_small_m']} "
                             f"small-M), expected {want} ({want_small}); "
                             f"a replay {replay['fused_bmu']} "
                             f"({replay['fused_bmu_small_m']}), expected 1")
        books[name] = out / "models_checkpoint" / \
            f"codebook_{checkpoints[-1]}.pt"
        timings[f"codebook_{name}"] = {
            "step_s": res["step_s"], "step_mean_s": _step_mean(res["step_s"]),
            "seconds": res["seconds"], "graph": res["graph"]}
        log(f"[front] train_codebook {name}: {f['steps']} graphed steps, "
            f"{_step_mean(res['step_s']):.4f} s per step (steps 1-5; all "
            f"{[round(x, 4) for x in res['step_s']]}; capture "
            f"{res['graph']['capture_s']:.3f} s, instantiation "
            f"{res['graph']['instantiate_s']:.3f} s); fused_bmu calls "
            f"{want}, {want_small} of them small-M, one a replay")

    out = root / "pruned"
    res = run_cli("prune_codebook", None, [
        "--dataset-path", fmaps / "all_dataset.json", "--codebook-path",
        books["hr"], "--out-dir", out, "--batch-size", f["batch"],
        "--prune-threshold", f["prune_threshold"]], device)
    ok, pruned = load_model(out / "models_checkpoint" / "pruned_codebook.pt")
    if not ok or not 0 < pruned["num_embeddings"] <= 512:
        raise SystemExit("pruned_codebook.pt is missing or empty")
    want = -(-f["images"] // f["batch"])   # one call per batch, ragged kept
    launches["prune"] = res["launches"]
    if res["launches"]["fused_bmu"] != want:
        raise SystemExit(f"prune_codebook launched fused_bmu "
                         f"{res['launches']['fused_bmu']} times, expected "
                         f"{want}")
    timings["prune_s"] = res["seconds"]
    log(f"[front] prune_codebook (hr, threshold {f['prune_threshold']}): "
        f"{pruned['num_embeddings']} of 512 codes kept in "
        f"{res['seconds']:.3f} s; fused_bmu calls {want}")
    return launches, timings, {"dataset": dataset, "decoder": decoder,
                               "fmaps": fmaps / "all_dataset.json",
                               "books": books}


# ---------------------------------------------------------------------------
# phase 4d: the front's stages, card against CPU in float32
# ---------------------------------------------------------------------------

def _sgd_step(torch, model, make_step, *inputs):
    """(loss, gradients as old minus new) of one SGD(lr=1) step of
    ``make_step(model, optimizer)``: graphed on the card, eager on the
    CPU."""
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_step(model, torch.optim.SGD(model.parameters(), lr=1.0))
    if (step.runner is not None) != (next(model.parameters()).device.type
                                     == "cuda"):
        raise SystemExit("the front's train step is not graphed on the "
                         "card and eager on the CPU")
    loss = float(step(*inputs))
    return loss, {n: (before[n] - p.detach()).cpu()
                  for n, p in model.named_parameters()}


def check_front_reference(torch, paths, device="cuda"):
    """Phase 4d, float32, TF32 off, each card step graphed against the
    CPU's eager one: (a) one autoencoder train step of a
    small config (32-64 channels, 32x32 images, batch 4): loss rel 1e-5,
    gradients atol 1e-5, then the same step with cuDNN's TF32 on (reported
    only: the fault the package's setting repairs); (b) one codebook train step at the HR shape
    (batch 8 of 4x32x32, patch 8, K 512): BMU indices equal outside
    near-ties, loss rel 1e-5; (c) phase 9's latents of 8 images (written
    on the card by the fmap CLI) against the port's encoder on the CPU:
    atol 1e-5."""
    import numpy as np
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.models.core import init_parameters
    from qaig_tpu_torch.ops.bmu import near_tie_agreement
    from qaig_tpu_torch.ops.patch import patchify
    from qaig_tpu_torch.train import autoencoder, codebook, fmap
    from qaig_tpu_torch.train.common import full_float32
    from qaig_tpu_torch.data.image_dataset import ImageDataset
    from qaig_tpu_torch.data.manifest import Manifest
    from qaig_tpu_torch.utils.checkpoint import load_model

    gen = torch.Generator().manual_seed(8)
    cfg = dict(json.loads((Path(__file__).resolve().parent
                           / FRONT["autoencoder"]).read_text()),
               min_channel=32, max_channel=64)
    weights = init_parameters(autoencoder.build_autoencoder(cfg)[0],
                              gen).state_dict()
    batch = torch.rand(4, 3, 32, 32, generator=gen) * 2 - 1

    def ae_step(dev):
        model = autoencoder.build_autoencoder(cfg, dev)[0]
        model.load_state_dict(weights)
        return _sgd_step(torch, model, autoencoder.make_train_step,
                         batch.to(dev))

    def differ(a, b):   # (loss rel, max grad abs diff)
        return (abs(a[0] - b[0]) / abs(b[0]),
                max((a[1][n] - g).abs().max().item() for n, g in b[1].items()))

    out = {dev: ae_step(dev) for dev in ("cpu", device)}
    loss_rel, grad_err = differ(out[device], out["cpu"])
    log(f"[reference] autoencoder train step, float32 (graphed on the "
        f"card): loss card "
        f"{out[device][0]:.8f} cpu {out['cpu'][0]:.8f} (rel {loss_rel:.2e});"
        f" max |grad card - grad cpu| {grad_err:.3e}")
    if not loss_rel <= 1e-5 or not grad_err <= 1e-5:
        raise SystemExit("card and CPU autoencoder steps differ")
    # the fault the package's setting repairs: the same step with PyTorch's
    # default (cuDNN may use TF32), reported, then TF32 off again
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_loss_rel, tf32_grad_err = differ(ae_step(device), out["cpu"])
    finally:
        full_float32()
    log(f"[reference] the same step with cuDNN's TF32 on (PyTorch's "
        f"default): loss rel {tf32_loss_rel:.2e}, max |grad card - grad cpu| "
        f"{tf32_grad_err:.3e}")

    book = Codebook(patch_dim=(8, 8), image_dim=(32, 32), image_channel=4,
                    num_embeddings=512, init_neighbour_range=256)
    with torch.no_grad():
        book.codebook.normal_(0.0, 0.5, generator=gen)
    latents = torch.randn(8, 4, 32, 32, generator=gen)
    out, tokens = {}, {}
    for dev in ("cpu", device):
        model = Codebook(patch_dim=(8, 8), image_dim=(32, 32),
                         image_channel=4, num_embeddings=512,
                         init_neighbour_range=256, device=dev)
        model.load_state_dict(book.state_dict())
        tokens[dev] = model.get_patches_bmu(latents.to(dev)).cpu()
        out[dev] = _sgd_step(torch, model, codebook.make_train_step,
                             latents.to(dev), 256.0)
    patches = patchify(latents, patch_dim=(8, 8)).reshape(-1, 256)
    agree = near_tie_agreement(patches, book.codebook.detach(),
                               tokens[device], tokens["cpu"])
    loss_rel = abs(out[device][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_err = (out[device][1]["codebook"]
                - out["cpu"][1]["codebook"]).abs().max().item()
    log(f"[reference] codebook train step (M 128, D 256, K 512), float32, "
        f"graphed on the card: "
        f"BMU indices differ on {agree['differing_rows']} rows, all within "
        f"the {agree['near_tie_rows']} near-tie rows; loss card "
        f"{out[device][0]:.8f} cpu {out['cpu'][0]:.8f} (rel {loss_rel:.2e});"
        f" max |grad card - grad cpu| {grad_err:.3e}")
    if not loss_rel <= 1e-5:
        raise SystemExit("card and CPU codebook losses differ")

    ok, ckpt = load_model(paths["decoder"])
    assert ok
    encoder, _ = fmap.encoder_from_checkpoint(ckpt, torch.device("cpu"),
                                              logging=_no_skips)
    rows = Manifest(paths["fmaps"]).rows[:8]
    images = ImageDataset(paths["dataset"], return_filepaths=True)
    by_path = {images.manifest[i]["image_fpath"]: i
               for i in range(len(images))}
    x = np.stack([images[by_path[r["image_path"]]][0] for r in rows])
    with torch.inference_mode():
        want = encoder(torch.from_numpy(x)).numpy()
    got = np.stack([np.load(r["fmap_path"]) for r in rows])
    err = float(np.abs(got - want).max())
    log(f"[reference] full-width encoder latents of 8 images: card (fmap "
        f"CLI) against CPU max abs diff {err:.3e}")
    if not err <= 1e-5:
        raise SystemExit(f"card and CPU latents differ: {err}")
    return {"latent_max_abs_err": err, "autoencoder_tf32_on": {
        "loss_rel": tf32_loss_rel, "grad_max_abs_err": tf32_grad_err}}


# ---------------------------------------------------------------------------
# phase 11: the parallel forms over torch.distributed
# ---------------------------------------------------------------------------

# a rank of a phase 11 (b) / (c) world: train.run (its steps timed, the
# full parameters saved by rank 0 after the run) or generate.run (the
# tokens saved by rank 0), the launch counts printed last
PARALLEL_RUNNER = """
import json, sys, time
import torch
import chip_smoke
kind, args, out_path = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
steps, made = [], {}
def sync():
    chip_smoke.synchronize(torch, args["device"])
if kind == "train":
    from qaig_tpu_torch.train import transformer as train
    make = train.make_train_step
    def timed_make(*a, **kw):
        made["parallel"] = kw.get("parallel")
        step = make(*a, **kw)
        def timed(*s):
            sync()
            t0 = time.perf_counter()
            out = step(*s)
            sync()
            steps.append(time.perf_counter() - t0)
            return out
        return timed
    train.make_train_step = timed_make
else:
    from qaig_tpu_torch.infer import decode, generate
    if args.pop("greedy", False):
        decode._categorical = lambda logits, draw: logits.argmax(dim=-1)
sync()
chip_smoke.reset_launches()
t0 = time.perf_counter()
try:
    result = (train.run(args) if kind == "train" else generate.run(args))
except ValueError as e:
    print("REFUSED " + str(e), flush=True)
    sys.exit(3)
sync()
seconds = time.perf_counter() - t0
launches = chip_smoke.read_launches()
if kind == "train":
    result = made["parallel"].full_params(result)
if args["process_id"] == 0:
    torch.save(result, out_path)
from qaig_tpu_torch.parallel import comm
comm.shutdown()
print("PARALLEL " + json.dumps({"launches": launches, "step_s": steps,
                                "seconds": seconds}), flush=True)
"""

# the forms of 11 (b) left out, each with the collective gloo refuses on
# CUDA tensors
LEFT_OUT_SHARED_CARD = {
    "pp2": "send/recv: gloo's TCP transport aborts the process on a CUDA "
           "tensor (\"writev ... Bad address\"); the pipeline raises when "
           "ranks share a card"}


def free_address():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{sock.getsockname()[1]}"


def phase6_args(workdir, kind, out_dir, **extra):
    """Phase 6's ``train.run`` arguments (``kind``: bf16 or float32)."""
    ckpt = Path(workdir) / "models_checkpoint"
    # both precisions' runs read the same seeded latents
    args = {"device": "cuda",
            "dataset_path": str(TRAINED["bf16"]["manifest"]),
            "decoder_path": str(ckpt / "decoder.pt"),
            "lr_codebook_path": str(ckpt / "codebook_2.pt"),
            "hr_codebook_path": str(ckpt / "codebook_3.pt"),
            "config_path": str(Path(__file__).resolve().parent
                               / TRAIN["config"]),
            "out_dir": str(out_dir), "bf16": kind == "bf16",
            "batch_size": TRAIN["batch"], "max_steps": TRAIN["steps"],
            "checkpoint_step": TRAIN["checkpoint_step"],
            "test_num_sample": TRAIN["previews"], "seed": 0}
    args.update(extra)
    return args


def _metrics_losses(out_dir):
    return [json.loads(line)["ce_loss"] for line in
            (Path(out_dir) / "metrics.jsonl").read_text().splitlines()]


def graph_statements(runner):
    """The DOT statements of ``runner``'s one graph (captured under
    :func:`dumpable_graphs`)."""
    graph, = runner.graphs.values()
    with tempfile.TemporaryDirectory(prefix="qaig_graph_") as tmp:
        path = Path(tmp) / "graph.dot"
        graph.graph.debug_dump(str(path))
        return path.read_text().split("];")


def _memcpy_nodes(statements, src, dst):
    """MEMCPY nodes from ``src`` to ``dst`` (device pointers)."""
    s, d = f"0x{src:016X}", f"0x{dst:016X}"
    return sum("MEMCPY" in st and s in st and d in st
               and st.index(s) < st.index(d) for st in statements)


# phase 11 (a)'s clip: far above the global norm of the gradients of a
# cross-entropy near log(513) (well under 100 at phase 6's widths)
GRAD_CLIP = 1e6


def run_nccl_one_rank(torch, workdir, device="cuda"):
    """Phase 11 (a): phase 6's bf16 run through ``--multihost
    --num-processes 1`` (NCCL, groups of one rank), plain and with
    ``--zero-opt --grad-clip``; previews off and one checkpoint (step 0,
    written in the background), which change no step, and a clip far
    above the gradients' global norm, which scales them by exactly 1 but
    puts the clip's all-reduce over all ranks in the captured step.
    Losses and parameters must be bit-equal to phase 6's; the train
    step's graph must hold NCCL's nodes as predicted for one rank: NCCL
    runs an in-place all-reduce as no node unless it scales, so the
    gradients' mean (ReduceOp.AVG) is its ``oneRankReduce`` kernel and
    the clip's sum is none; a reduce-scatter and an all-gather are copies
    (MEMCPY nodes between the ZeRO buffers).  Leaves the process group
    at the end."""
    from qaig_tpu_torch.parallel import comm
    from qaig_tpu_torch.train import transformer as train
    ref = TRAINED["bf16"]
    address = free_address()
    enc_dec = _enc_dec()
    out = {}
    for zero in (False, True):
        name = "zero" if zero else "plain"
        made, step_s = [], []
        make = train.make_train_step

        def timed_make(*a, **kw):
            step = make(*a, **kw)
            made.append((step, kw["parallel"]))

            def timed(*args):
                synchronize(torch, device)
                t0 = time.perf_counter()
                loss = step(*args)
                synchronize(torch, device)
                step_s.append(time.perf_counter() - t0)
                return loss
            timed.runner = step.runner
            return timed

        out_dir = Path(workdir) / "parallel" / f"nccl_{name}"
        train.make_train_step = timed_make
        try:
            synchronize(torch, device)
            reset_launches()
            with dumpable_graphs(torch):
                model = train.run(phase6_args(
                    workdir, "bf16", out_dir, multihost=True,
                    coordinator_address=address, num_processes=1,
                    process_id=0, zero_opt=zero, skip_preview=True,
                    checkpoint_step=1000, grad_clip=GRAD_CLIP if zero
                    else None,
                    checkpoint_backend="pickle-async"))
            synchronize(torch, device)
            launches = read_launches()
        finally:
            train.make_train_step = make
        losses = _metrics_losses(out_dir)
        diff = max((a - b).abs().max().item()
                   for a, b in zip(model.parameters(), ref["params"]))
        if losses != ref["losses"] or diff != 0:
            raise SystemExit(f"11 (a) {name}: NCCL at one rank is not "
                             f"bit-equal to phase 6: losses {losses} "
                             f"against {ref['losses']}, max |param diff| "
                             f"{diff:.3e}")
        (step, par), = made
        statements = graph_statements(step.runner)
        nodes = {"one_rank_reduce": sum("oneRankReduce" in st
                                        for st in statements)}
        want = {"one_rank_reduce": 0 if zero else 1}
        if zero:
            nodes["reduce_scatter_memcpy"] = _memcpy_nodes(
                statements, par.send.data_ptr(), par.shard_grad.data_ptr())
            nodes["all_gather_memcpy"] = _memcpy_nodes(
                statements, par.master.data_ptr(), par.gathered.data_ptr())
            want.update(reduce_scatter_memcpy=1, all_gather_memcpy=1)
        if nodes != want:
            raise SystemExit(f"11 (a) {name}: the train step's graph holds "
                             f"NCCL nodes {nodes}, predicted {want}")
        steps = TRAIN["steps"]
        predicted = {"flash_attention": enc_dec * steps,
                     "flash_attention_backward": enc_dec * steps,
                     "fused_bmu": 2 * steps}
        _check_launches(f"11 (a) {name}", launches, predicted)
        mean = _step_mean(step_s)
        out[name] = {"step_s": step_s, "step_mean_s": mean,
                     "phase6_step_mean_s": ref["step_mean_s"],
                     "graph_nccl_nodes": nodes, "launches": launches}
        log(f"[parallel] 11 (a) {name}: NCCL at one rank (groups of one "
            f"rank), {steps} graphed bf16 steps"
            + (f" with --grad-clip {GRAD_CLIP:g}" if zero else "")
            + " bit-equal to phase 6 "
            f"(losses and parameters); the graph's NCCL nodes {nodes}; "
            f"seconds per step {mean:.4f} against phase 6's "
            f"{ref['step_mean_s']:.4f}; launches {launches}")
    comm.shutdown()
    return out


def _enc_dec():
    cfg = json.loads((Path(__file__).resolve().parent
                      / TRAIN["config"]).read_text())
    return cfg["num_enc_layers"] + cfg["num_dec_layers"]


def _check_launches(what, launches, predicted):
    for name, n in predicted.items():
        if launches[name] != n:
            raise SystemExit(f"{what}: launched {name} {launches[name]} "
                             f"times, predicted {n}")


def _start_world(workdir, name, kind, args):
    """The 2 processes of one phase 11 world (``PARALLEL_RUNNER``)."""
    import os
    repo = Path(__file__).resolve().parent
    address = free_address()
    out_path = Path(workdir) / "parallel" / f"{name}.pt"
    return [subprocess.Popen(
        [sys.executable, "-c", PARALLEL_RUNNER, kind, json.dumps(dict(
            args, multihost=True, coordinator_address=address,
            num_processes=2, process_id=rank)), str(out_path)],
        cwd=repo, env=dict(os.environ), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)], out_path


def _finish_world(name, procs, refused=False):
    """Each rank's printed result; ``refused``: both ranks must exit with
    the runner's refusal (a ValueError) instead."""
    results = []
    for proc in procs:
        text, _ = proc.communicate(timeout=900)
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("PARALLEL ", "REFUSED "))]
        if refused:
            if proc.returncode != 3 or not lines:
                raise SystemExit(f"{name}: expected a refusal, got exit "
                                 f"{proc.returncode}:\n{text[-4000:]}")
            results.append(lines[-1][len("REFUSED "):])
            continue
        if proc.returncode != 0 or not lines or \
                not lines[-1].startswith("PARALLEL "):
            raise SystemExit(f"{name} failed (exit {proc.returncode}):\n"
                             + text[-4000:])
        if "gloo over CUDA tensors" not in text or \
                "Train step: eager" not in text and "train" in name:
            raise SystemExit(f"{name}: the shared-card mode was not logged")
        results.append(json.loads(lines[-1][len("PARALLEL "):]))
    return results


def run_shared_card_training(torch, workdir, device="cuda"):
    """Phase 11 (b): DP 2, TP 2 and DP 2 with ``--zero-opt`` in 2
    processes sharing the card (gloo over CUDA tensors, eager steps), at
    phase 6's widths cut to ``SHALLOW``'s depth (1 encoder, 2 decoder
    layers) in float32, batch 8, 3 steps, previews off, one checkpoint
    written in the background; against a 1-process eager float32 run of
    the same steps (losses rtol 1e-5, parameters atol 1e-5: the CPU
    tests' tolerances).  PP 2 is left out (``LEFT_OUT_SHARED_CARD``); its
    refusal is checked.  Launches of A, A' and BMU per rank predicted from
    the control flow."""
    import numpy as np
    from qaig_tpu_torch.train import transformer as train
    steps = 3
    root = Path(workdir) / "parallel"
    config = json.loads((Path(__file__).resolve().parent
                         / TRAIN["config"]).read_text())
    config.update(num_enc_layers=SHALLOW[0], num_dec_layers=SHALLOW[1])
    shallow_config = root / "transformer_cascade_shallow.json"
    shallow_config.write_text(json.dumps(config))
    extra = dict(max_steps=steps, skip_preview=True, checkpoint_step=1000,
                 checkpoint_backend="pickle-async",
                 config_path=str(shallow_config))
    forms = {"dp2": {}, "tp2": {"num_model_shards": 2},
             "zero2": {"zero_opt": True}}
    worlds = {name: _start_world(workdir, f"b_{name}", "train", phase6_args(
        workdir, "float32", root / f"b_{name}", **extra, **opts))
        for name, opts in forms.items()}
    pp = _start_world(workdir, "b_pp2", "train", phase6_args(
        workdir, "float32", root / "b_pp2", num_pipeline_stages=2,
        **extra))
    for name, reason in LEFT_OUT_SHARED_CARD.items():
        log(f"[parallel] 11 (b) left out: {name} ({reason})")

    # the 1-process eager reference, while the worlds run
    make = train.make_train_step
    train.make_train_step = lambda *a, **kw: make(*a, graphed=False, **kw)
    try:
        ref_dir = root / "b_reference"
        model = train.run(phase6_args(workdir, "float32", ref_dir, **extra))
    finally:
        train.make_train_step = make
    ref_losses = _metrics_losses(ref_dir)
    ref_params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del model

    refusal = _finish_world("b_pp2", pp[0], refused=True)
    if not all("share a card" in r for r in refusal):
        raise SystemExit(f"11 (b) pp2: unexpected refusal {refusal}")
    out = {"left_out": LEFT_OUT_SHARED_CARD, "pp2_refusal": refusal[0],
           "reference_losses": ref_losses}
    enc_dec = sum(SHALLOW)
    predicted = {"flash_attention": enc_dec * steps,
                 "flash_attention_backward": enc_dec * steps,
                 "flash_attention_backward_calls": enc_dec * steps,
                 "fused_bmu": 2 * steps, "fused_bmu_small_m": 0}
    for name, (procs, out_path) in worlds.items():
        ranks = _finish_world(f"b_{name}", procs)
        for rank, result in enumerate(ranks):
            _check_launches(f"11 (b) {name} rank {rank}",
                            result["launches"], predicted)
        losses = _metrics_losses(root / f"b_{name}")
        if not np.allclose(losses, ref_losses, rtol=1e-5, atol=0):
            raise SystemExit(f"11 (b) {name}: losses {losses} against the "
                             f"1-process run's {ref_losses}")
        full = torch.load(out_path, map_location="cpu")
        diffs = {n: (full[n] - p).abs().max().item()
                 for n, p in ref_params.items()}
        worst = max(diffs, key=diffs.get)
        over = sum(int(((full[n] - p).abs() > 1e-5).sum())
                   for n, p in ref_params.items())
        out[name] = {"losses": losses, "max_param_diff": diffs[worst],
                     "worst_param": worst, "elements_over_1e-5": over,
                     "step_s": [r["step_s"] for r in ranks],
                     "launches": ranks[0]["launches"]}
        log(f"[parallel] 11 (b) {name}: 2 ranks on one card (gloo, eager "
            f"float32; the three worlds, the refused pp2 world and the "
            f"reference ran at the same time): losses {[round(x, 6) for x in losses]} against "
            f"{[round(x, 6) for x in ref_losses]}; max |param diff| "
            f"{diffs[worst]:.3e} ({worst}; {over} elements over 1e-5); "
            f"seconds per step by rank "
            f"{[[round(x, 3) for x in r['step_s']] for r in ranks]}; "
            f"launches per rank as predicted {predicted}")
        if diffs[worst] > 1e-5:
            raise SystemExit(f"11 (b) {name}: parameters {diffs[worst]:.3e} "
                             f"from the 1-process run's ({worst})")
    return out


def _generation_args(paths, device):
    config_path, decoder_path, _ = paths
    return {"device": device, "config_path": str(config_path),
            "decoder_path": str(decoder_path), "num_images": 8, "seed": 0,
            "fused": False}


def start_sharded_generation(workdir, paths, device="cuda"):
    """Phase 11 (c)'s two worlds, started (they run beside 11 (b)'s)."""
    root = Path(workdir) / "parallel"
    args = _generation_args(paths, device)
    return {
        "data2": _start_world(workdir, "c_data2", "generate", dict(
            args, out_dir=str(root / "c_data2"))),
        "tp2": _start_world(workdir, "c_tp2", "generate", dict(
            args, out_dir=str(root / "c_tp2"), num_model_shards=2,
            greedy=True))}


def run_sharded_generation(torch, workdir, paths, worlds, device="cuda"):
    """Phase 11 (c): ``generate.run`` on the cascade ``paths``
    (``SHALLOW``), 8 images, dispatched, in 2 processes sharing the card
    (``worlds``, :func:`start_sharded_generation`): data 2 (each rank 4
    images, its rows of every draw), whose tokens must equal the
    1-process dispatched run's; and ``--num-model-shards 2`` at greedy,
    whose tokens are held to the 1-process greedy run's (equal, or the
    first token that differs reported).  Float32: bf16 products change
    with the batch's composition (phase 7 reports it), float32 ones do
    not."""
    from qaig_tpu_torch.infer import decode, generate
    root = Path(workdir) / "parallel"
    args = _generation_args(paths, device)
    ref = {}
    categorical = decode._categorical
    for name, greedy in (("sampled", False), ("greedy", True)):
        if greedy:
            decode._categorical = lambda logits, draw: logits.argmax(dim=-1)
        try:
            ref[name] = generate.run(dict(
                args, out_dir=str(root / f"c_reference_{name}"))).cpu()
        finally:
            decode._categorical = categorical
    out = {}
    for name, (procs, out_path) in worlds.items():
        ranks = _finish_world(f"c_{name}", procs)
        tokens = torch.load(out_path, map_location="cpu")
        want = ref["greedy" if name == "tp2" else "sampled"]
        differ = (tokens != want).nonzero()
        first = None if len(differ) == 0 else [int(i) for i in differ[0]]
        for rank, result in enumerate(ranks):
            if result["launches"]["shared_prefix_attention_fused_t"] <= 0 \
                    or result["launches"]["flash_attention"] <= 0:
                raise SystemExit(f"11 (c) {name} rank {rank} launched no "
                                 f"decode or full-sequence attention")
        out[name] = {"equal": first is None, "first_difference": first,
                     "differing_tokens": len(differ),
                     "seconds": [r["seconds"] for r in ranks],
                     "launches": ranks[0]["launches"]}
        log(f"[parallel] 11 (c) {name}: 2 ranks on one card (both worlds, "
            f"11 (b)'s and the references ran at the same time), 8 images "
            f"dispatched in {[round(r['seconds'], 3) for r in ranks]} s; "
            f"tokens {'equal to' if first is None else 'differ from'} the "
            f"1-process run's"
            + ("" if first is None else
               f" ({len(differ)} tokens; first at image {first[0]}, "
               f"position {first[1]})")
            + f"; launches rank 0 {ranks[0]['launches']}")
        if name == "data2" and first is not None:
            raise SystemExit("11 (c): data-sharded tokens differ from the "
                             "1-process run's")
    return out


def run_async_checkpoint(torch, workdir, device="cuda"):
    """Phase 11 (d): phase 6's bf16 run with ``--checkpoint-backend
    pickle-async`` (previews off, which change no step or file): the
    checkpoint steps' seconds (snapshot and return;
    the first also allocates the pinned buffers, and the second starts
    after the first write ended, as when checkpoints lie further apart
    than a write takes) against phase 6's synchronous ones, the seconds
    of the steps that overlap a write, the files byte-equal to phase 6's,
    and a resume from the background-written ``model_3.pt``."""
    import shutil
    from qaig_tpu_torch.train import transformer as train
    from qaig_tpu_torch.utils import checkpoint
    ref = TRAINED["bf16"]
    root = Path(workdir) / "parallel" / "d_async"
    step_s, overlap, save_s, join_s, write_wait_s = [], [], [], [], []
    make, save = train.make_train_step, train.save_checkpoint
    wait = checkpoint.wait_pending_saves

    def timed_wait(*a, **kw):   # a save joining the write in flight
        t0 = time.perf_counter()
        ok = wait(*a, **kw)
        join_s[-1] += time.perf_counter() - t0
        return ok

    def timed_make(*a, **kw):
        step = make(*a, **kw)

        def timed(*args):
            overlap.append(bool(checkpoint.pending_paths()))
            synchronize(torch, device)
            t0 = time.perf_counter()
            loss = step(*args)
            synchronize(torch, device)
            step_s.append(time.perf_counter() - t0)
            return loss
        timed.runner = step.runner
        return timed

    def timed_save(*a, **kw):
        if save_s:
            # as in a run whose checkpoints lie further apart than a write
            # takes: the write in flight ends before the next save starts
            t0 = time.perf_counter()
            wait()
            write_wait_s.append(time.perf_counter() - t0)
        synchronize(torch, device)
        join_s.append(0.0)
        t0 = time.perf_counter()
        status = save(*a, **kw)
        save_s.append(time.perf_counter() - t0)
        return status

    train.make_train_step, train.save_checkpoint = timed_make, timed_save
    checkpoint.wait_pending_saves = timed_wait
    try:
        train.run(phase6_args(workdir, "bf16", root, skip_preview=True,
                              checkpoint_backend="pickle-async"))
    finally:
        train.make_train_step, train.save_checkpoint = make, save
        checkpoint.wait_pending_saves = wait
    if _metrics_losses(root) != ref["losses"]:
        raise SystemExit("11 (d): the pickle-async run's losses differ "
                         "from phase 6's")
    for n in range(0, TRAIN["steps"], TRAIN["checkpoint_step"]):
        name = f"models_checkpoint/model_{n}.pt"
        if (root / name).read_bytes() != \
                (ref["out_dir"] / name).read_bytes():
            raise SystemExit(f"11 (d): {name} written in the background "
                             f"differs from phase 6's synchronous file")
    overlapped = [s for s, o in zip(step_s, overlap) if o]
    if not overlapped:
        raise SystemExit("11 (d): no step overlapped a background write")
    resumed = root.parent / "d_resumed"
    shutil.copytree(root / "models_checkpoint",
                    resumed / "models_checkpoint")
    (resumed / "models_checkpoint" / "model_0.pt").unlink()
    train.run(phase6_args(workdir, "bf16", resumed, auto_resume=True,
                          max_steps=TRAIN["steps"] + 2, skip_preview=True))
    log_text = (resumed / "Quantized Transformer.log").read_text()
    resumed_losses = _metrics_losses(resumed)
    if "Resuming at global step 4." not in log_text or \
            "Could not restore" in log_text or len(resumed_losses) != 4:
        raise SystemExit("11 (d): the resume from the background-written "
                         "model_3.pt failed")
    sync_s = TRAINED["bf16"]["save_s"]
    out = {"save_s": save_s, "join_s": join_s, "sync_save_s": sync_s,
           "write_wait_s": write_wait_s, "step_s": step_s,
           "overlapping_step_s": overlapped,
           "other_step_s": [s for s, o in zip(step_s[1:], overlap[1:])
                            if not o],
           "resumed_losses": resumed_losses}
    log(f"[parallel] 11 (d) pickle-async: checkpoint steps "
        f"{[round(x, 3) for x in save_s]} s (the first allocates the pinned "
        f"buffers; joining a write in flight "
        f"{[round(x, 3) for x in join_s]} s) against phase 6's synchronous "
        f"{[round(x, 3) for x in sync_s]} s; the first write went on "
        f"{[round(x, 3) for x in write_wait_s]} s past step "
        f"{TRAIN['checkpoint_step'] - 1}; "
        f"steps overlapping a write {[round(x, 4) for x in overlapped]} s, "
        f"the others (after step 0) "
        f"{[round(x, 4) for x in out['other_step_s']]} s, phase 6's "
        f"(synchronous saves) {ref['step_mean_s']:.4f} s a step; the files "
        f"byte-equal to phase 6's; resumed at step 4 from model_3.pt, "
        f"losses {[round(x, 4) for x in resumed_losses]}")
    return out


def run_parallel_path(torch, workdir, paths, device="cuda"):
    """Phase 11: (a) NCCL at one rank, (b) 2 ranks sharing the card in
    training, (c) in generation, (d) the background checkpoint write.
    Returns (launches by path, timings)."""
    (Path(workdir) / "parallel").mkdir()
    timings = {"nccl_one_rank": run_nccl_one_rank(torch, workdir, device)}
    generation_worlds = start_sharded_generation(workdir, paths, device)
    timings["shared_card_training"] = run_shared_card_training(
        torch, workdir, device)
    timings["sharded_generation"] = run_sharded_generation(
        torch, workdir, paths, generation_worlds, device)
    timings["async_checkpoint"] = run_async_checkpoint(torch, workdir,
                                                       device)
    launches = {f"parallel_nccl_{k}": v["launches"]
                for k, v in timings["nccl_one_rank"].items()}
    for key, form in (("shared_card_training", "train"),
                      ("sharded_generation", "generate")):
        for name, v in timings[key].items():
            if isinstance(v, dict) and "launches" in v:
                launches[f"parallel_{form}_{name}"] = v["launches"]
    return launches, timings


# ---------------------------------------------------------------------------
# phase 12: serving over several cards in one process
# ---------------------------------------------------------------------------

def cascade_launches(enc=FULL["enc_layers"], dec=FULL["dec_layers"]):
    """Launches of kernels A and B per call of FULL's cascade (its beam
    plan and window) at ``enc`` / ``dec`` layers, from the engine's control
    flow, the same at any batch size: A for each stage's encoder layers
    and its prefill's decoder layers, and for every windowed step after
    the window fills (all decoder layers but the last, which reads one
    query); B for every cached rollout step of every decoder layer
    (:func:`expected_decode_launches`).  FULL's: A 37, B 2345."""
    a = 0
    for i in range(3):
        window = FULL["sliding"].get(i)
        windowed = 0 if window is None else max(
            0, 1 + seq_len(FULL["patches"][i + 1]) - window)
        a += (0 if i == 0 else enc) + dec + windowed * (dec - 1)
    b = sum(c["slot_minor"] for c in
            expected_decode_launches(False, dec).values())
    return {"flash_attention": a, "shared_prefix_attention_fused_t": b}


# phases 7, 11 (c) and 12 run the cascade at this depth (encoder, decoder
# layers): their paths and kernel checks, at a fraction of FULL's seconds
SHALLOW = (1, 2)


def _mesh_call(torch, pipe, *args, **kw):
    """(seconds to a synchronised end, images, tokens) of one
    ``pipe.generate`` call, the results on the host."""
    synchronize(torch, pipe.device)
    t0 = time.perf_counter()
    images, tokens = pipe.generate(*args, **kw)
    synchronize(torch, pipe.device)
    return time.perf_counter() - t0, images.cpu(), tokens.cpu()


def _first_difference(got, want):
    differ = (got != want).nonzero()
    return None if len(differ) == 0 else [int(i) for i in differ[0]]


def _free(torch):
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_mesh_serve_path(torch, paths, device="cuda"):
    """Phase 12: ``CascadePipeline(mesh=...)`` on the cascade ``paths``
    (``SHALLOW`` in the full run), every mesh repeating the one card
    (``LocalMesh(devices=[cuda:0] * 2)``).  (a) Data 2, bf16, fused (one
    graph a replica), 8 images: each replica's block bit-equal to a
    one-card pipeline's call at batch 4 on the same rows' keys (bf16
    products depend on the batch); twice :func:`cascade_launches` a call,
    cold (two captures) and warm; in float32 the 8 images' tokens equal
    the one-card pipeline's at 8.  (b) Data 1 x model 2, float32, greedy,
    dispatched, 4 images: tokens equal the one-card
    dispatched pipeline's, each MLP shard holds hidden/2 rows of ``l0``,
    :func:`cascade_launches`, ``fused=True`` raises.  (d) ``python -m
    qaig_tpu_torch.cli.serve_generation --bf16 --shard-batch`` as a
    subprocess: ``data=1 x model=1``, a 2-image request's tokens equal a
    one-card bf16 pipeline's; ``--num-model-shards 2`` exits non-zero
    with "must divide the chip count (1)".  (The device guards of the
    kernels need a second card: ``tests/test_torch_port_two_cards.py``.)
    Returns (launches by path, timings)."""
    from qaig_tpu_torch.infer import decode
    from qaig_tpu_torch.infer.pipeline import (CascadePipeline,
                                               derive_row_keys)
    from qaig_tpu_torch.models import core
    from qaig_tpu_torch.parallel.local import LocalMesh

    config_path, decoder_path, _ = paths
    config = json.loads(Path(config_path).read_text())
    card = torch.device(device, 0) if device == "cuda" else \
        torch.device(device)
    shared = "both replicas on one card: no scaling is measured"

    def load(dtype=None, mesh=None):
        return CascadePipeline.from_config(config, decoder_path, device=card,
                                           dtype=dtype, mesh=mesh)

    launches, out = {}, {}
    keys = derive_row_keys(12, 8)
    predicted = {k: 2 * v for k, v in cascade_launches(*SHALLOW).items()}

    # (a) data 2, bf16, fused: cold (two captures), then warm
    pipe = load(torch.bfloat16, LocalMesh(2, 1, [card] * 2))
    reset_launches()
    cold_s, images, tokens = _mesh_call(torch, pipe, 8, row_keys=keys)
    _check_launches("12 (a) cold", read_launches(), predicted)
    reset_launches()
    warm_s, warm_images, warm_tokens = _mesh_call(torch, pipe, 8,
                                                  row_keys=keys)
    launches["serve_mesh_data2"] = read_launches()
    _check_launches("12 (a) warm", launches["serve_mesh_data2"], predicted)
    if not (torch.equal(warm_tokens, tokens)
            and torch.equal(warm_images, images)):
        raise SystemExit("12 (a): a warm replay differs from the first call")
    captures = [[r._graphs.graphs[(4, None)].capture_s,
                 r._graphs.graphs[(4, None)].instantiate_s]
                for r in pipe.replicas if r._graphs is not None]
    del pipe
    _free(torch)
    one = load(torch.bfloat16)
    for a, b in ((0, 4), (4, 8)):
        _, want_images, want = _mesh_call(torch, one, 4,
                                          row_keys=keys[a:b])
        if not (torch.equal(tokens[a:b], want)
                and torch.equal(images[a:b], want_images)):
            raise SystemExit(
                f"12 (a): replica block {a}:{b} differs from the one-card "
                f"pipeline at batch 4 (first token difference "
                f"{_first_difference(tokens[a:b], want)})")
    _, _, server_want = _mesh_call(torch, one, 2, seed=5)   # for (d)
    del one
    _free(torch)
    out["data2_bf16"] = {"cold_s": cold_s, "warm_s": warm_s,
                         "capture_instantiate_s": captures}
    log(f"[mesh] 12 (a) data 2 (cuda:0 twice), bf16, fused, 8 images: "
        f"first call {cold_s:.3f} s (capture / instantiation per replica "
        f"{[[round(x, 3) for x in c] for c in captures]} s), warm "
        f"{warm_s:.3f} s ({shared}); each block bit-equal to the one-card "
        f"pipeline at batch 4; launches "
        f"{ {k: launches['serve_mesh_data2'][k] for k in predicted} }")

    plain = load()
    pipe = load(None, LocalMesh(2, 1, [card] * 2))
    mesh_s, _, tokens = _mesh_call(torch, pipe, 8, row_keys=keys)
    plain_s, _, want = _mesh_call(torch, plain, 8, row_keys=keys)
    if not torch.equal(tokens, want):
        raise SystemExit(f"12 (a) float32: data-2 tokens differ from the "
                         f"one-card pipeline's (first "
                         f"{_first_difference(tokens, want)})")
    del pipe
    _free(torch)
    out["data2_f32"] = {"first_call_s": mesh_s, "one_card_first_call_s":
                        plain_s}
    log(f"[mesh] 12 (a) float32: data 2 tokens of 8 images equal the "
        f"one-card pipeline's (first calls, captures included: "
        f"{mesh_s:.3f} s against {plain_s:.3f} s)")

    # (b) data 1 x model 2, float32, greedy, dispatched
    pipe = load(None, LocalMesh(1, 2, [card] * 2))
    for stage in pipe.stages:
        model = stage.engine.model
        for m in model.modules():
            if isinstance(m, core.MLP2):
                rows = [m.l0.weight.shape[0]] + [
                    p.l0.weight.shape[0] for p in m.tp.parts]
                if rows != [model.cfg.hidden_dim // 2] * 2:
                    raise SystemExit(f"12 (b): MLP shards hold {rows} rows "
                                     f"of l0, not hidden/2 each")
    try:
        pipe.generate(4, seed=3, fused=True)
        raise SystemExit("12 (b): fused=True with a model axis did not "
                         "raise")
    except ValueError:
        pass
    sample = decode._categorical
    decode._categorical = lambda logits, draw: logits.argmax(dim=-1)
    seconds = {"tp2": [], "one_card": []}
    want = None
    try:
        # in turns (TP, one card, one card, TP): the first dispatched
        # call of a shape pays one-off library set-up
        for turn in range(4):
            tp = turn in (0, 3)
            if turn == 0:
                reset_launches()
            s, _, tokens = _mesh_call(torch, pipe if tp else plain, 4,
                                      seed=3, fused=False)
            if turn == 0:
                launches["serve_mesh_tp2"] = read_launches()
            seconds["tp2" if tp else "one_card"].append(s)
            if want is None:
                want = tokens
            first = _first_difference(tokens, want)
            if first is not None:
                raise SystemExit(
                    f"12 (b): {'TP 2' if tp else 'one-card'} greedy tokens "
                    f"differ from the first TP 2 call's, first at image "
                    f"{first[0]}, position {first[1]}")
    finally:
        decode._categorical = sample
    _check_launches("12 (b)", launches["serve_mesh_tp2"],
                    cascade_launches(*SHALLOW))
    del pipe, plain
    _free(torch)
    out["tp2_f32_greedy"] = seconds
    log(f"[mesh] 12 (b) data 1 x model 2 (cuda:0 twice), float32, greedy, "
        f"dispatched, 4 images, in turns: TP 2 "
        f"{[round(s, 3) for s in seconds['tp2']]} s, one card unsharded "
        f"{[round(s, 3) for s in seconds['one_card']]} s ({shared}); "
        f"tokens equal; shards of hidden/2 rows; fused=True raises; "
        f"launches (the first TP call) "
        f"{ {k: launches['serve_mesh_tp2'][k] for k in cascade_launches()} }")

    # (d) the server CLI
    out["server"] = run_mesh_server(torch, config_path, decoder_path,
                                    card, server_want)
    return launches, out


def run_mesh_server(torch, config_path, decoder_path, card, want):
    """Phase 12 (d): the serve CLI with ``--shard-batch`` (one card:
    ``data=1 x model=1``), a 2-image request of seed 5 against ``want``,
    ``/metrics``' mesh, SIGTERM; then ``--num-model-shards 2``, which
    must exit non-zero with the "must divide" message."""
    import os
    import signal
    import threading
    import urllib.request
    repo = Path(__file__).resolve().parent
    base_argv = [sys.executable, "-m", "qaig_tpu_torch.cli.serve_generation",
                 "--device", card.type, "--bf16", "--port", "0",
                 "--config-path", str(config_path), "--decoder-path",
                 str(decoder_path)]
    proc = subprocess.Popen(
        base_argv + ["--shard-batch", "--warmup-batch", "1"], cwd=repo,
        env=dict(os.environ), text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    lines = []
    pump = threading.Thread(target=lambda: lines.extend(proc.stdout),
                            daemon=True)
    pump.start()

    def fault(msg):
        return SystemExit(f"12 (d): {msg}\nserver output:\n"
                          + "".join(lines)[-3000:])

    try:
        t0 = time.perf_counter()
        while not any("serving on http" in ln for ln in lines):
            if proc.poll() is not None:
                raise fault("the server exited early")
            if time.perf_counter() - t0 > 300:
                raise fault("the server never came up")
            time.sleep(0.2)
        start_s = time.perf_counter() - t0
        if not any(ln.strip() == "serving over 1 chips: data=1 x model=1"
                   for ln in lines):
            raise fault("no 'serving over 1 chips: data=1 x model=1' line")
        serving = next(ln for ln in lines if "serving on http" in ln)
        base = f"http://127.0.0.1:{int(serving.rsplit(':', 1)[1])}"
        t0 = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(
                base + "/generate", data=json.dumps(
                    {"num_images": 2, "seed": 5}).encode()),
                timeout=600) as resp:
            body = json.loads(resp.read())
        request_s = time.perf_counter() - t0
        if not torch.equal(torch.as_tensor(body["tokens"]), want):
            raise fault("the 2-image request's tokens differ from the "
                        "one-card bf16 pipeline's")
        with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
            mesh = json.loads(resp.read())["mesh"]
        if mesh != {"data": 1, "model": 1, "devices": [[str(card)]]}:
            raise fault(f"/metrics reports the mesh {mesh}")
        proc.send_signal(signal.SIGTERM)
        if proc.wait(timeout=120) != 0:
            raise fault("the server did not drain cleanly")
        pump.join(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    refused = subprocess.run(base_argv + ["--num-model-shards", "2"],
                             cwd=repo, env=dict(os.environ), text=True,
                             capture_output=True, timeout=300)
    message = "--num-model-shards 2 must divide the chip count (1)"
    if refused.returncode == 0 or message not in refused.stderr:
        raise SystemExit(f"12 (d): --num-model-shards 2 on one card: exit "
                         f"{refused.returncode}, stderr "
                         f"{refused.stderr[-2000:]}")
    log(f"[mesh] 12 (d) serve CLI --bf16 --shard-batch: data=1 x model=1, "
        f"up in {start_s:.1f} s (load, warm-up at batch 1), a 2-image "
        f"request {request_s:.3f} s (its first call: a capture) with the "
        f"one-card pipeline's tokens, /metrics mesh {mesh}; "
        f"--num-model-shards 2: exit {refused.returncode}, '{message}'")
    return {"start_s": start_s, "request_s": request_s, "mesh": mesh}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

KERNELS = {
    "flash_attention": {
        "source": "qaig_tpu_torch/csrc/flash_attention.cu",
        "replaces": "qaig_tpu/ops/flash_attention.py:116",
        "summary": {"S": 256, "causal": True, "dtype": "bf16"}},
    "shared_prefix_attention_fused_t": {
        "source": "qaig_tpu_torch/csrc/decode_attention.cu",
        "replaces": "qaig_tpu/ops/decode_attention.py:155",
        "summary": {"N": 16, "S": 256, "bw": 8, "index0": 256,
                    "dtype": "bf16"}},
    "shared_prefix_attention_fused_int8": {
        "source": "qaig_tpu_torch/csrc/decode_attention.cu",
        "replaces": "qaig_tpu/ops/decode_attention.py:414",
        "summary": {"N": 16, "S": 256, "bw": 8, "index0": 256,
                    "dtype": "bf16"}},
    "shared_prefix_attention_fused_flat": {
        "source": "qaig_tpu_torch/csrc/decode_attention_flat.cu",
        "replaces": "qaig_tpu/ops/decode_attention.py:326",
        "summary": {"S": 256, "bw": 8, "index0": 256, "dtype": "bf16"}},
    "shared_prefix_attention_fused_flat_int8": {
        "source": "qaig_tpu_torch/csrc/decode_attention_flat.cu",
        "replaces": "qaig_tpu/ops/decode_attention.py:326",
        "summary": {"S": 256, "bw": 8, "index0": 256, "dtype": "bf16"}},
    "flash_attention_backward": {
        "source": "qaig_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "qaig_tpu/ops/flash_attention.py:85",
        "summary": {"H": TRAIN_H, "S": 256, "causal": True,
                    "dtype": "bf16"}},
    "fused_bmu": {
        "source": "qaig_tpu_torch/csrc/bmu.cu",
        "replaces": "qaig_tpu/ops/bmu.py:39",
        "summary": {"M": 2048, "D": 16, "K": 512}},
    "mlp2_fused": {
        "source": "qaig_tpu_torch/csrc/mlp2_fused.cu",
        "replaces": "scripts/probe_mlp_fused.py:58",
        "summary": {"N": 8192, "S": 3}},
}


CHECKS = {"decode": check_decode, "flash": check_flash,
          "flash_train": check_flash_train, "flash_wide": check_flash_wide,
          "bmu": check_bmu, "flat": check_flat, "mlp": check_mlp}


# ---------------------------------------------------------------------------
# phase 13: the data plane
# ---------------------------------------------------------------------------

DATA = dict(images=64, side=128, batch=8, steps=6, checkpoint_step=3,
            # each row's filter, cycled: mostly Paeth and Average, as
            # libpng's adaptive choice leaves photographs, and the others
            filters=(4, 3, 4, 4, 3, 1, 4, 3, 2, 4, 3, 0),
            eval_batch=8, eval_images=16, gen_images=4, gen_seed=3)


def write_filtered_images(root, n, side, seed=1):
    """``n`` seeded side x side x 3 PNGs with filtered rows
    (``DATA["filters"]``) and their manifest; returns (manifest, paths)."""
    import numpy as np
    from qaig_tpu_torch.data.manifest import write_manifest
    from qaig_tpu_torch.utils import png
    folder = Path(root) / "images"
    folder.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side] / side
    paths = []
    for i in range(n):
        phase = rng.uniform(0, 2 * np.pi, 3)
        base = 127.5 + 100 * np.sin(2 * np.pi * (xx[..., None] * phase / 3
                                                 + yy[..., None]) + phase)
        pixels = np.clip(base + rng.normal(0, 10, (side, side, 3)), 0, 255)
        path = folder / f"{i}.png"
        path.write_bytes(png.encode(pixels.astype(np.uint8),
                                    DATA["filters"]))
        paths.append(str(path))
    manifest = write_manifest(Path(root) / "dataset.json", [
        {"image_fpath": p, "labels": []} for p in paths])
    return manifest, paths


def _scaled_weights(tree, factor):
    """A checkpoint's parameter tree with every array of more than one
    dimension (the convolutions' and dense layers' kernels) times
    ``factor``."""
    import numpy as np
    if isinstance(tree, dict):
        return {k: _scaled_weights(v, factor) for k, v in tree.items()}
    if np.ndim(tree) > 1:
        return np.asarray(tree) * np.asarray(factor, np.asarray(tree).dtype)
    return tree


# runs the feature-map CLI's main() in a fresh process and splits its
# seconds: process start (interpreter, imports, CUDA set-up; from the
# parent's clock at the process's start), checkpoint load, decoding (the
# items' decode time summed over the loader's threads, and the time the
# encoding loop waited for a batch), device work (the encoder's forward,
# synchronised) and the rest (host copies, file writes, the manifest)
FMAP_RUNNER = """
import json, sys, threading, time
t_parent = float(sys.argv[1])
import torch
import chip_smoke
from qaig_tpu_torch.cli import generate_fmap_dataset as cli
from qaig_tpu_torch.data import image_dataset
from qaig_tpu_torch.train import fmap
argv = sys.argv[2:]
device = argv[argv.index("--device") + 1]
torch.zeros(1, device=device)
chip_smoke.synchronize(torch, device)
split = {"process_start_s": time.time() - t_parent, "read_s": 0.0,
         "restore_s": 0.0, "decode_items_s": 0.0, "decode_wait_s": 0.0,
         "device_s": 0.0}
lock = threading.Lock()
def sync():
    chip_smoke.synchronize(torch, device)
load_model, build = fmap.load_model, fmap.encoder_from_checkpoint
def timed_load(*a, **kw):
    t0 = time.perf_counter()
    out = load_model(*a, **kw)
    split["read_s"] += time.perf_counter() - t0
    return out
def timed_build(*a, **kw):
    t0 = time.perf_counter()
    model, cfg = build(*a, **kw)
    sync()
    split["restore_s"] += time.perf_counter() - t0
    forward = model.forward
    def timed_forward(x):
        sync()
        t0 = time.perf_counter()
        y = forward(x)
        sync()
        split["device_s"] += time.perf_counter() - t0
        return y
    model.forward = timed_forward
    return model, cfg
getitem = image_dataset.ImageDataset.__getitem__
def timed_getitem(self, index):
    t0 = time.perf_counter()
    out = getitem(self, index)
    with lock:
        split["decode_items_s"] += time.perf_counter() - t0
    return out
batches = fmap.DataLoader.__iter__
def timed_iter(self):
    it = batches(self)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            split["decode_wait_s"] += time.perf_counter() - t0
        yield item
fmap.load_model, fmap.encoder_from_checkpoint = timed_load, timed_build
image_dataset.ImageDataset.__getitem__ = timed_getitem
fmap.DataLoader.__iter__ = timed_iter
t0 = time.perf_counter()
cli.main(argv)
sync()
split["main_s"] = time.perf_counter() - t0
split["load_s"] = split["read_s"] + split["restore_s"]
split["rest_s"] = split["main_s"] - split["load_s"] - \\
    split["decode_wait_s"] - split["device_s"]
print("SPLIT " + json.dumps(split))
"""


def run_fmap_split(argv, device="cuda"):
    """``generate_fmap_dataset``'s seconds, split (``FMAP_RUNNER``)."""
    import os
    repo = Path(__file__).resolve().parent
    start = time.time()
    proc = subprocess.run(
        [sys.executable, "-c", FMAP_RUNNER, repr(start),
         *[str(a) for a in argv], "--device", device],
        cwd=repo, env=dict(os.environ), capture_output=True, text=True,
        timeout=600)
    total = time.time() - start
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("SPLIT ")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"generate_fmap_dataset failed (exit "
                         f"{proc.returncode}):\n"
                         + (proc.stdout + proc.stderr)[-4000:])
    split = json.loads(lines[-1][len("SPLIT "):])
    split["total_s"] = total
    return split


def run_data_path(torch, workdir, front_paths, front_timings, cascade_paths,
                  device="cuda"):
    """Phase 13: the data plane (``qaig_tpu_torch/native``).  (a) 64
    seeded 128x128x3 PNGs with filtered rows (``DATA["filters"]``) decoded
    item by item by the plain decoder (``utils/png.py``) and in batches of
    8 by ``native.load_image_batch``: bit-equal slabs, seconds per image
    of both, and the ``DataLoader``'s batches per second at batch 8.  (b)
    ``train_autoencoder`` (6 bf16 steps at batch 8) and
    ``generate_fmap_dataset`` over those files as subprocesses: seconds
    per step beside phase 9's, and feature maps' seconds split
    (``FMAP_RUNNER``).  (c) ``eval_quality`` on the card over phase 9's
    codebooks and 16 of the files, with a copy of phase 9's autoencoder
    whose weights are 3x: one BMU launch a batch a codebook (the LR
    codebook's in the small-M geometry), PSNRs within 1e-3 dB of a CPU
    run, and the codebook PSNRs more than 0.01 dB from the
    reconstruction's, so that a wrong code would show.  (d)
    ``generate.run`` with ``devices=[cuda:0, cuda:0]`` (data 2), float32,
    greedy, dispatched by default, 4 images: tokens equal to the one-card
    run's, the mesh line printed, A 2 x 37 and B 2 x 2345, ``fused=True``
    raises.  Returns (launches by path, timings)."""
    import contextlib
    import io
    import numpy as np
    from qaig_tpu_torch import native
    from qaig_tpu_torch.data.image_dataset import ImageDataset
    from qaig_tpu_torch.data.loader import DataLoader
    from qaig_tpu_torch.infer import decode, generate
    from qaig_tpu_torch.scripts import eval_quality
    from qaig_tpu_torch.utils import png

    d = DATA
    repo = Path(__file__).resolve().parent
    root = Path(workdir) / "data"
    launches, out = {}, {}

    # (a) decoding
    t0 = time.perf_counter()
    dataset, paths = write_filtered_images(root, d["images"], d["side"])
    write_s = time.perf_counter() - t0
    try:
        import PIL
        pil = f"PIL {PIL.__version__} imports (not used: png.encode " \
              f"writes the files)"
    except ImportError:
        pil = "PIL does not import (png.encode writes the files)"
    t0 = time.perf_counter()
    for name in ("image_loader", "npy_loader"):
        native.build(name)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = np.stack([np.ascontiguousarray(
        ((png.read_bgr(p).astype(np.float32) - 127.5) / 127.5)
        .transpose(2, 0, 1)) for p in paths])
    plain_s = time.perf_counter() - t0
    b = d["batch"]
    t0 = time.perf_counter()
    slab = np.concatenate([native.load_image_batch(paths[i:i + b], d["side"],
                                                   d["side"])
                           for i in range(0, len(paths), b)])
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    items = np.stack([native.load_image(p) for p in paths])
    item_s = time.perf_counter() - t0
    if not (np.array_equal(slab, plain) and np.array_equal(items, plain)):
        raise SystemExit(f"13 (a): the native decoder differs from the plain "
                         f"one on {int((slab != plain).sum())} (batch) / "
                         f"{int((items != plain).sum())} (item) values")
    loader = DataLoader(ImageDataset(dataset), batch_size=b, shuffle=False)
    t0 = time.perf_counter()
    batches = list(loader)
    loader_s = time.perf_counter() - t0
    if not np.array_equal(np.concatenate(batches), plain):
        raise SystemExit("13 (a): the loader's batches differ from the plain "
                         "decoder's")
    n = len(paths)
    out["decode"] = {
        "plain_s_per_image": plain_s / n, "native_batch_s_per_image":
        batch_s / n, "native_item_s_per_image": item_s / n,
        "loader_batches_per_s": len(batches) / loader_s,
        "write_s": write_s, "build_s": build_s}
    log(f"[data] 13 (a) {n} PNGs of {d['side']}x{d['side']}x3, rows "
        f"filtered {d['filters']} (cycled), written in {write_s:.1f} s; "
        f"{pil}; native library built in {build_s:.1f} s (g++)")
    log(f"[data] 13 (a) decode, host seconds per image: plain (utils/png.py, "
        f"one by one) {plain_s / n:.5f}, native in batches of {b} "
        f"{batch_s / n:.6f} ({plain_s / batch_s:.1f}x), native one by one "
        f"{item_s / n:.6f}; slabs bit-equal; DataLoader at batch {b} "
        f"(load_batch): {len(batches) / loader_s:.1f} batches/s")

    # (b) the front of the pipeline over the filtered files
    common = ["--batch-size", b, "--max-steps", d["steps"],
              "--checkpoint-step", d["checkpoint_step"]]
    ae_out = root / "ae_bf16"
    res = run_cli("train_autoencoder", "autoencoder", [
        "--dataset-path", dataset, "--config-path", repo / FRONT[
            "autoencoder"], "--out-dir", ae_out, *common, "--bf16"], device)
    losses = _finite_losses(ae_out, d["steps"])
    step = _step_mean(res["step_s"])
    phase9 = front_timings["autoencoder_bf16"]["step_mean_s"]
    out["autoencoder_bf16"] = {"step_s": res["step_s"], "step_mean_s": step,
                               "phase9_step_mean_s": phase9,
                               "seconds": res["seconds"], "losses": losses}
    log(f"[data] 13 (b) train_autoencoder bf16 over the filtered PNGs: "
        f"{d['steps']} graphed steps at batch {b}, {step:.4f} s per step "
        f"(steps 1-5; all {[round(x, 4) for x in res['step_s']]}) against "
        f"phase 9's {phase9:.4f} s over unfiltered PNGs in this run (PERF "
        f"§5: 0.0080 s); {res['seconds']:.3f} s for main(); losses "
        f"{[round(x, 5) for x in losses]}")
    split = run_fmap_split([
        "--dataset-path", dataset, "--model-path", front_paths["decoder"],
        "--out-dir", root / "fmaps", "--batch-size", b], device)
    out["fmap_split"] = split
    log(f"[data] 13 (b) generate_fmap_dataset over the {n} filtered PNGs in "
        f"{split['total_s']:.3f} s: process start (interpreter, imports, "
        f"CUDA set-up) {split['process_start_s']:.3f} s, checkpoint load "
        f"{split['load_s']:.3f} s (read and unpickle "
        f"{split['read_s']:.3f} s, the encoder built and restored on the "
        f"card {split['restore_s']:.3f} s), decoding "
        f"{split['decode_wait_s']:.3f} s "
        f"waited for ({split['decode_items_s']:.3f} s of item decodes on "
        f"the loader's threads), device work {split['device_s']:.3f} s, the "
        f"rest (host copies, file writes) {split['rest_s']:.3f} s")

    # (c) eval_quality on the card, then on the CPU, over a copy of phase
    # 9's autoencoder whose weights are 3x (the CPU test's scale): phase
    # 9's own decodes every latent to nearly one image, so its codebook
    # PSNRs sit ~3e-7 dB from its reconstruction's and no wrong code could
    # show; the copy's stand apart
    from qaig_tpu_torch.utils.checkpoint import load_model, save_model
    _, ckpt = load_model(front_paths["decoder"])
    if not save_model(dict(ckpt, model=_scaled_weights(ckpt["model"], 3)),
                      root / "ae_x3", "model.pt"):
        raise SystemExit("13 (c): the scaled autoencoder was not written")
    model = root / "ae_x3" / "models_checkpoint" / "model.pt"
    books = front_paths["books"]
    argv = [str(a) for a in (
        "--dataset-path", dataset, "--model-path", model,
        "--codebook-path", books["hr"], "--codebook-path", books["lr"],
        "--batch-size", d["eval_batch"], "--max-images", d["eval_images"])]
    buf = io.StringIO()
    synchronize(torch, device)
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        card = eval_quality.main(argv + ["--device", device])
    synchronize(torch, device)
    card_s = time.perf_counter() - t0
    launches["eval_quality"] = read_launches()
    printed = buf.getvalue().strip().splitlines()[-1]
    n_batches = -(-d["eval_images"] // d["eval_batch"])
    _check_launches("13 (c) eval_quality", launches["eval_quality"], {
        "fused_bmu": 2 * n_batches, "fused_bmu_small_m": n_batches})
    t0 = time.perf_counter()
    cpu = eval_quality.evaluate(dataset, model, [books["hr"], books["lr"]],
                                d["eval_batch"], d["eval_images"], "cpu")
    cpu_s = time.perf_counter() - t0
    diffs = {"recon": abs(card["psnr_recon_db"] - cpu["psnr_recon_db"])}
    apart = {}
    for key in ("hr", "lr"):
        book = str(books[key])
        diffs[key] = abs(card["psnr_quantized_db"][book]
                         - cpu["psnr_quantized_db"][book])
        apart[key] = min(abs(r["psnr_quantized_db"][book]
                             - r["psnr_recon_db"]) for r in (card, cpu))
    out["eval_quality"] = {"card": card, "cpu": cpu, "abs_diff_db": diffs,
                           "quantized_apart_db": apart, "card_s": card_s,
                           "cpu_s": cpu_s}
    log(f"[data] 13 (c) eval_quality --device cuda over phase 9's "
        f"autoencoder with 3x weights and phase 9's HR / LR codebooks, "
        f"{card['num_images']} images at batch {d['eval_batch']}: {printed} "
        f"in {card_s:.3f} s; fused_bmu launches "
        f"{launches['eval_quality']['fused_bmu']} (one a batch a codebook), "
        f"{launches['eval_quality']['fused_bmu_small_m']} of them small-M "
        f"(the LR codebook's); |card - CPU| in dB "
        f"{ {k: float(f'{v:.2e}') for k, v in diffs.items()} }; |quantized "
        f"- recon| in dB, the smaller of card and CPU "
        f"{ {k: float(f'{v:.4g}') for k, v in apart.items()} } (CPU run "
        f"{cpu_s:.1f} s)")
    if card["num_images"] != d["eval_images"] or \
            max(diffs.values()) > 1e-3:
        raise SystemExit(f"13 (c): eval_quality on the card and on the CPU "
                         f"differ: {diffs}")
    if min(apart.values()) <= 0.01:
        raise SystemExit(f"13 (c): a codebook's PSNR is within 0.01 dB of "
                         f"the reconstruction's ({apart}), so the comparison "
                         f"could not see a wrong code")

    # (d) generate.run over a mesh of cuda:0 twice
    config_path, decoder_path, _ = cascade_paths
    args = {"device": device, "config_path": str(config_path),
            "decoder_path": str(decoder_path), "num_images": d["gen_images"],
            "seed": d["gen_seed"]}
    two = [f"{device}:0"] * 2
    try:
        generate.run(dict(args, fused=True, out_dir=str(root / "gen_f")),
                     devices=two)
        raise SystemExit("13 (d): fused=True on a 2-card mesh did not raise")
    except ValueError as e:
        refusal = str(e)
    plan = [("one_card", two[:1], {"fused": False}, 1),
            ("data2", two, {}, 2)]
    sample = decode._categorical
    decode._categorical = lambda logits, draw: logits.argmax(dim=-1)
    runs = {}
    try:
        for name, devices, extra, _ in plan:
            buf = io.StringIO()
            synchronize(torch, device)
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                tokens = generate.run(dict(args, **extra, out_dir=str(
                    root / f"gen_{name}")), devices=devices)
            synchronize(torch, device)
            runs[name] = {"tokens": tokens.cpu(), "log": buf.getvalue(),
                          "seconds": time.perf_counter() - t0,
                          "launches": read_launches()}
    finally:
        decode._categorical = sample
    launches["generate_mesh"] = runs["data2"]["launches"]
    want = runs["one_card"]["tokens"]
    for name, _, _, n_data in plan:
        got, log_text = runs[name]["tokens"], runs[name]["log"]
        first = _first_difference(got, want)
        if got.shape != (d["gen_images"], want.shape[1]) or \
                first is not None:
            raise SystemExit(f"13 (d) {name}: tokens differ from the "
                             f"one-card run's (first at {first})")
        _check_launches(f"13 (d) {name}", runs[name]["launches"],
                        {k: n_data * v
                         for k, v in cascade_launches().items()})
        line = f"Generation mesh: data={n_data} x model=1"
        if line not in log_text or "Fused" in log_text:
            raise SystemExit(f"13 (d) {name}: no '{line}' line, or not "
                             f"dispatched:\n{log_text}")
    out["generate_mesh"] = {name: {"seconds": r["seconds"]}
                            for name, r in runs.items()}
    seconds = {name: round(r["seconds"], 3) for name, r in runs.items()}
    log(f"[data] 13 (d) generate.run, float32, greedy, {d['gen_images']} "
        f"images: devices=[{two[0]}, {two[0]}] (data 2, dispatched by "
        f"default, stages read once) gives the one-card run's tokens; "
        f"'{runs['data2']['log'].splitlines()[0]}' printed; seconds "
        f"{seconds} (both replicas on one card, in turn: no scaling is "
        f"measured); launches "
        f"{ {k: launches['generate_mesh'][k] for k in cascade_launches()} }; "
        f"fused=True raises: {refusal}")
    return launches, out


# ---------------------------------------------------------------------------
# phase 14: the quality ledger at full width
# ---------------------------------------------------------------------------

QUALITY = dict(
    # quality_run's default scale table (128x128 images, AE 256 -> 512, K
    # 512, in_dim 512 / hidden 2048 / 7 + 5 layers / 64 heads, window 256,
    # the reference beam plan) at its default batches, cut in steps and
    # images: 2 checkpoints an autoencoder or codebook (the trajectories
    # need 2), 1 a transformer; 64 training images (one codebook batch).
    # 40 autoencoder steps: after 4 it decodes every latent to one grey
    # image, and a preview equal to its ground truth has an infinite PSNR
    num_images=64, eval_images=8, ae_steps=40, cb_steps=40, tf_steps=2,
    ckpt_every=20, gen_images=2, sweep_images=2, temperature=2.0,
    ab_steps=2, compare_steps=3, compare_batch=8,
    # reserved memory after any later stage may exceed the first
    # transformer stage's by this much (segment rounding): well under the
    # ~64 MiB of cuBLAS workspace a graphed trainer left behind when each
    # graph runner captured on a stream of its own
    memory_margin=24 << 20)


def quality_argv(out, device="cuda"):
    q = QUALITY
    return ["--out-dir", str(out), "--device", device,
            "--num-images", str(q["num_images"]),
            "--eval-images", str(q["eval_images"]),
            "--ae-steps", str(q["ae_steps"]), "--cb-steps", str(q["cb_steps"]),
            "--tf-steps", str(q["tf_steps"]),
            "--ckpt-every", str(q["ckpt_every"]),
            "--gen-images", str(q["gen_images"])]


def predicted_quality_launches(report, sweep_settings):
    """BMU, A, A' and B launches of phase 14's run, from its control flow:

    - BMU: a codebook trainer one a step and one a checkpoint's preview;
      ``QualityEval`` one a batch (of 32) for each evaluated codebook
      checkpoint and pruned codebook; pruning one a batch of
      ``--cb-batch``; a transformer trainer two a step (the LR and HR
      tokens) and three a checkpoint's preview;
    - A: a transformer step twice per encoder and decoder layer (the
      forward, and its recompute under remat in the backward); a preview
      the encoder's layers, the prefill's and, past the window, the
      decoder's but the last; each cascade call (generation and every
      sweep setting) :func:`cascade_launches`;
    - A': a transformer step once per layer;
    - B: :func:`cascade_launches` per cascade call; the previews decode
      single-path (``decode_step``), which does not run B.

    The A/B trains the base stage twice, with one checkpoint each."""
    q = QUALITY
    stages = report["stages"]
    per_eval = -(-q["eval_images"] // 32)
    cb_ckpts = len(range(0, q["cb_steps"], q["ckpt_every"]))
    n_cb = len([k for k in stages if k.startswith("codebook_")])
    n_books = n_cb + len(report.get("experiments", {}))
    bmu = (n_books * (q["cb_steps"] + cb_ckpts)
           + per_eval * (n_books * cb_ckpts + n_cb)
           + n_cb * -(-q["num_images"] // 64))
    a = a_bwd = 0

    def transformer(enc, dec, windowed, steps, ckpts):
        return (2 * steps + 3 * ckpts,
                2 * (enc + dec) * steps
                + ckpts * (enc + dec + windowed * (dec - 1)),
                (enc + dec) * steps)

    runs = []
    tf_ckpts = len(range(0, q["tf_steps"], q["ckpt_every"]))
    for name in (k for k in stages if k.startswith("transformer_")):
        cfg = json.loads(Path(stages[name]["checkpoint"]).parent.parent
                         .with_suffix(".json").read_text())
        enc = cfg.get("num_enc_layers", 0)
        windowed = max(0, 1 + seq_len(FULL["patches"][-1])
                       - cfg["sliding_window"]) \
            if cfg["use_sliding_window"] else 0
        runs.append((enc, cfg["num_dec_layers"], windowed, q["tf_steps"],
                     tf_ckpts))
        if name == "transformer_base":
            base = (enc, cfg["num_dec_layers"], 0, q["ab_steps"], 1)
    runs += [base, base]
    for run in runs:
        b, fa, fb = transformer(*run)
        bmu, a, a_bwd = bmu + b, a + fa, a_bwd + fb
    calls = 1 + sweep_settings
    cascade = cascade_launches()
    return {"fused_bmu": bmu,
            "flash_attention": a + calls * cascade["flash_attention"],
            "flash_attention_backward": a_bwd,
            "flash_attention_backward_calls": a_bwd,
            "shared_prefix_attention_fused_t":
                calls * cascade["shared_prefix_attention_fused_t"]}


def check_quality_report(report, out):
    """``tests/test_quality_run.py``'s schema asserts over the report, and
    every PSNR and CE value finite."""
    import math
    stages = report["stages"]

    def need(ok, what):
        if not ok:
            raise SystemExit(f"14: quality.json: {what}")

    for key in ("autoencoder", "transformer_base", "generation"):
        need(key in stages, f"no {key} stage")
    need(any(k.startswith("codebook_") for k in stages), "no codebook")
    need(any(k.startswith("transformer_casc") for k in stages),
         "no cascade transformer")
    ae = stages["autoencoder"]
    need(len(ae["psnr_trajectory"]) >= 2 and len(ae["loss_curve"]) >= 2,
         "autoencoder trajectory or loss curve shorter than 2")
    values = [p["psnr_recon_db"] for p in ae["psnr_trajectory"]]
    for key, st in stages.items():
        if key.startswith("codebook_"):
            pr = st["prune"]
            need(len(st["psnr_trajectory"]) >= 2, f"{key} trajectory")
            need(1 <= pr["kept"] <= pr["of"]
                 and Path(pr["checkpoint"]).exists(), f"{key} prune")
            values += [p["psnr_quantized_db"] for p in st["psnr_trajectory"]]
            values += [pr["psnr_quantized_db_before"],
                       pr["psnr_quantized_db_after"]]
        if key.startswith("transformer_"):
            need(len(st["loss_curve"]) >= 2, f"{key} loss curve")
            need(st["ce_max_last_half"] is not None, f"{key} max CE")
            need(isinstance(st["preview_psnr"], list), f"{key} preview")
            values += [v for _, v in st["loss_curve"]]
            values += [st["ce_max_last_half"]]
            values += [p["psnr_db"] for p in st["preview_psnr"]]
    exp = next(iter(report["experiments"].values()))
    need(len(exp["psnr_trajectory"]) >= 2
         and exp["num_embeddings"] == 2 * exp["baseline_k"],
         "K experiment")
    values += [p["psnr_quantized_db"] for p in exp["psnr_trajectory"]]
    last = [k for k in stages if k.startswith("transformer_casc")][-1]
    need(stages[last]["stability"]["ema_decay"] > 0
         and stages[last]["stability"]["grad_clip"] > 0,
         f"{last} not under EMA and clipping")
    need(Path(stages["generation"]["grid"]).exists()
         and (out / "grids" / "generated_final.jpg").exists()
         and (out / "grids" / "dataset_sample.png").exists(), "grids")
    bad = [v for v in values if not isinstance(v, float)
           or not math.isfinite(v)]
    need(not bad, f"values not finite: {bad}")
    return len(values)


def last_stage_steps(torch, out, device="cuda"):
    """Phase 14's graphed-against-eager steps: the quality run's last
    cascade stage (at full width ``tf_casc2.json``: encoder, window 256)
    with remat, EMA 0.999 and clip 1.0 in float32, over the pruned
    codebooks ``gen.json`` gives it and the first feature maps of the run.
    The compared parameters are the model's and the EMA's.  Returns
    (``build(graphed, capturable) -> (step, model and EMA)``,
    ``inputs(i)``, steps)."""
    import copy
    import numpy as np
    from qaig_tpu_torch.models.core import init_parameters
    from qaig_tpu_torch.models.transformer import Transformer
    from qaig_tpu_torch.train import common, optim
    from qaig_tpu_torch.train import transformer as train
    from qaig_tpu_torch.utils.checkpoint import load_model

    q = QUALITY
    stage = json.loads((out / "gen.json").read_text())
    stage = stage[max(stage, key=int)]
    config = json.loads(Path(stage["model_path"]).parent.parent
                        .with_suffix(".json").read_text())
    lr_cb, hr_cb = (common.codebook_from_checkpoint(
        load_model(stage[key])[1], torch.device(device))
        for key in ("lr_codebook_path", "hr_codebook_path"))
    lr_k, hr_k = lr_cb.num_embeddings, hr_cb.num_embeddings
    cfg = train.build_transformer_config(config, False, lr_k, hr_k,
                                         use_remat=True)
    rows = json.loads((out / "fmaps" / "all_dataset.json").read_text())
    paths = [r["fmap_path"] for r in rows["_default"].values()]
    steps, batch = q["compare_steps"], q["compare_batch"]
    batches = [torch.from_numpy(np.stack([
        np.load(p) for p in paths[i * batch:(i + 1) * batch]])).to(device)
        for i in range(steps)]

    def build(graphed, capturable):
        model = init_parameters(Transformer(cfg, device=device),
                                torch.Generator(device=device).manual_seed(0))
        ema = copy.deepcopy(model).requires_grad_(False)
        optimizer, scheduler = optim.make_adam(
            model.parameters(), config["model_lr"], 50_000,
            capturable=capturable)
        step = train.make_train_step(
            model, optimizer, lr_cb, hr_cb, False, lr_k, hr_k,
            config.get("sliding_window"), scheduler=scheduler, grad_clip=1.0,
            ema_model=ema, ema_decay=0.999, graphed=graphed)
        windows = torch.Generator().manual_seed(0)

        def windowed(x):
            return step(x, windows)
        windowed.runner = step.runner
        return windowed, torch.nn.ModuleList([model, ema])

    return build, lambda i: (batches[i],), steps


def run_quality_path(torch, workdir, device="cuda"):
    """Phase 14: ``qaig_tpu_torch.scripts.quality_run``'s ``main`` in this
    process at full width with ``QUALITY``'s steps, then
    ``sampling_sweep`` (one temperature) and ``quality_bf16_ab`` on its
    run, and ``render_quality`` over it: the report's schema and finite
    values, BMU / A / A' / B launched as :func:`predicted_quality_launches`
    says, the reserved memory after every later stage within
    ``memory_margin`` of the first transformer stage's (each trainer's
    graphs and pools let go).  Then the last cascade stage's kind (remat,
    EMA, clip) graphed against eager at full width, bit for bit
    (:func:`graphed_against_eager`).  Returns (launches, timings)."""
    from qaig_tpu_torch.scripts import (quality_bf16_ab, quality_run,
                                        render_quality, sampling_sweep)
    q = QUALITY
    out = Path(workdir) / "quality"
    card = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device(device)
    timings = {}
    _free(torch)
    reset_launches()
    t0 = time.perf_counter()
    report = quality_run.main(quality_argv(out, device))
    timings["quality_run_s"] = time.perf_counter() - t0
    memory = list(report["memory"])
    t0 = time.perf_counter()
    sweep = sampling_sweep.main([
        "--qrun-dir", str(out), "--num-images", str(q["sweep_images"]),
        "--temperatures", f"{q['temperature']:g}", "--device", device])
    timings["sweep_s"] = time.perf_counter() - t0

    def after(what):
        held = quality_run.release(card)
        if held is not None:
            memory.append({"after": what, "allocated": held[0],
                           "reserved": held[1]})
    after("sweep")
    t0 = time.perf_counter()
    ab = quality_bf16_ab.main([
        "--qrun-dir", str(out), "--steps", str(q["ab_steps"]), "--device",
        device])
    timings["ab_s"] = time.perf_counter() - t0
    after("bf16_ab")
    launches = read_launches()

    n_values = check_quality_report(report, out)
    if set(sweep["settings"]) != {"config", "single_path",
                                  f"beams_t{q['temperature']:g}"} or \
            not all(0 <= r["unique_frac"] <= 1
                    for r in sweep["settings"].values()):
        raise SystemExit(f"14: sweep settings {sweep['settings']}")
    import math
    if not all(math.isfinite(ab[t]["final_ce"]) for t in ("fp32", "bf16")):
        raise SystemExit(f"14: the A/B's CE not finite: {ab}")
    render_quality.main(["--report", str(out / "quality.json"), "--doc",
                         str(out / "QUALITY_TORCH.md"), "--grids-dir",
                         str(out / "docs")])
    predicted = predicted_quality_launches(report, len(sweep["settings"]))
    for name, n in predicted.items():
        if n <= 0 or launches[name] != n:
            raise SystemExit(f"14: the quality path launched {name} "
                             f"{launches[name]} times, predicted {n}")
    first = next((m for m in memory if m["after"] == "transformer_base"),
                 None)
    if first is None and device == "cuda":
        raise SystemExit(f"14: no memory reading after transformer_base: "
                         f"{memory}")
    later = memory[memory.index(first) + 1:] if first else []
    grown = [m for m in later
             if m["reserved"] > first["reserved"] + q["memory_margin"]]
    mib = {m["after"]: (round(m["allocated"] / 2**20, 1),
                        round(m["reserved"] / 2**20, 1)) for m in memory}
    if grown:
        raise SystemExit(f"14: reserved memory grew past the first "
                         f"transformer stage's + {q['memory_margin'] >> 20} "
                         f"MiB: (allocated, reserved) MiB after each stage "
                         f"{mib}")
    timings.update(stage_seconds=report["stage_seconds"], memory_mib=mib,
                   values_checked=n_values)
    log(f"[quality] 14 quality_run at full width "
        f"({' '.join(quality_argv(out)[2:])}): "
        f"{timings['quality_run_s']:.1f} s, stage seconds "
        f"{report['stage_seconds']}; sampling_sweep ({len(sweep['settings'])} "
        f"settings, {q['sweep_images']} images) {timings['sweep_s']:.1f} s; "
        f"quality_bf16_ab ({q['ab_steps']} steps) {timings['ab_s']:.1f} s; "
        f"schema as tests/test_quality_run.py, {n_values} PSNR/CE values "
        f"finite; rendered; launches as predicted "
        f"{ {k: launches[k] for k in predicted} }")
    log(f"[quality] 14 (allocated, reserved) MiB after each stage: {mib}; "
        f"none past the first transformer stage's reserved + "
        f"{q['memory_margin'] >> 20} MiB")
    _free(torch)
    timings["compare"] = graphed_against_eager(
        torch, "quality casc2 float32 (remat, EMA 0.999, clip 1.0)",
        *last_stage_steps(torch, out, device), device)
    return launches, timings


def repeat_paths(torch, runs):
    """``--repeat-paths``: the generation and training main paths only,
    ``runs`` times each in turns after one untimed warm-up run of each, in
    one process on one cascade.  Prints the seconds of each
    ``generate.run`` (8 images) and each run's mean seconds per train step
    (steps 1-5) as one JSON line."""
    import shutil
    phase_build()
    out = {"generate_s": [], "train_step_s": []}
    with tempfile.TemporaryDirectory(prefix="qaig_chip_smoke_") as workdir:
        paths = write_full_cascade(torch, workdir, 0)
        for i in range(runs + 1):
            for sub in ("out", "train"):
                shutil.rmtree(Path(workdir) / sub, ignore_errors=True)
            _, gen, _ = run_main_path(torch, workdir, paths)
            _, train = run_train_path(torch, workdir)
            if i:
                out["generate_s"].append(gen["run_s"])
                out["train_step_s"].append(train["step_mean_s"])
    print(json.dumps({"repeat_paths": out}), flush=True)


START = time.perf_counter()
PHASE_SECONDS = {}


@contextlib.contextmanager
def phase(name):
    """Time a phase's wall seconds and print them on their own line."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0
        log(f"[seconds] phase {name}: {PHASE_SECONDS[name]:.1f} s")


def kernels_line(records, launches_by_path):
    """One entry per kernel: the summary shape's times, the worst error
    over every shape, and the launches summed over the main paths (each
    path's count beside it)."""
    out = []
    for name, meta in KERNELS.items():
        mine = [r for r in records if r["name"] == name]
        summary = next(r for r in mine if all(
            r["shape"].get(k) == v for k, v in meta["summary"].items()))
        by_path = {path: counts[name]
                   for path, counts in launches_by_path.items()}
        out.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": summary["ms"], "plain_ms": summary["plain_ms"],
            "bound_ms": summary["bound_ms"],
            "bound_by": summary["bound_by"],
            "library_ms": summary["library_ms"]})
        if "library_chain_ms" in summary:
            out[-1]["library_chain_ms"] = summary["library_chain_ms"]
    return {"kernels": out}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json-out", type=Path, default=None)
    parser.add_argument("--profile", action="store_true",
                        help="also profile a stage-2 window and train "
                             "steps 2-5 with torch.profiler (device busy "
                             "share)")
    parser.add_argument("--kernels-only", nargs="?", const=",".join(CHECKS),
                        default=None, metavar="CHECKS",
                        help="phases 1-3 only (comma-separated checks of "
                             f"{', '.join(CHECKS)}; all by default): print "
                             "each record as a JSON line, no main paths and "
                             "no result line")
    parser.add_argument("--repeat-paths", type=int, default=0, metavar="N",
                        help="time only the generation and training main "
                             "paths, N runs of each in turns, and print "
                             "their seconds (no kernel checks, no result "
                             "line); run from two checkouts to compare them")
    parser.add_argument("--parallel-only", action="store_true",
                        help="phases 1-2, phase 5's cascade and phase 6's "
                             "bf16 run, then phase 11 (the parallel forms) "
                             "only; prints its timings, no result line")
    parser.add_argument("--serving-only", action="store_true",
                        help="phases 1-2, phase 5's cascade, then phase 12 "
                             "(serving over a mesh) only; prints its "
                             "timings, no result line")
    parser.add_argument("--data-only", action="store_true",
                        help="phases 1-2, phase 5's cascade, phase 9 (the "
                             "front's checkpoints), then phase 13 (the data "
                             "plane) only; prints its timings, no result "
                             "line")
    parser.add_argument("--quality-only", action="store_true",
                        help="phases 1-2, then phase 14 (the quality "
                             "ledger at full width) only; prints its "
                             "timings, no result line")
    args = parser.parse_args()

    import torch
    with phase("1 device"):
        name, smi = phase_device(torch)
    if args.repeat_paths:
        repeat_paths(torch, args.repeat_paths)
        return 0
    if args.parallel_only:
        phase_build()
        with tempfile.TemporaryDirectory(prefix="qaig_chip_smoke_") as wd:
            paths = write_full_cascade(torch, wd, 0)
            run_train_path(torch, wd)
            _, timings = run_parallel_path(torch, wd, write_full_cascade(
                torch, Path(wd) / "shallow", 0, layers=SHALLOW))
        print(json.dumps({"parallel": timings}))
        return 0

    if args.serving_only:
        phase_build()
        with tempfile.TemporaryDirectory(prefix="qaig_chip_smoke_") as wd:
            _, timings = run_mesh_serve_path(torch, write_full_cascade(
                torch, wd, 0, layers=SHALLOW))
        print(json.dumps({"mesh": timings}))
        return 0

    if args.quality_only:
        phase_build()
        with tempfile.TemporaryDirectory(prefix="qaig_chip_smoke_") as wd:
            with phase("14 quality"):
                _, timings = run_quality_path(torch, wd)
        print(json.dumps({"quality": timings}, default=str))
        return 0

    if args.data_only:
        phase_build()
        with tempfile.TemporaryDirectory(prefix="qaig_chip_smoke_") as wd:
            paths = write_full_cascade(torch, wd, 0)
            _, front, front_paths = run_front_path(torch, wd)
            with phase("13 data plane"):
                _, timings = run_data_path(torch, wd, front_paths, front,
                                           paths)
        print(json.dumps({"data": timings}, default=str))
        return 0

    with phase("2 build"):
        phase_build()
    timer = Timer(torch)
    records = []
    if args.kernels_only is not None:
        for check in args.kernels_only.split(","):
            CHECKS[check](torch, timer, records)
        for rec in records:
            print(json.dumps({"record": rec}), flush=True)
        return 0
    with phase("3 kernels"):
        for check in CHECKS.values():
            check(torch, timer, records)
    del timer
    with phase("4 reference"):
        for quantized_prefix in (False, True):
            check_reference(torch, quantized_prefix=quantized_prefix)
            check_flat_reference(torch, quantized_prefix=quantized_prefix)
        check_train_reference(torch)
        check_train_reference(torch, bf16=True)
    with tempfile.TemporaryDirectory(prefix="qaig_chip_smoke_") as workdir:
        launches = {}
        with phase("5 generation"):
            t0 = time.perf_counter()
            paths = write_full_cascade(torch, workdir, 0)
            log(f"[main] full-width cascade written in "
                f"{time.perf_counter() - t0:.1f} s")
            launches["generate"], timings, reference = run_main_path(
                torch, workdir, paths, profile=args.profile)
        with phase("5f fused generation"):
            launches["generate_fused"], timings["fused"], fused_ref = \
                run_fused_path(torch, workdir, paths, reference)
        del reference
        with phase("5b flat decode"):
            launches["flat_generate"], timings["flat"] = run_flat_path(
                torch, paths)
        with phase("6 training"):
            launches["train"], timings["train"] = run_train_path(
                torch, workdir, profile=args.profile)
            timings["train"]["compare"] = compare_train_steps(torch, workdir)
            launches["train_f32"], timings["train_f32"] = run_train_path(
                torch, workdir, bf16=False)
            timings["train_f32"]["compare"] = compare_train_steps(
                torch, workdir, bf16=False)
        with phase("7 serving"):
            shallow = write_full_cascade(torch, Path(workdir) / "shallow", 0,
                                         layers=SHALLOW)
            launches["pipeline"], timings["serve"] = run_serve_path(torch,
                                                                    shallow)
        with phase("8 probe"):
            launches["probe"], timings["probe"] = run_probe_path(torch)
        with phase("9 front"):
            front, timings["front"], front_paths = run_front_path(torch,
                                                                  workdir)
            launches.update(front)
        with phase("4d front reference"):
            timings["front"]["reference"] = check_front_reference(
                torch, front_paths)
        with phase("9 (b)-(c) front graphs"):
            timings["front"]["compare"] = compare_front_steps(torch)
            timings["front"]["traced_alone"] = traced_replays_alone(workdir)
        with phase("10 interchange"):
            launches["interchange"], timings["interchange"] = \
                run_interchange_path(torch, workdir, paths, fused_ref)
        with phase("11 parallel"):
            parallel_launches, timings["parallel"] = run_parallel_path(
                torch, workdir, shallow)
            launches.update(parallel_launches)
        with phase("12 serving over a mesh"):
            mesh_launches, timings["mesh"] = run_mesh_serve_path(torch,
                                                                 shallow)
            launches.update(mesh_launches)
        with phase("13 data plane"):
            data_launches, timings["data"] = run_data_path(
                torch, workdir, front_paths, timings["front"], paths)
            launches.update(data_launches)
        with phase("14 quality"):
            launches["quality"], timings["quality"] = run_quality_path(
                torch, workdir)
    timings["phase_s"] = dict(PHASE_SECONDS)
    log(f"[seconds] total: {time.perf_counter() - START:.1f} s (phases "
        f"{ {k: round(v, 1) for k, v in PHASE_SECONDS.items()} })")

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
