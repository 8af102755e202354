"""Fused two-layer MLP kernel against the library's two products, on the
card (the port's counterpart of ``scripts/probe_mlp_fused.py``):

    python -m qaig_tpu_torch.scripts.probe_mlp_fused

At large row counts a decode step is bounded partly by the hidden
activations the two-product form writes to device memory and reads back
(packed QKV at 8192 rows: (8192, 6144) bf16, 100 MB per layer).  The kernel
(``ops/mlp_fused.py``) keeps the hidden on chip.  Shapes: packed QKV (512
-> 3 x 2048 -> 3 x 512, act on the first layer) and FFN (512 -> 2048 ->
512, act on both) at 8192 rows (stage 0) and 1024 (stages 1 and 2), 7
layers, weights from ``np.random.default_rng(0)`` x 0.05 in bf16.

For each row count it prints the kernel chain's 1-layer max error against
the library chain, the hidden-activation traffic the kernel avoids, and
both chains' times: device time from CUDA events over ``reps`` calls after
one warm-up call (host clock on the CPU).  The library chain is the same
arithmetic in PyTorch calls (``F.linear``, silu, ``torch.baddbmm``, i.e.
cuBLAS): a yardstick, not a port.  :func:`main` returns the figures.
"""

import time

import numpy as np
import torch
import torch.nn.functional as F

from qaig_tpu_torch.ops.mlp_fused import mlp2_fused
from qaig_tpu_torch.train import common


def library_chain(x, qkv, ffn):
    """Each layer: the packed QKV and the FFN as two products each, mixed
    back into x (keeps the dependence, same dims)."""
    rows = x.shape[0]
    for (w0, b0, w1, b1), (f0, fb0, f1, fb1) in zip(qkv, ffn):
        s, _, hid = w1.shape
        h = F.silu(F.linear(x, w0, b0)).view(rows, s, hid).transpose(0, 1)
        o = torch.baddbmm(b1[:, None], h, w1.transpose(1, 2))
        g = F.silu(F.linear(F.silu(F.linear(x, f0, fb0)), f1[0], fb1[0]))
        x = (o[0] + o[1] + o[2] + g) * 0.25
    return x


def kernel_chain(x, qkv, ffn):
    """The same chain with each MLP through the fused kernel: two launches
    per layer."""
    for (w0, b0, w1, b1), (f0, fb0, f1, fb1) in zip(qkv, ffn):
        o = mlp2_fused(x, w0, b0, w1, b1, act_last=False)
        g = mlp2_fused(x, f0, fb0, f1, fb1, act_last=True)
        x = (o[0] + o[1] + o[2] + g[0]) * 0.25
    return x


def timed(fn, label, device, reps):
    """Mean ms of ``fn`` over ``reps`` calls after one warm-up call."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / reps
    print(f"{label}: {ms:.3f} ms", flush=True)
    return ms


def make_weights(rng, layers, dim, hidden, device):
    """Per layer the packed QKV and the FFN weights, drawn in the JAX
    probe's shapes and order (w0 (D, S*H), w1 (S, H, D2)) and laid out as
    the port's (w0 (S*H, D), w1 (S, D2, H))."""
    def mk(shape):
        return torch.from_numpy(rng.standard_normal(shape) * 0.05).to(
            device, torch.bfloat16)

    def layer(splits, width):
        w0, b0 = mk((dim, width)), mk((width,))
        w1, b1 = mk((splits, hidden, dim)), mk((splits, dim))
        return (w0.T.contiguous(), b0, w1.transpose(1, 2).contiguous(), b1)

    qkv = [layer(3, 3 * hidden) for _ in range(layers)]
    ffn = [layer(1, hidden) for _ in range(layers)]
    return qkv, ffn


def main(device="cuda", rows=(8192, 1024), layers=7, dim=512, hidden=2048,
         reps=20):
    device = common.select_device(device)
    rng = np.random.default_rng(0)
    results = []
    for n in rows:
        x = torch.from_numpy(rng.standard_normal((n, dim)) * 0.05).to(
            device, torch.bfloat16)
        qkv, ffn = make_weights(rng, layers, dim, hidden, device)

        want = library_chain(x, qkv[:1], ffn[:1])
        got = kernel_chain(x, qkv[:1], ffn[:1])
        err = (want.float() - got.float()).abs().max().item()
        print(f"rows={n}: fused vs library 1-layer max err {err:.5f}",
              flush=True)
        hbm_mb = layers * (n * 3 * hidden + 2 * n * hidden) * 2 / 1e6
        print(f"rows={n}: hidden-activation HBM round-trip avoided "
              f"~{hbm_mb:.0f} MB/chain", flush=True)
        library_ms = timed(lambda: library_chain(x, qkv, ffn),
                           f"library 2-product chain rows={n} x{layers} "
                           f"layers", device, reps)
        kernel_ms = timed(lambda: kernel_chain(x, qkv, ffn),
                          f"fused kernel chain      rows={n} x{layers} "
                          f"layers", device, reps)
        results.append({"rows": n, "layers": layers, "max_err": err,
                        "hbm_mb_avoided": hbm_mb, "library_ms": library_ms,
                        "kernel_ms": kernel_ms})
    return results


if __name__ == "__main__":
    print("device:", torch.cuda.get_device_name(0)
          if torch.cuda.is_available() else "no CUDA device", flush=True)
    main()
