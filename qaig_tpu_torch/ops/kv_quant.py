"""int8 KV-cache quantization, per-slot symmetric amax scaling
(counterpart of ``qaig_tpu/ops/kv_quant.py``).

The rollout decode's shared prefix K/V can be stored int8 with one bf16
scale per (image, head, slot).  Caches keep the slot-minor (N, H, dh, S)
layout, so quantization reduces over the dh axis and the scales are
(N, H, S).  The decode attention folds the scales into the float32 scores
and probabilities (``ops/decode_attention.py``); no dequantized copy of the
prefix is written on that path.
"""

import torch

_EPS = 1e-8


def quantize_kv_t(x_t):
    """Slot-minor cache (..., dh, S) float -> (int8 values, (..., S) bf16
    per-slot scales).  Bit-identical to the JAX version: amax/127 in
    float32, round half to even, clip to [-127, 127]."""
    xf = x_t.to(torch.float32)
    amax = xf.abs().amax(dim=-2)                      # (..., S)
    scale = amax / 127.0
    q = torch.clamp(torch.round(xf / torch.clamp(scale[..., None, :],
                                                 min=_EPS)), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv_t(q, scale, dtype=torch.bfloat16):
    """Inverse of :func:`quantize_kv_t` (the legacy rollout path and
    tests; the shared-prefix decode never materializes this)."""
    return q.to(dtype) * scale[..., None, :].to(dtype)


def quantize_caches(caches):
    """Per-layer slot-minor {'k','v'} caches -> int8 + per-slot scales."""
    out = []
    for c in caches:
        k8, ks = quantize_kv_t(c["k"])
        v8, vs = quantize_kv_t(c["v"])
        out.append({"k": k8, "v": v8, "k_scale": ks, "v_scale": vs})
    return out


def dequantize_caches(caches, dtype=torch.bfloat16):
    out = []
    for c in caches:
        if "k_scale" not in c:
            out.append(c)
            continue
        out.append({"k": dequantize_kv_t(c["k"], c["k_scale"], dtype),
                    "v": dequantize_kv_t(c["v"], c["v_scale"], dtype)})
    return out
