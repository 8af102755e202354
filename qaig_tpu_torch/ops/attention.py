"""Multi-head attention core (counterpart of ``qaig_tpu/ops/attention.py``).

Math of the reference attention: Q/K/V come already projected (N, S, D);
heads are a reshape-split of D, the scale is ``1/sqrt(D/heads)``, causal
and key masks set scores to -inf before a float32 softmax, and there is no
output projection after the heads merge.

Routing (no global switches): :func:`dot_product_attention` sends
self-attention over equal shapes with no key mask and no query offset, at a
head dim the kernel instantiates (``flash_attention.supported``), to
:func:`qaig_tpu_torch.ops.flash_attention.flash_attention`, and
:func:`shared_prefix_attention` always goes to
``qaig_tpu_torch.ops.decode_attention`` (the flat kernel for an
interleaved prefix); those launch their CUDA kernels on
CUDA tensors and run their plain versions on CPU tensors.  The other
functions here are plain tensor products, as they are XLA einsums in the
JAX package.

Decode caches are slot-minor (N, H, dh, S), the JAX package's layout, which
the decode kernel reads directly.
"""

import math

import torch

from qaig_tpu_torch.ops import decode_attention as da
from qaig_tpu_torch.ops import flash_attention as fa

NEG_INF = float("-inf")
_F32 = torch.float32


def split_heads(x, heads):
    """(N, S, D) -> (N, H, S, D/H) (a view)."""
    n, s, d = x.shape
    return x.reshape(n, s, heads, d // heads).transpose(1, 2)


def merge_heads(x):
    """(N, H, S, Dh) -> (N, S, H*Dh)."""
    n, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(n, s, h * dh)


def transpose_heads_t(x_split):
    """Head-split (N, H, S, dh) -> slot-minor cache layout (N, H, dh, S)."""
    return x_split.transpose(2, 3)


def dot_product_attention(q, k, v, heads, causal=False, kv_mask=None,
                          q_offset=None):
    """Scaled dot-product attention over projected tensors.

    q, k, v: (N, Sq, D) / (N, Sk, D) / (N, Sk, D).  ``causal`` with
    ``q_offset`` treats query ``i`` as absolute position ``q_offset + i``;
    ``kv_mask`` (N, Sk) bool masks out False keys.  Returns (N, Sq, D) in
    q's dtype."""
    if fa.supported(q, k, v, heads, causal, kv_mask, q_offset):
        return fa.flash_attention(q, k, v, heads, causal=causal)

    n, sq, d = q.shape
    sk = k.shape[1]
    dh = d // heads
    qh = split_heads(q.to(_F32), heads)
    kh = split_heads(k.to(_F32), heads)
    vh = split_heads(v.to(_F32), heads)
    scores = (qh @ kh.transpose(-1, -2)) * (1.0 / math.sqrt(dh))

    mask = None
    if causal:
        q_pos = torch.arange(sq, device=q.device)
        if q_offset is not None:
            q_pos = q_pos + q_offset
        k_pos = torch.arange(sk, device=q.device)
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None]
    if kv_mask is not None:
        km = kv_mask[:, None, None, :]
        mask = km if mask is None else mask & km
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    out = torch.softmax(scores, dim=-1) @ vh
    return merge_heads(out).to(q.dtype)


def shared_prefix_attention(q, k_shared, v_shared, k_block, v_block,
                            index0, block_index, k_scale=None, v_scale=None):
    """Beam-rollout decode attention over a SHARED prefix cache plus a
    per-rollout block.

    q: (N*B, 1, D), rollouts grouped [n0b0, n0b1, ..., n1b0, ...].
    k_shared, v_shared: (N, H, dh, S) slot-minor prefix (valid slots
      ``< index0``); int8 when ``k_scale``/``v_scale`` (N, H, S) are given.
    k_block, v_block: (N*B, H, bw, dh) segment K/V (valid slots
      ``<= block_index``).
    A 3-D prefix (N, dh, S*H) is the interleaved layout of the engine's
    ``flat_decode`` option (scales (N, S*H)) and goes to the flat kernel.
    Returns (N*B, 1, D)."""
    if k_shared.ndim == 3:
        return da.shared_prefix_attention_fused_flat(
            q, k_shared, v_shared, k_block, v_block, index0, block_index,
            heads=q.shape[2] // k_shared.shape[1], k_scale=k_scale,
            v_scale=v_scale)
    if k_scale is not None:
        return da.shared_prefix_attention_fused_int8(
            q, k_shared, k_scale, v_shared, v_scale, k_block, v_block,
            index0, block_index)
    return da.shared_prefix_attention_fused_t(
        q, k_shared, v_shared, k_block, v_block, index0, block_index)


def shared_cross_attention(q, k_shared, v_shared):
    """Cross-attention where K/V ((N, H, dh, S) slot-minor, all slots
    valid) are shared across B rollouts; q is (N*B, T, D)."""
    nb, t, d = q.shape
    n, heads, dh, s = k_shared.shape
    b = nb // n
    qg = split_heads(q.to(_F32), heads).reshape(n, b, heads, t, dh)
    scores = torch.einsum("nbhqd,nhdk->nbhqk", qg,
                          k_shared.to(_F32)) * (1.0 / math.sqrt(dh))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("nbhqk,nhdk->nbhqd", weights, v_shared.to(_F32))
    return merge_heads(out.reshape(nb, heads, t, dh)).to(q.dtype)


def shared_prefix_block_attention(q, k_shared, v_shared, k_block, v_block):
    """Windowed-decode attention for a per-rollout tail over a window whose
    leading S0 slots are shared across the B rollouts of an image.

    q: (N*B, Tq, D) queries for the last Tq tail slots (tail-aligned).
    k_shared, v_shared: (N, H, S0, dh), all visible to every tail slot.
    k_block, v_block: (N*B, H, T, dh) per-rollout tail K/V (causal).
    Returns (N*B, Tq, D)."""
    nb, tq, d = q.shape
    n, heads, s0, dh = k_shared.shape
    b = nb // n
    t = k_block.shape[2]
    scale = 1.0 / math.sqrt(dh)

    qh = split_heads(q.to(_F32), heads)                   # (N*B, H, Tq, dh)
    qg = qh.reshape(n, b, heads, tq, dh)
    s_shared = torch.einsum("nbhqd,nhkd->nbhqk", qg,
                            k_shared.to(_F32)) * scale
    s_shared = s_shared.reshape(nb, heads, tq, s0)
    s_block = (qh @ k_block.to(_F32).transpose(-1, -2)) * scale
    q_pos = torch.arange(tq, device=q.device) + (t - tq)
    causal = q_pos[:, None] >= torch.arange(t, device=q.device)[None, :]
    s_block = s_block.masked_fill(~causal, NEG_INF)

    weights = torch.softmax(torch.cat([s_shared, s_block], dim=-1), dim=-1)
    w_shared = weights[..., :s0].reshape(n, b, heads, tq, s0)
    out = torch.einsum("nbhqk,nhkd->nbhqd", w_shared,
                       v_shared.to(_F32)).reshape(nb, heads, tq, dh)
    out = out + weights[..., s0:] @ v_block.to(_F32)
    return merge_heads(out).to(q.dtype)


def decode_attention_presplit(q, k_cache, v_cache, kv_mask):
    """Single-token attention against slot-minor head-split caches.

    q: (N, 1, D); k_cache, v_cache: (N, H, dh, S); kv_mask: (N, S) bool,
    True = valid slot.  Returns (N, 1, D)."""
    heads, dh = k_cache.shape[1], k_cache.shape[2]
    qh = split_heads(q.to(_F32), heads)                   # (N, H, 1, dh)
    scores = (qh @ k_cache.to(_F32)) * (1.0 / math.sqrt(dh))
    scores = scores.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = weights @ v_cache.to(_F32).transpose(-1, -2)
    return merge_heads(out).to(q.dtype)
