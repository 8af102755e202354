"""Transformer building blocks: AdaLN-Zero, residual, MLP-projected
attention, FFN (counterpart of ``qaig_tpu/models/blocks.py``).

Architectural quirks kept (they define the checkpoint-compatible function):

* Q/K/V are 2-layer MLPs (in -> hidden, activated -> in), no output
  projection after the head merge;
* the residual layer applies its activation **after** the skip add;
* the DiT gate (residual ``scale`` on the conditioning vector) multiplies
  the branch input before its linear projection;
* the FFN applies the activation on **both** MLP layers.

Each block is an ``nn.Module`` whose submodule names are the JAX
parameter-tree keys; the apply functions mirror the JAX ones and take the
block module.  The ``*_step`` and ``*_prefill`` forms write the new K/V into
the caches **in place**.
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from qaig_tpu_torch.models import core
from qaig_tpu_torch.ops.activations import get_activation
from qaig_tpu_torch.ops.attention import (decode_attention_presplit,
                                          dot_product_attention, split_heads,
                                          transpose_heads_t)


@dataclass(frozen=True)
class BlockConfig:
    """Static configuration of one transformer block."""
    in_dim: int = 512
    cond_dim: int = 512
    cross_cond_dim: int = 512
    hidden_dim: int = 512
    self_attn_heads: int = 8
    cross_attn_heads: int = 8
    use_cross_attn: bool = True
    use_masked_attn: bool = True
    use_adaln0: bool = False
    use_scale_layer: bool = False
    activation_type: str = "silu"

    @property
    def act(self):
        return get_activation(self.activation_type)


# ---------------------------------------------------------------------------
# AdaLN-Zero and residual
# ---------------------------------------------------------------------------

class AdaLNZero(nn.Module):
    def __init__(self, cond_dim, dim, device=None, dtype=None):
        super().__init__()
        self.scale = core.Linear(cond_dim, dim, zero_weight=True,
                                 device=device, dtype=dtype)
        self.shift = core.Linear(cond_dim, dim, zero_weight=True,
                                 device=device, dtype=dtype)


def adaln_zero(params, x, cond):
    x_norm = core.layer_norm(x)
    return core.linear(params.scale, cond) * x_norm \
        + core.linear(params.shift, cond)


def make_block_norm(cfg: BlockConfig, device=None, dtype=None):
    if cfg.use_adaln0:
        return AdaLNZero(cfg.cond_dim, cfg.in_dim, device=device,
                         dtype=dtype)
    return core.LayerNorm(cfg.in_dim, device=device, dtype=dtype)


def block_norm(params, cfg: BlockConfig, x, cond):
    if cfg.use_adaln0:
        return adaln_zero(params, x, cond)
    return core.affine_layer_norm(params, x)


class Residual(nn.Module):
    def __init__(self, in_dim, out_dim, skip_dim, cond_dim, use_scale_layer,
                 device=None, dtype=None):
        super().__init__()
        self.linear = core.Linear(in_dim, out_dim, device=device,
                                  dtype=dtype)
        if use_scale_layer:
            self.scale = core.Linear(cond_dim, in_dim, zero_weight=True,
                                     device=device, dtype=dtype)
        if skip_dim != out_dim:
            self.skip = core.Linear(skip_dim, out_dim, device=device,
                                    dtype=dtype)


def residual(params, x, x_skip, cond, act):
    if hasattr(params, "scale"):
        x = x * core.linear(params.scale, cond)
    x = core.linear(params.linear, x)
    if hasattr(params, "skip"):
        x_skip = core.linear(params.skip, x_skip)
    return act(x + x_skip)


# ---------------------------------------------------------------------------
# MLP-projected attention
# ---------------------------------------------------------------------------

class QKV(nn.Module):
    def __init__(self, in_dim, hidden_dim, kv_in_dim, device=None,
                 dtype=None):
        super().__init__()
        self.q = core.MLP2(in_dim, hidden_dim, in_dim, device=device,
                           dtype=dtype)
        self.k = core.MLP2(kv_in_dim, hidden_dim, in_dim, device=device,
                           dtype=dtype)
        self.v = core.MLP2(kv_in_dim, hidden_dim, in_dim, device=device,
                           dtype=dtype)


def project_q(params, x, act):
    return core.mlp2(params.q, x, act)


def project_kv(params, x, act):
    return core.mlp2(params.k, x, act), core.mlp2(params.v, x, act)


def _pack(*mlps):
    return {
        "l0w": torch.cat([m.l0.weight for m in mlps], dim=0),
        "l0b": torch.cat([m.l0.bias for m in mlps], dim=0),
        "l1w": torch.stack([m.l1.weight for m in mlps]),
        "l1b": torch.stack([m.l1.bias for m in mlps]),
    }


def pack_qkv(attn_params):
    """Fuse the three Q/K/V MLPs for the decode hot path: one (3*hidden, D)
    linear for the first layers (same input) and one batched (3, D, hidden)
    product for the second.  Same math, 6 products -> 2.  Under tensor
    parallelism the MLPs hold one shard each, and so does the pack; ``tp``
    is the pack's link to the other shards (``core.mlp2``'s links; in one
    process each shard's pack is made on its own card)."""
    q, k, v = attn_params.q, attn_params.k, attn_params.v
    packed = _pack(q, k, v)
    tp = getattr(q, "tp", None)
    packed["tp"] = None if tp is None else tp.zip(_pack, k.tp, v.tp)
    return packed


def packed_qkv(packed, x, act):
    """(N, P, D) -> (q, k, v) each (N, P, D) via the packed projections;
    with ``tp`` the shards' products are summed before the bias."""
    n, p, _ = x.shape
    hidden = packed["l1w"].shape[2]
    tp = packed.get("tp")

    def first(part, xs):
        h = act(F.linear(xs, part["l0w"], part["l0b"]))      # (N, P, 3H)
        return h.reshape(n * p, 3, hidden).transpose(0, 1)      # (3, NP, H)

    if tp is None:
        out = torch.baddbmm(packed["l1b"][:, None, :], first(packed, x),
                            packed["l1w"].transpose(1, 2))     # (3, NP, D)
    else:
        out = tp.sum_partials(
            lambda part, xs: torch.bmm(first(part, xs),
                                       part["l1w"].transpose(1, 2)),
            packed, x) + packed["l1b"][:, None, :]
    out = out.reshape(3, n, p, -1)
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class SelfAttnBlock(nn.Module):
    def __init__(self, cfg: BlockConfig, device=None, dtype=None):
        super().__init__()
        self.norm = make_block_norm(cfg, device, dtype)
        self.attn = QKV(cfg.in_dim, cfg.hidden_dim, cfg.in_dim, device,
                        dtype)
        self.res = Residual(cfg.in_dim, cfg.in_dim, cfg.in_dim, cfg.cond_dim,
                            cfg.use_scale_layer, device, dtype)


class CrossAttnBlock(nn.Module):
    def __init__(self, cfg: BlockConfig, device=None, dtype=None):
        super().__init__()
        self.norm = make_block_norm(cfg, device, dtype)
        self.attn = QKV(cfg.in_dim, cfg.hidden_dim, cfg.cross_cond_dim,
                        device, dtype)
        self.res = Residual(cfg.in_dim, cfg.in_dim, cfg.in_dim, cfg.cond_dim,
                            cfg.use_scale_layer, device, dtype)


class FFNBlock(nn.Module):
    def __init__(self, cfg: BlockConfig, device=None, dtype=None):
        super().__init__()
        self.norm = make_block_norm(cfg, device, dtype)
        self.ff = core.MLP2(cfg.in_dim, cfg.hidden_dim, cfg.in_dim, device,
                            dtype)
        self.res = Residual(cfg.in_dim, cfg.in_dim, cfg.in_dim, cfg.cond_dim,
                            cfg.use_scale_layer, device, dtype)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: BlockConfig, device=None, dtype=None):
        super().__init__()
        self.self_attn = SelfAttnBlock(cfg, device, dtype)
        if cfg.use_cross_attn:
            self.cross_attn = CrossAttnBlock(cfg, device, dtype)
        self.ffn = FFNBlock(cfg, device, dtype)

    def forward(self, cfg, x, cross_cond=None, pos_cond=None):
        return transformer_block(self, cfg, x, cross_cond, pos_cond)


def self_attn_block(params, cfg: BlockConfig, x, cond=None):
    x0 = x
    x = block_norm(params.norm, cfg, x, cond)
    q = project_q(params.attn, x, cfg.act)
    k, v = project_kv(params.attn, x, cfg.act)
    x = dot_product_attention(q, k, v, cfg.self_attn_heads,
                              causal=cfg.use_masked_attn)
    return residual(params.res, x, x0, cond, cfg.act)


def self_attn_block_step(params, cfg: BlockConfig, x, cond, cache, index,
                         packed=None):
    """Single-token decode through the self-attention block.

    x: (N, 1, D); cache: {"k", "v"} slot-minor (N, H, dh, S), updated in
    place at slot ``index`` (an int); packed: optional :func:`pack_qkv`
    output.  Returns (out (N, 1, D), cache)."""
    x0 = x
    x = block_norm(params.norm, cfg, x, cond)
    if packed is not None:
        q, k_new, v_new = packed_qkv(packed, x, cfg.act)
    else:
        q = project_q(params.attn, x, cfg.act)
        k_new, v_new = project_kv(params.attn, x, cfg.act)
    heads = cfg.self_attn_heads
    cache["k"][..., index:index + 1] = transpose_heads_t(
        split_heads(k_new, heads))
    cache["v"][..., index:index + 1] = transpose_heads_t(
        split_heads(v_new, heads))
    s_max = cache["k"].shape[3]
    kv_mask = (torch.arange(s_max, device=x.device) <= index)[None, :]
    kv_mask = kv_mask.expand(x.shape[0], s_max)
    out = decode_attention_presplit(q, cache["k"], cache["v"], kv_mask)
    return residual(params.res, out, x0, cond, cfg.act), cache


def cross_attn_block(params, cfg: BlockConfig, x, cross_cond, cond=None,
                     precomputed_kv=None):
    x0 = x
    x = block_norm(params.norm, cfg, x, cond)
    q = project_q(params.attn, x, cfg.act)
    if precomputed_kv is not None:
        k, v = precomputed_kv["k"], precomputed_kv["v"]
    else:
        k, v = project_kv(params.attn, cross_cond, cfg.act)
    x = dot_product_attention(q, k, v, cfg.cross_attn_heads, causal=False)
    return residual(params.res, x, x0, cond, cfg.act)


def cross_attn_kv(params, cross_cond, act):
    """Encoder-side K/V, computed once per sequence (decode path)."""
    k, v = project_kv(params.attn, cross_cond, act)
    return {"k": k, "v": v}


def ffn_block(params, cfg: BlockConfig, x, cond=None):
    x0 = x
    x = block_norm(params.norm, cfg, x, cond)
    x = core.mlp2(params.ff, x, cfg.act, act_last=True)
    return residual(params.res, x, x0, cond, cfg.act)


def transformer_block(params, cfg: BlockConfig, x, cross_cond=None,
                      pos_cond=None):
    x = self_attn_block(params.self_attn, cfg, x, cond=pos_cond)
    if cfg.use_cross_attn:
        x = cross_attn_block(params.cross_attn, cfg, x, cross_cond,
                             cond=pos_cond)
    return ffn_block(params.ffn, cfg, x, cond=pos_cond)


def transformer_block_step(params, cfg: BlockConfig, x, cache, index,
                           cross_kv=None, pos_cond=None, packed=None):
    """Single-token decode through a full block (self K/V cached in place,
    cross K/V precomputed)."""
    x, self_cache = self_attn_block_step(
        params.self_attn, cfg, x, pos_cond, cache, index, packed=packed)
    if cfg.use_cross_attn:
        x = cross_attn_block(params.cross_attn, cfg, x, None, cond=pos_cond,
                             precomputed_kv=cross_kv)
    return ffn_block(params.ffn, cfg, x, cond=pos_cond), self_cache


def self_attn_block_prefill(params, cfg: BlockConfig, x, cond, cache):
    """Causal self-attention over a full prefix (N, P, D), writing the
    prefix K/V into cache slots [0, P) in place."""
    p = x.shape[1]
    x0 = x
    x = block_norm(params.norm, cfg, x, cond)
    q = project_q(params.attn, x, cfg.act)
    k, v = project_kv(params.attn, x, cfg.act)
    heads = cfg.self_attn_heads
    cache["k"][..., :p] = transpose_heads_t(split_heads(k, heads))
    cache["v"][..., :p] = transpose_heads_t(split_heads(v, heads))
    out = dot_product_attention(q, k, v, heads, causal=True)
    return residual(params.res, out, x0, cond, cfg.act), cache


def transformer_block_prefill(params, cfg: BlockConfig, x, cache,
                              cross_kv=None, pos_cond=None):
    """Full-prefix pass through a block, filling the self-attn KV cache."""
    x, self_cache = self_attn_block_prefill(params.self_attn, cfg, x,
                                            pos_cond, cache)
    if cfg.use_cross_attn:
        x = cross_attn_block(params.cross_attn, cfg, x, None, cond=pos_cond,
                             precomputed_kv=cross_kv)
    return ffn_block(params.ffn, cfg, x, cond=pos_cond), self_cache
