"""Encoder-decoder / decoder-only transformer over codebook tokens
(counterpart of ``qaig_tpu/models/transformer.py``).

* optional vanilla encoder (unmasked blocks, no cross-attn, no AdaLN) over
  coarse-token embeddings;
* DiT-style decoder: masked blocks, cross-attn iff an encoder exists,
  AdaLN-Zero + DiT gating iff position conditioning is on;
* sinusoidal sequence positions start at **1**;
* the position-conditioning vector is a 2-layer MLP over sinusoidal
  embeddings of absolute patch positions;
* the classifier head is a 2-layer MLP whose first layer is always silu.

The module's parameter names are the JAX tree's keys (``dec_embedding``,
``decoder_layers.3.self_attn.attn.q.l0`` ...).  ``forward`` is the
teacher-forcing pass of training (JAX ``apply``; ``use_remat`` recomputes
each block's activations in the backward, as ``jax.checkpoint`` does).  The
other methods are the JAX decode-engine primitives without the ``params``
argument; KV caches are slot-minor (N, H, dh, S) and are updated **in
place**.
"""

from dataclasses import dataclass

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from qaig_tpu_torch.models import blocks, core
from qaig_tpu_torch.ops.activations import get_activation
from qaig_tpu_torch.ops.attention import (dot_product_attention,
                                          shared_cross_attention,
                                          shared_prefix_attention,
                                          shared_prefix_block_attention,
                                          split_heads, transpose_heads_t)
from qaig_tpu_torch.ops.kv_quant import quantize_kv_t
from qaig_tpu_torch.ops.posemb import sinusoidal_pos_emb


@dataclass(frozen=True)
class TransformerConfig:
    use_encoder: bool = True
    use_pos_cond: bool = True
    num_enc_layers: int = 5
    num_dec_layers: int = 10
    num_enc_embedding: int = 512
    num_dec_embedding: int = 512
    self_attn_heads: int = 8
    cross_attn_heads: int = 8
    in_dim: int = 512
    out_dim: int = 512
    hidden_dim: int = 4096
    hidden_activation: str = "silu"
    use_remat: bool = False

    def encoder_block_config(self):
        return blocks.BlockConfig(
            in_dim=self.in_dim,
            hidden_dim=self.hidden_dim,
            self_attn_heads=self.self_attn_heads,
            use_cross_attn=False,
            use_masked_attn=False,
            use_adaln0=False,
            use_scale_layer=False,
            activation_type=self.hidden_activation)

    def decoder_block_config(self):
        return blocks.BlockConfig(
            in_dim=self.in_dim,
            cond_dim=self.in_dim,
            cross_cond_dim=self.in_dim,
            hidden_dim=self.hidden_dim,
            self_attn_heads=self.self_attn_heads,
            cross_attn_heads=self.cross_attn_heads or 8,
            use_cross_attn=self.use_encoder,
            use_masked_attn=True,
            use_adaln0=self.use_pos_cond,
            use_scale_layer=self.use_pos_cond,
            activation_type=self.hidden_activation)


class Transformer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.enc_block_cfg = cfg.encoder_block_config()
        self.dec_block_cfg = cfg.decoder_block_config()
        kw = {"device": device, "dtype": dtype}
        if cfg.use_encoder:
            self.enc_embedding = core.Embedding(cfg.num_enc_embedding,
                                                cfg.in_dim, **kw)
            self.encoder_layers = nn.ModuleList(
                blocks.TransformerBlock(self.enc_block_cfg, **kw)
                for _ in range(cfg.num_enc_layers))
        self.dec_embedding = core.Embedding(cfg.num_dec_embedding,
                                            cfg.in_dim, **kw)
        self.decoder_layers = nn.ModuleList(
            blocks.TransformerBlock(self.dec_block_cfg, **kw)
            for _ in range(cfg.num_dec_layers))
        if cfg.use_pos_cond:
            self.pos_cond_layer = core.MLP2(cfg.in_dim, cfg.hidden_dim,
                                            cfg.in_dim, **kw)
        self.classifier = core.MLP2(cfg.in_dim, cfg.hidden_dim, cfg.out_dim,
                                    **kw)

    @property
    def device(self):
        return self.dec_embedding.weight.device

    @property
    def dtype(self):
        return self.dec_embedding.weight.dtype

    def _positions(self, start, stop):
        """Sinusoidal embeddings of positions [start, stop) as (S, D)."""
        pos = torch.arange(start, stop, dtype=torch.float32,
                           device=self.device)
        return sinusoidal_pos_emb(self.cfg.in_dim, pos)

    def _scalar_pos_cond(self, value):
        """(1, 1, D) conditioning for one absolute position ``value``."""
        pos = torch.full((1, 1), float(value), device=self.device)
        return self.pos_cond_embedding(pos)

    # -- helpers ------------------------------------------------------------

    def _block(self, layer, cfg, *args):
        """``blocks.transformer_block``, recomputed in the backward under
        ``use_remat``.  The recompute gets the parameter tensors this call
        sees (under ``functional_call``, the caller's copies), not the
        module's own.  A block draws no random numbers, so no generator
        state is kept for the recompute (reading the card's generator
        state is not allowed while a train step is captured as a CUDA
        graph)."""
        if self.cfg.use_remat and torch.is_grad_enabled():
            return checkpoint(functional_call, layer,
                              dict(layer.named_parameters()), (cfg, *args),
                              use_reentrant=False, preserve_rng_state=False)
        return blocks.transformer_block(layer, cfg, *args)

    def encode(self, x_enc):
        """Coarse-token encoder half; returns (N, enc_Seq, D)."""
        h = core.embedding_lookup(self.enc_embedding, x_enc)
        h = h + self._positions(1, h.shape[1] + 1)[None].to(h.dtype)
        for layer in self.encoder_layers:
            h = self._block(layer, self.enc_block_cfg, h)
        return h

    def embed_decoder(self, x_dec):
        """Decoder token ids -> (N, Seq, D): embedding + sinusoidal
        positions starting at 1."""
        h = core.embedding_lookup(self.dec_embedding, x_dec)
        return h + self._positions(1, h.shape[1] + 1)[None].to(h.dtype)

    def pos_cond_embedding(self, pos_cond):
        """(N, Seq) absolute patch positions -> (N, Seq, D) conditioning."""
        act = get_activation(self.cfg.hidden_activation)
        emb = sinusoidal_pos_emb(self.cfg.in_dim, pos_cond)
        emb = emb.to(self.pos_cond_layer.l0.weight.dtype)
        return core.mlp2(self.pos_cond_layer, emb, act)

    def classify(self, h):
        return core.mlp2(self.classifier, h, get_activation("silu"))

    # -- full teacher-forcing forward ---------------------------------------

    def forward(self, x_dec, x_enc=None, pos_cond=None, decoder_stack=None):
        """Token ids (N, Seq) -> logits (N, Seq, out_dim); ``x_enc`` feeds
        the encoder, ``pos_cond`` (N, Seq) holds absolute positions.
        ``decoder_stack(model, h, enc_out, pos_cond_emb)`` replaces the
        loop over the decoder layers (the pipeline's stage,
        ``parallel/pipeline.py``); when it returns None (a stage before the
        last) so does ``forward``."""
        cfg = self.cfg
        enc_out = self.encode(x_enc) if cfg.use_encoder else None
        h = self.embed_decoder(x_dec)
        pos_cond_emb = (self.pos_cond_embedding(pos_cond)
                        if cfg.use_pos_cond else None)
        if decoder_stack is not None:
            h = decoder_stack(self, h, enc_out, pos_cond_emb)
            return None if h is None else self.classify(h)
        for layer in self.decoder_layers:
            h = self._block(layer, self.dec_block_cfg, h, enc_out,
                            pos_cond_emb)
        return self.classify(h)

    # -- decode-engine primitives (KV-cached path) --------------------------

    def init_cache(self, batch, max_len, dtype=None):
        """Per-decoder-layer self-attention KV caches, head-split and
        slot-minor (N, H, dh, S)."""
        heads = self.cfg.self_attn_heads
        shape = (batch, heads, self.cfg.in_dim // heads, max_len)
        dtype = dtype or self.dtype
        return [{"k": torch.zeros(shape, dtype=dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=dtype, device=self.device)}
                for _ in range(self.cfg.num_dec_layers)]

    def make_cross_kv(self, enc_out):
        """Encoder-side K/V of every decoder layer, once per sequence."""
        if not self.cfg.use_encoder:
            return [None] * self.cfg.num_dec_layers
        return [blocks.cross_attn_kv(layer.cross_attn, enc_out,
                                     self.dec_block_cfg.act)
                for layer in self.decoder_layers]

    def prefill(self, tokens, caches, cross_kv=None, pos_cond=None):
        """Run the prefix (N, P) through the decoder, filling the KV caches
        in place.  Returns (last-position logits (N, out_dim), caches)."""
        h = self.embed_decoder(tokens)
        pos_cond_emb = (self.pos_cond_embedding(pos_cond)
                        if self.cfg.use_pos_cond else None)
        new_caches = []
        for layer, cache, ckv in zip(
                self.decoder_layers, caches,
                cross_kv or [None] * self.cfg.num_dec_layers):
            h, cache = blocks.transformer_block_prefill(
                layer, self.dec_block_cfg, h, cache, cross_kv=ckv,
                pos_cond=pos_cond_emb)
            new_caches.append(cache)
        return self.classify(h[:, -1:])[:, 0], new_caches

    def pack_decode(self):
        """Per-layer fused QKV projections for the decode hot path."""
        return [blocks.pack_qkv(layer.self_attn.attn)
                for layer in self.decoder_layers]

    def decode_step(self, token, caches, index, cross_kv=None,
                    pos_cond_value=None, packed=None):
        """One-token decode: ``token`` (N,) at absolute position ``index``
        (0-based int).  Returns (logits (N, out_dim), caches)."""
        cfg = self.cfg
        h = core.embedding_lookup(self.dec_embedding, token[:, None])
        h = h + self._positions(index + 1, index + 2)[None].to(h.dtype)
        pos_cond_emb = (self._scalar_pos_cond(pos_cond_value)
                        if cfg.use_pos_cond else None)
        new_caches = []
        packed = packed or [None] * cfg.num_dec_layers
        for layer, cache, ckv, pk in zip(
                self.decoder_layers, caches,
                cross_kv or [None] * cfg.num_dec_layers, packed):
            h, cache = blocks.transformer_block_step(
                layer, self.dec_block_cfg, h, cache, index, cross_kv=ckv,
                pos_cond=pos_cond_emb, packed=pk)
            new_caches.append(cache)
        return self.classify(h)[:, 0], new_caches

    # -- shared-prefix beam decode (rollout fast path) -----------------------

    def presplit_cross_kv(self, cross_kv):
        """(N, S, D) cross K/V -> head-split slot-minor (N, H, dh, S), once
        per generation."""
        heads = self.cfg.cross_attn_heads or self.cfg.self_attn_heads
        return [None if ckv is None else
                {"k": transpose_heads_t(split_heads(ckv["k"], heads)),
                 "v": transpose_heads_t(split_heads(ckv["v"], heads))}
                for ckv in cross_kv]

    def init_block_cache(self, nb, bw, dtype=None):
        """Per-rollout segment K/V blocks: (N*B, H, bw, dh) per layer."""
        heads = self.cfg.self_attn_heads
        shape = (nb, heads, bw, self.cfg.in_dim // heads)
        dtype = dtype or self.dtype
        return [{"k": torch.zeros(shape, dtype=dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=dtype, device=self.device)}
                for _ in range(self.cfg.num_dec_layers)]

    def decode_step_shared(self, token, shared_caches, block_caches, index0,
                           block_index, cross_kv_split=None,
                           pos_cond_value=None, packed=None):
        """One rollout decode step: ``token`` (N*B,) at absolute position
        ``index0 + block_index``; prefix K/V shared at N rows, segment K/V
        per rollout (written in place at ``block_index``).  Returns
        (logits (N*B, out), block_caches)."""
        cfg = self.cfg
        bcfg = self.dec_block_cfg
        index_abs = index0 + block_index
        h = core.embedding_lookup(self.dec_embedding, token[:, None])
        h = h + self._positions(index_abs + 1, index_abs + 2)[None].to(
            h.dtype)
        pos_cond_emb = (self._scalar_pos_cond(pos_cond_value)
                        if cfg.use_pos_cond else None)

        packed = packed or [None] * cfg.num_dec_layers
        cross_kv_split = cross_kv_split or [None] * cfg.num_dec_layers
        heads = bcfg.self_attn_heads
        for layer, shared, block, ckv, pk in zip(
                self.decoder_layers, shared_caches, block_caches,
                cross_kv_split, packed):
            x0 = h
            xn = blocks.block_norm(layer.self_attn.norm, bcfg, h,
                                   pos_cond_emb)
            if pk is not None:
                q, k, v = blocks.packed_qkv(pk, xn, bcfg.act)
            else:
                q = blocks.project_q(layer.self_attn.attn, xn, bcfg.act)
                k, v = blocks.project_kv(layer.self_attn.attn, xn, bcfg.act)
            block["k"][:, :, block_index] = split_heads(k, heads)[:, :, 0]
            block["v"][:, :, block_index] = split_heads(v, heads)[:, :, 0]
            attn = shared_prefix_attention(
                q, shared["k"], shared["v"], block["k"], block["v"], index0,
                block_index, k_scale=shared.get("k_scale"),
                v_scale=shared.get("v_scale"))
            h = blocks.residual(layer.self_attn.res, attn, x0, pos_cond_emb,
                                bcfg.act)
            if cfg.use_encoder:
                x0 = h
                xn = blocks.block_norm(layer.cross_attn.norm, bcfg, h,
                                       pos_cond_emb)
                q2 = blocks.project_q(layer.cross_attn.attn, xn, bcfg.act)
                attn2 = shared_cross_attention(q2, ckv["k"], ckv["v"])
                h = blocks.residual(layer.cross_attn.res, attn2, x0,
                                    pos_cond_emb, bcfg.act)
            h = blocks.ffn_block(layer.ffn, bcfg, h, cond=pos_cond_emb)
        return self.classify(h)[:, 0], block_caches

    def merge_block_caches(self, shared_caches, block_caches, index0):
        """Write the (selected) per-rollout blocks into the shared
        slot-minor prefix at slot ``index0``, in place.  Quantized prefixes
        (int8 + per-slot scales) quantize the block on merge."""
        for shared, block in zip(shared_caches, block_caches):
            bk = transpose_heads_t(block["k"])     # (N, H, dh, bw)
            bv = transpose_heads_t(block["v"])
            end = index0 + bk.shape[-1]
            if "k_scale" in shared:
                k8, ks = quantize_kv_t(bk)
                v8, vs = quantize_kv_t(bv)
                shared["k"][..., index0:end] = k8
                shared["v"][..., index0:end] = v8
                shared["k_scale"][..., index0:end] = ks
                shared["v_scale"][..., index0:end] = vs
            else:
                shared["k"][..., index0:end] = bk
                shared["v"][..., index0:end] = bv
        return shared_caches

    def window_forward_shared(self, shared_tokens, block_tokens,
                              shared_pos_cond=None, block_pos_cond=None,
                              cross_kv=None):
        """Sliding-window recompute where the window's leading S0 slots are
        shared across the B rollouts of an image: the shared stream runs at
        N rows, only the segment tail (N*B, T) runs per rollout, attending
        to the shared slots.  Returns final-tail-position logits
        (N*B, out_dim), equal to ``window_forward(concat window,
        last_only=True)[:, 0]`` per rollout."""
        cfg = self.cfg
        bcfg = self.dec_block_cfg
        s0 = shared_tokens.shape[1]
        seq = s0 + block_tokens.shape[1]
        heads = cfg.self_attn_heads

        hs = core.embedding_lookup(self.dec_embedding, shared_tokens)
        hb = core.embedding_lookup(self.dec_embedding, block_tokens)
        pos = self._positions(1, seq + 1)
        hs = hs + pos[None, :s0].to(hs.dtype)
        hb = hb + pos[None, s0:].to(hb.dtype)

        cond_s = cond_b = None
        if cfg.use_pos_cond:
            cond_s = self.pos_cond_embedding(shared_pos_cond)
            cond_b = self.pos_cond_embedding(block_pos_cond)

        cross_kv = cross_kv or [None] * cfg.num_dec_layers
        cross_heads = cfg.cross_attn_heads or heads
        n_layers = cfg.num_dec_layers
        for i, (layer, ckv) in enumerate(zip(self.decoder_layers, cross_kv)):
            last = i == n_layers - 1
            sa = layer.self_attn

            # self-attention: the shared stream stays at N rows
            hs_n = blocks.block_norm(sa.norm, bcfg, hs, cond_s)
            hb_n = blocks.block_norm(sa.norm, bcfg, hb, cond_b)
            k_s, v_s = blocks.project_kv(sa.attn, hs_n, bcfg.act)
            k_b, v_b = blocks.project_kv(sa.attn, hb_n, bcfg.act)
            if not last:
                q_s = blocks.project_q(sa.attn, hs_n, bcfg.act)
                attn_s = dot_product_attention(q_s, k_s, v_s, heads,
                                               causal=True)
                hs = blocks.residual(sa.res, attn_s, hs, cond_s, bcfg.act)
            # last layer: only the final tail query feeds the classifier
            q_b = blocks.project_q(sa.attn, hb_n[:, -1:] if last else hb_n,
                                   bcfg.act)
            x0b = hb[:, -1:] if last else hb
            if last and cond_b is not None:
                cond_b = cond_b[:, -1:]
            attn_b = shared_prefix_block_attention(
                q_b, split_heads(k_s, heads), split_heads(v_s, heads),
                split_heads(k_b, heads), split_heads(v_b, heads))
            hb = blocks.residual(sa.res, attn_b, x0b, cond_b, bcfg.act)

            # cross-attention (precomputed encoder K/V at N rows)
            if cfg.use_encoder:
                if not last:
                    hs = blocks.cross_attn_block(
                        layer.cross_attn, bcfg, hs, None, cond=cond_s,
                        precomputed_kv=ckv)
                ca = layer.cross_attn
                x0b = hb
                hb_n2 = blocks.block_norm(ca.norm, bcfg, hb, cond_b)
                q2 = blocks.project_q(ca.attn, hb_n2, bcfg.act)
                attn2 = shared_cross_attention(
                    q2, transpose_heads_t(split_heads(ckv["k"], cross_heads)),
                    transpose_heads_t(split_heads(ckv["v"], cross_heads)))
                hb = blocks.residual(ca.res, attn2, x0b, cond_b, bcfg.act)

            # feedforward
            if not last:
                hs = blocks.ffn_block(layer.ffn, bcfg, hs, cond=cond_s)
            hb = blocks.ffn_block(layer.ffn, bcfg, hb, cond=cond_b)
        return self.classify(hb)[:, 0]

    def window_forward(self, tokens, pos_cond=None, cross_kv=None,
                       last_only=False):
        """Full decoder forward over a fixed window with precomputed cross
        K/V (the sliding-window decode path).  ``last_only`` restricts the
        last layer's query (and its cross-attn / FFN) to the final position
        and returns (N, 1, out_dim); otherwise all-position logits."""
        cfg = self.cfg
        bcfg = self.dec_block_cfg
        h = self.embed_decoder(tokens)
        seq = h.shape[1]
        pos_cond_emb = (self.pos_cond_embedding(pos_cond)
                        if cfg.use_pos_cond else None)
        cross_kv = cross_kv or [None] * cfg.num_dec_layers
        n_layers = cfg.num_dec_layers
        for i, (layer, ckv) in enumerate(zip(self.decoder_layers, cross_kv)):
            if last_only and i == n_layers - 1:
                # all positions feed K/V, only the final query is consumed
                x0 = h[:, -1:]
                xn = blocks.block_norm(layer.self_attn.norm, bcfg, h,
                                       pos_cond_emb)
                q = blocks.project_q(layer.self_attn.attn, xn[:, -1:],
                                     bcfg.act)
                k, v = blocks.project_kv(layer.self_attn.attn, xn, bcfg.act)
                cond_last = (pos_cond_emb[:, -1:]
                             if pos_cond_emb is not None else None)
                attn = dot_product_attention(q, k, v, bcfg.self_attn_heads,
                                             causal=True, q_offset=seq - 1)
                h = blocks.residual(layer.self_attn.res, attn, x0, cond_last,
                                    bcfg.act)
                if cfg.use_encoder:
                    h = blocks.cross_attn_block(
                        layer.cross_attn, bcfg, h, None, cond=cond_last,
                        precomputed_kv=ckv)
                h = blocks.ffn_block(layer.ffn, bcfg, h, cond=cond_last)
            else:
                h = blocks.self_attn_block(layer.self_attn, bcfg, h,
                                           cond=pos_cond_emb)
                if cfg.use_encoder:
                    h = blocks.cross_attn_block(
                        layer.cross_attn, bcfg, h, None, cond=pos_cond_emb,
                        precomputed_kv=ckv)
                h = blocks.ffn_block(layer.ffn, bcfg, h, cond=pos_cond_emb)
        return self.classify(h)
