"""Autoregressive decode engine (counterpart of ``qaig_tpu/infer/decode.py``).

Engines, as in the JAX package:

* **KV-cached** (``use_pos_cond=False``): prefill, then single-token steps
  against per-layer slot-minor KV caches grown in doubling buckets;
* **hybrid sliding window** (``use_pos_cond=True``): KV-cached while the
  context is shorter than the window, then (W-1)-token window recompute;
* **rollout beam search** (``rollout_generate``): best of ``num_beam``
  independent ``beam_width``-token continuations per image.  The prefix
  K/V stays shared at N rows and only each rollout's segment is per
  rollout (``Transformer.decode_step_shared``, whose attention is the
  decode kernel on the card); once the window slides, the shared windowed
  segments keep the window's shared slots at N rows
  (``window_forward_shared``).  Winners are selected on the device.

Sampling semantics: temperature softmax + categorical draw; ``mask`` zeroes
the <end> probability before sampling and scores the chosen token's
unrenormalized probability; ``replace_zero`` remaps <end> -> 0;
``index_shift`` moves tokens into the combined LR+HR vocabulary;
``pos_offset`` is the generation-time position offset.

Options, as in the JAX package: ``quantized_prefix`` keeps the rollout
prefix int8 (kernel C, or the flat kernel's int8 form); ``flat_decode``
sends the rollout segments that ``flat_segment_supported`` admits to the
flat kernel over an interleaved copy of the prefix made once per segment;
``legacy_windowed_rollouts`` runs sliding-window segments through the
tile-everything path instead of the shared windowed one.

PyTorch runs eagerly, so the engine is a Python loop over steps.  Position
counters (``index``, ``pos_next``) are Python ints.  ``rng`` is either a
``torch.Generator``, consumed in step order (batch-keyed sampling: all rows
draw together, the ``generate_images`` semantics), or per-row keys (N, 2)
(``infer/row_keys.py``): rollout ``b`` of row ``n`` then draws the token of
global slot ``s`` from ``fold_in(fold_in(row_key[n], b), s)``, so a row's
tokens depend only on its own key (composition-invariant serving).
Segments consume their input state: KV caches and blocks are updated **in
place**.
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from qaig_tpu_torch.infer import row_keys
from qaig_tpu_torch.ops.decode_attention import (flat_segment_supported,
                                                 interleave_scale,
                                                 interleave_t)
from qaig_tpu_torch.ops.kv_quant import dequantize_caches, quantize_caches


@dataclass(frozen=True)
class SamplerSettings:
    temperature: float = 1.0
    end_token: int = -1         # vocabulary index of <end> (= hr_K)
    end_mode: str = "mask"      # 'mask' | 'replace_zero' | 'none'
    index_shift: int = 0        # added to sampled tokens before re-feeding
    pos_offset: int = 0         # generated slot i is conditioned at i + this


@dataclass
class DecodeState:
    """Engine state: ``arrays`` holds the tensors (and int counters); the
    mode switch (cached -> windowed) and the cache-growth schedule follow
    the Python counters."""
    mode: str                   # 'cached' | 'windowed'
    arrays: dict
    init_len: int
    gen_count: int = 0
    window: int = None          # sliding_window (pos-cond models only)
    cache_len: int = 0          # current KV cache capacity (cached mode)
    total_len: int = 0          # final capacity the generation needs


FIRST_BUCKET = 64


def _bucket_schedule(needed, total):
    """Next cache capacity: doubling buckets, clipped to the final total."""
    cap = FIRST_BUCKET
    while cap < needed:
        cap *= 2
    return min(cap, total) if needed <= total else needed


class RowSlice:
    """A ``torch.Generator`` shared by ``count`` data-parallel ranks of
    which this one (``index``) holds a contiguous block of every draw's
    rows: each draw is made for all ranks' rows, as one process would
    make it, and this rank's block taken, so the tokens equal one
    process's (rollout rows are image-major, so a block of images is a
    block of rows)."""

    def __init__(self, generator, index, count):
        self.generator, self.index, self.count = generator, index, count

    @property
    def device(self):
        return self.generator.device

    def _mine(self, full, rows):
        return full[self.index * rows:(self.index + 1) * rows]

    def exponential(self, shape, dtype):
        full = torch.empty((shape[0] * self.count,) + tuple(shape[1:]),
                           dtype=dtype, device=self.device)
        return self._mine(full.exponential_(1, generator=self.generator),
                          shape[0])

    def randint(self, high, shape):
        full = torch.randint(0, high, (shape[0] * self.count,)
                             + tuple(shape[1:]), generator=self.generator,
                             device=self.device)
        return self._mine(full, shape[0])


def _categorical(logits, draw):
    """One categorical draw per row of (rows, K) float32 logits: all rows
    from one ``torch.Generator`` (or this rank's rows of its draw for all
    ranks, :class:`RowSlice`), or by Gumbel-max with per-row noise
    (rows, K) (``_SlotNoise.at``).  The generator's draw is
    ``torch.multinomial(softmax, 1)``'s own algorithm written out,
    ``argmax(p / E)`` with ``E ~ Exp(1)`` from the generator, so the same
    generator state gives the same tokens; ``multinomial`` also checks the
    distribution on the host, which a CUDA graph capture cannot do."""
    if isinstance(draw, torch.Tensor):
        return torch.argmax(logits + draw, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    if isinstance(draw, RowSlice):
        noise = draw.exponential(probs.shape, probs.dtype)
    else:
        noise = torch.empty_like(probs).exponential_(1, generator=draw)
    return torch.argmax(probs / noise, dim=-1)


def _is_row_keys(rng):
    """True when ``rng`` is a (rows, 2) tensor of per-row keys rather than a
    ``torch.Generator``."""
    return isinstance(rng, torch.Tensor)


def _expand_row_keys(keys, num_beam):
    """Per-row keys (N, 2) -> per-rollout keys (N*num_beam, 2): rollout
    ``b`` of row ``n`` gets ``fold_in(keys[n], b)``, rows grouped as
    ``_tile`` groups them."""
    beams = torch.arange(num_beam, dtype=torch.int64, device=keys.device)
    return row_keys.fold_in(keys[:, None], beams[None]).reshape(-1, 2)


def _rollout_rng(rng, num_beam):
    return _expand_row_keys(rng, num_beam) if _is_row_keys(rng) else rng


class _SlotNoise:
    """The Gumbel noise of per-row keys for the slots [first, first +
    count), drawn in one pass when a segment starts: row ``i`` at slot ``s``
    uses ``fold_in(keys[i], s)`` only, so this gives the draws a step-by-step
    fold would, with one set of hash kernels per segment instead of one per
    step."""

    def __init__(self, keys, first, count, vocab):
        slots = torch.arange(first, first + count, dtype=torch.int64,
                             device=keys.device)
        self.first = first
        self.noise = row_keys.gumbel(row_keys.fold_in(keys[:, None],
                                                      slots[None]), vocab)

    def at(self, slot):
        return self.noise[:, slot - self.first]


def _draws(rng, first, count, vocab):
    """What a segment's steps draw from: the generator, or the noise of
    per-row keys for the segment's slots."""
    return _SlotNoise(rng, first, count, vocab) if _is_row_keys(rng) else rng


def _sample(logits, rng, s: SamplerSettings, slot=None):
    """Returns (context_token (N,), chosen_prob (N,)).  ``rng`` is a
    ``torch.Generator`` or a segment's ``_SlotNoise``, read at ``slot`` (the
    global context index of the token being generated)."""
    scaled = logits.to(torch.float32) / s.temperature
    probs = torch.softmax(scaled, dim=-1)
    if s.end_mode == "mask":
        probs[:, s.end_token] = 0.0
        sample_logits = torch.log(torch.clamp(probs, min=1e-38))
    else:
        sample_logits = scaled
    draw = rng.at(slot) if isinstance(rng, _SlotNoise) else rng
    token = _categorical(sample_logits, draw)
    chosen = probs.gather(1, token[:, None])[:, 0]
    if s.end_mode == "replace_zero":
        token = torch.where(token == s.end_token, 0, token)
    return token + s.index_shift, chosen


def _log_prob(p):
    return torch.log(torch.clamp(p, min=1e-38))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _tile(tree, reps):
    """Repeat rows: (N, ...) -> (N*reps, ...), rows grouped
    [n0r0, n0r1, ..., n1r0, ...]."""
    return _tree_map(lambda x: x.repeat_interleave(reps, dim=0), tree)


def _select_beam(tree, winner, num_beam):
    """Gather the winning rollout's rows from (N*B, ...) tensors."""
    n = winner.shape[0]
    rows = torch.arange(n, device=winner.device) * num_beam + winner
    return _tree_map(lambda x: x.index_select(0, rows), tree)


def _ceil32(x):
    return -(-x // 32) * 32


class DecodeEngine:
    def __init__(self, model, quantized_prefix=False,
                 legacy_windowed_rollouts=False, flat_decode=False):
        # quantized_prefix: store the rollout decode's SHARED prefix K/V
        # int8 with per-slot scales (ops/kv_quant.py); its attention runs
        # the int8-prefix decode kernel.  Only rollout_generate uses it.
        # legacy_windowed_rollouts: sliding-window segments take the
        # tile-everything path instead of the shared windowed one (A/B
        # testing; taken anyway when beam_width >= window).
        # flat_decode: rollout segments that flat_segment_supported admits
        # read an interleaved (N, dh, S*H) copy of the prefix, made once
        # per segment, through the flat kernel (int8 in the kernel with
        # quantized_prefix).
        self.model = model
        self.quantized_prefix = quantized_prefix
        self.legacy_windowed_rollouts = legacy_windowed_rollouts
        self.flat_decode = flat_decode

    def _flat_segment(self, num_beam, block_width):
        """Whether this rollout segment's attention goes through the flat
        kernel: the engine option AND the routing rule (stage-0 fans of 32
        rollouts and the 7-wide crossing block stay on kernels B/C)."""
        return self.flat_decode and flat_segment_supported(
            self.model.cfg.self_attn_heads, num_beam, block_width)

    @staticmethod
    def _read_views(caches, read_len, flat=False):
        """Per-segment read views of the shared prefix caches: the first
        ``read_len`` slots, materialized contiguous for the decode kernel;
        with ``flat``, in the interleaved layout of the flat kernel."""
        views = [{key: value[..., :read_len] for key, value in c.items()}
                 for c in caches]
        if flat:
            return [{key: (interleave_t(value) if value.ndim == 4
                           else interleave_scale(value))
                     for key, value in c.items()} for c in views]
        return [{key: value.contiguous() for key, value in c.items()}
                for c in views]

    # ------------------------------------------------------------------
    # cached state init / segment
    # ------------------------------------------------------------------

    def _cached_init(self, init_tokens, total_len, x_enc, ctx_size):
        """Prefill.  ``ctx_size`` > 0 (pos-cond models) keeps a token
        context ring of that size for the later window conversion."""
        model = self.model
        init_tokens = init_tokens.long()
        n, p = init_tokens.shape
        cross_kv = None
        if model.cfg.use_encoder:
            cross_kv = model.make_cross_kv(model.encode(x_enc))
        caches = model.init_cache(n, total_len)
        pos_cond = None
        if model.cfg.use_pos_cond:
            # pre-slide positions == absolute slot indices 0..P-1
            pos_cond = torch.arange(p, dtype=torch.float32,
                                    device=init_tokens.device).expand(n, p)
        logits, caches = model.prefill(init_tokens, caches, cross_kv=cross_kv,
                                       pos_cond=pos_cond)
        state = {"caches": caches, "cross_kv": cross_kv, "logits": logits,
                 "index": p}
        if ctx_size:
            ctx = torch.zeros(n, ctx_size, dtype=torch.long,
                              device=init_tokens.device)
            ctx[:, :p] = init_tokens
            state["ctx"] = ctx
        return state

    def _cached_segment(self, arrays, rng, num_steps,
                        settings: SamplerSettings):
        model = self.model
        use_pos = model.cfg.use_pos_cond
        packed = model.pack_decode()
        logits, caches, index = (arrays["logits"], arrays["caches"],
                                 arrays["index"])
        ctx = arrays["ctx"].clone() if "ctx" in arrays else None
        logp = torch.zeros(logits.shape[0], device=logits.device)
        draws = _draws(rng, index, num_steps, model.cfg.out_dim)
        tokens = []
        for _ in range(num_steps):
            token, p = _sample(logits, draws, settings, slot=index)
            if ctx is not None:
                ctx[:, index] = token
            pos_val = index + settings.pos_offset if use_pos else None
            logits, caches = model.decode_step(
                token, caches, index, cross_kv=arrays["cross_kv"],
                pos_cond_value=pos_val, packed=packed)
            logp = logp + _log_prob(p)
            tokens.append(token)
            index += 1
        new_arrays = dict(arrays, caches=caches, logits=logits, index=index)
        if ctx is not None:
            new_arrays["ctx"] = ctx
        return new_arrays, torch.stack(tokens, dim=1), logp

    # ------------------------------------------------------------------
    # shared-prefix rollout segment (beam fast path)
    # ------------------------------------------------------------------

    def _rollout_segment(self, arrays, rng, beam_width, num_beam,
                         settings: SamplerSettings, prefix_len=None):
        """One best-of-B segment with the prefix KV cache SHARED across
        rollouts: only (N*B, H, bw, dh) per-rollout blocks are created,
        selected and merged back (in place).  Attention reads the prefix
        up to the next multiple of 32 slots past ``prefix_len``.  Returns
        (new shared arrays, winning tokens (N, bw))."""
        model = self.model
        use_pos = model.cfg.use_pos_cond
        cap = arrays["caches"][0]["k"].shape[-1]
        read_len = cap if prefix_len is None else min(cap,
                                                      _ceil32(prefix_len))
        n = arrays["logits"].shape[0]
        nb = n * num_beam
        index0 = arrays["index"]
        packed = model.pack_decode()
        cross_split = (model.presplit_cross_kv(arrays["cross_kv"])
                       if model.cfg.use_encoder else None)
        block_caches = model.init_block_cache(nb, beam_width)
        read_caches = self._read_views(
            arrays["caches"], read_len,
            flat=self._flat_segment(num_beam, beam_width))
        draw = _draws(_rollout_rng(rng, num_beam), index0, beam_width,
                      model.cfg.out_dim)

        logits = _tile(arrays["logits"], num_beam)
        ctx = _tile(arrays["ctx"], num_beam) if "ctx" in arrays else None
        logp = torch.zeros(nb, device=logits.device)
        tokens = []
        for j in range(beam_width):
            token, p = _sample(logits, draw, settings, slot=index0 + j)
            if ctx is not None:
                ctx[:, index0 + j] = token
            pos_val = index0 + j + settings.pos_offset if use_pos else None
            logits, block_caches = model.decode_step_shared(
                token, read_caches, block_caches, index0, j,
                cross_kv_split=cross_split, pos_cond_value=pos_val,
                packed=packed)
            logp = logp + _log_prob(p)
            tokens.append(token)

        winner = torch.argmax(logp.reshape(n, num_beam), dim=1)
        sel = _select_beam({"logits": logits,
                            "tokens": torch.stack(tokens, dim=1),
                            "ctx": ctx, "blocks": block_caches},
                           winner, num_beam)
        caches = model.merge_block_caches(arrays["caches"], sel["blocks"],
                                          index0)
        new_arrays = dict(arrays, caches=caches, logits=sel["logits"],
                          index=index0 + beam_width)
        if ctx is not None:
            new_arrays["ctx"] = sel["ctx"]
        return new_arrays, sel["tokens"]

    # ------------------------------------------------------------------
    # shared windowed rollout segment (crossing + steady sliding phases)
    # ------------------------------------------------------------------

    def _windowed_rollout_segment(self, arrays, rng, beam_width,
                                  num_beam, settings: SamplerSettings,
                                  n_cached, window, init_len, gen0, kind):
        """One best-of-B segment once the sliding window is (or becomes)
        active, with the window's SHARED slots kept at N rows.

        ``kind='crossing'``: the segment starts in cached mode -- the first
        ``n_cached`` steps run through the shared-prefix KV path, the rest
        through shared windowed recompute.  ``kind='steady'``: the window
        already slid (``n_cached == 0``).  Returns (windowed-kind arrays for
        the selected rollout, winning tokens (N, bw))."""
        model = self.model
        use_pos = model.cfg.use_pos_cond
        crossing = kind == "crossing"
        c0 = init_len + gen0  # context length at segment start
        cross_kv = arrays["cross_kv"]
        if crossing:
            n = arrays["logits"].shape[0]
            device = arrays["logits"].device
            ctx = arrays["ctx"]
            # conditioning-grid slots keep pos == slot, generated slots get
            # the sampler's generation offset
            slots = torch.arange(c0, dtype=torch.float32, device=device)
            pos_full = slots + torch.where(
                slots >= init_len, float(settings.pos_offset), 0.0)
            pos0 = arrays["index"] + settings.pos_offset
        else:
            tok_shared = arrays["tok_buf"]
            pos_shared_full = arrays["pos_buf"]
            n = tok_shared.shape[0]
            device = tok_shared.device
            pos0 = arrays["pos_next"]
        nb = n * num_beam
        draw = _draws(_rollout_rng(rng, num_beam), c0, beam_width,
                      model.cfg.out_dim)
        logp = torch.zeros(nb, device=device)
        seg_tokens = torch.zeros(nb, 0, dtype=torch.long, device=device)

        # -- part A: pre-slide steps via the shared-prefix KV path
        if n_cached > 0:
            packed = model.pack_decode()
            cross_split = (model.presplit_cross_kv(cross_kv)
                           if model.cfg.use_encoder else None)
            block_caches = model.init_block_cache(nb, n_cached)
            logits = _tile(arrays["logits"], num_beam)
            index0 = arrays["index"]
            cap = arrays["caches"][0]["k"].shape[-1]
            read_caches = self._read_views(
                arrays["caches"], min(cap, _ceil32(c0)),
                flat=self._flat_segment(num_beam, n_cached))
            toks = []
            for j in range(n_cached):
                token, p = _sample(logits, draw, settings, slot=c0 + j)
                pos_val = (index0 + j + settings.pos_offset) if use_pos \
                    else None
                logits, block_caches = model.decode_step_shared(
                    token, read_caches, block_caches, index0, j,
                    cross_kv_split=cross_split, pos_cond_value=pos_val,
                    packed=packed)
                logp = logp + _log_prob(p)
                toks.append(token)
            seg_tokens = torch.stack(toks, dim=1)

        # -- part B: slid steps via shared windowed recompute
        for s in range(n_cached, beam_width):
            s0 = window - 1 - s
            if crossing:
                sh_tok = ctx[:, c0 - s0:c0]
                sh_pos = (pos_full[None, c0 - s0:c0].expand(n, s0)
                          if use_pos else None)
            else:
                sh_tok = tok_shared[:, s:]
                sh_pos = pos_shared_full[:, s:] if use_pos else None
            if s == 0:
                logits_n = model.window_forward(
                    sh_tok, pos_cond=sh_pos, cross_kv=cross_kv,
                    last_only=True)[:, 0]
                logits = _tile(logits_n, num_beam)
            else:
                blk_pos = None
                if use_pos:
                    blk_pos = (pos0 + torch.arange(
                        s, dtype=torch.float32, device=device)).expand(nb, s)
                logits = model.window_forward_shared(
                    sh_tok, seg_tokens, shared_pos_cond=sh_pos,
                    block_pos_cond=blk_pos, cross_kv=cross_kv)
            token, p = _sample(logits, draw, settings, slot=c0 + s)
            logp = logp + _log_prob(p)
            seg_tokens = torch.cat([seg_tokens, token[:, None]], dim=1)

        # -- selection on the device, then rebuild the windowed state
        winner = torch.argmax(logp.reshape(n, num_beam), dim=1)
        sel = _select_beam(seg_tokens, winner, num_beam)
        keep = (window - 1) - beam_width  # shared slots that remain
        if crossing:
            tail_tok = ctx[:, c0 - keep:c0]
            tail_pos = pos_full[None, c0 - keep:c0].expand(n, keep)
        else:
            tail_tok = tok_shared[:, beam_width:]
            tail_pos = pos_shared_full[:, beam_width:]
        new_pos = pos0 + torch.arange(beam_width, dtype=torch.float32,
                                      device=device)
        new_arrays = {
            "tok_buf": torch.cat([tail_tok, sel], dim=1),
            "pos_buf": torch.cat([tail_pos, new_pos.expand(n, beam_width)],
                                 dim=1),
            "cross_kv": cross_kv,
            "pos_next": pos0 + beam_width,
        }
        return new_arrays, sel

    # ------------------------------------------------------------------
    # windowed state / segment
    # ------------------------------------------------------------------

    @staticmethod
    def _windowed_from_cached(arrays, window, init_len, gen_count,
                              pos_offset=0):
        """Conversion at the first slide: the reference drops the first
        token and runs on the remaining (window - 1) with their absolute
        positions.  ``pos_next`` is the position of the next generated
        token."""
        ctx = arrays["ctx"]
        n = ctx.shape[0]
        slots = torch.arange(1, window, dtype=torch.float32,
                             device=ctx.device)
        pos = slots + torch.where(slots >= init_len, float(pos_offset), 0.0)
        return {"tok_buf": ctx[:, 1:window],
                "pos_buf": pos[None].expand(n, window - 1).clone(),
                "cross_kv": arrays["cross_kv"],
                "pos_next": init_len + gen_count + pos_offset}

    def _windowed_segment(self, arrays, rng, num_steps,
                          settings: SamplerSettings):
        """Steady-state sliding decode over a full (W-1)-slot buffer."""
        model = self.model
        tok_buf, pos_buf, pos_next = (arrays["tok_buf"], arrays["pos_buf"],
                                      arrays["pos_next"])
        logp = torch.zeros(tok_buf.shape[0], device=tok_buf.device)
        # pos_next is the position of the token being generated: its global
        # slot plus the sampler's offset
        draws = _draws(rng, pos_next - settings.pos_offset, num_steps,
                       model.cfg.out_dim)
        tokens = []
        for _ in range(num_steps):
            logits = model.window_forward(
                tok_buf, pos_cond=pos_buf, cross_kv=arrays["cross_kv"],
                last_only=True)[:, 0]
            token, prob = _sample(logits, draws, settings,
                                  slot=pos_next - settings.pos_offset)
            tok_buf = torch.cat([tok_buf[:, 1:], token[:, None]], dim=1)
            pos_buf = torch.cat(
                [pos_buf[:, 1:],
                 torch.full_like(pos_buf[:, :1], float(pos_next))], dim=1)
            logp = logp + _log_prob(prob)
            tokens.append(token)
            pos_next += 1
        new_arrays = dict(arrays, tok_buf=tok_buf, pos_buf=pos_buf,
                          pos_next=pos_next)
        return new_arrays, torch.stack(tokens, dim=1), logp

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @staticmethod
    def _grow_cache(arrays, new_len):
        """Pad the slot axis (last for caches and scales) to ``new_len``."""
        caches = [{key: F.pad(value, (0, new_len - value.shape[-1]))
                   for key, value in c.items()} for c in arrays["caches"]]
        return dict(arrays, caches=caches)

    def init_state(self, init_tokens, num_new_tokens, x_enc=None,
                   sliding_window=None):
        init_len = init_tokens.shape[1]
        if self.model.cfg.use_pos_cond:
            if sliding_window is None:
                raise ValueError("use_pos_cond model needs sliding_window")
            if init_len >= sliding_window:
                raise ValueError(
                    "conditioning grid must be shorter than the sliding "
                    f"window (init_len={init_len} >= {sliding_window})")
            # cached while context < window; cache sized for that phase
            total = min(init_len + num_new_tokens, sliding_window)
            first = _bucket_schedule(init_len, total)
            arrays = self._cached_init(init_tokens, first, x_enc,
                                       ctx_size=sliding_window)
            return DecodeState(mode="cached", arrays=arrays,
                               init_len=init_len, window=sliding_window,
                               cache_len=first, total_len=total)
        total = init_len + num_new_tokens
        first = _bucket_schedule(init_len, total)
        arrays = self._cached_init(init_tokens, first, x_enc, ctx_size=0)
        return DecodeState(mode="cached", arrays=arrays, init_len=init_len,
                           cache_len=first, total_len=total)

    def _cached_run(self, state: DecodeState, rng, num_steps, settings):
        """Cached-mode steps with bucketed cache growth (per-row keys pass
        through unchanged: the slot fold tells the steps apart)."""
        parts, logp = [], 0
        remaining = num_steps
        while remaining > 0:
            used = state.init_len + state.gen_count
            capacity = state.cache_len - used
            if capacity <= 0:
                new_len = _bucket_schedule(used + 1, state.total_len)
                state.arrays = self._grow_cache(state.arrays, new_len)
                state.cache_len = new_len
                capacity = state.cache_len - used
            k = min(remaining, capacity)
            state.arrays, tokens, seg_logp = self._cached_segment(
                state.arrays, rng, k, settings)
            state.gen_count += k
            remaining -= k
            parts.append(tokens)
            logp = logp + seg_logp
        return torch.cat(parts, dim=1), logp

    def segment(self, state: DecodeState, rng, num_steps, settings):
        """Generate ``num_steps`` tokens from ``state`` (mutating it);
        returns (tokens (N, steps), logp (N,))."""
        if state.window is None:
            return self._cached_run(state, rng, num_steps, settings)

        # hybrid: cached until the context reaches the window size
        n_cached_left = max(
            0, (state.window - state.init_len) - state.gen_count)
        parts, logp = [], 0
        if state.mode == "cached":
            k = min(num_steps, n_cached_left)
            if k > 0:
                tokens, seg_logp = self._cached_run(state, rng, k, settings)
                parts.append(tokens)
                logp = logp + seg_logp
            if state.gen_count >= state.window - state.init_len \
                    and num_steps > k:
                state.arrays = self._windowed_from_cached(
                    state.arrays, state.window, state.init_len,
                    state.gen_count, pos_offset=settings.pos_offset)
                state.mode = "windowed"
            num_steps -= k
        if num_steps > 0:
            state.arrays, tokens, seg_logp = self._windowed_segment(
                state.arrays, rng, num_steps, settings)
            state.gen_count += num_steps
            parts.append(tokens)
            logp = logp + seg_logp
        return torch.cat(parts, dim=1), logp

    @torch.inference_mode()
    def generate(self, init_tokens, num_new_tokens, rng, settings,
                 x_enc=None, sliding_window=None):
        """Single-path generation (training-preview decode); returns
        (N, num_new_tokens) tokens.  ``rng``: a ``torch.Generator`` or
        per-row keys (N, 2)."""
        state = self.init_state(init_tokens, num_new_tokens, x_enc=x_enc,
                                sliding_window=sliding_window)
        tokens, _ = self.segment(state, rng, num_new_tokens, settings)
        return tokens

    @torch.inference_mode()
    def rollout_generate(self, init_tokens, num_new_tokens, rng, settings,
                         num_beam, beam_width, x_enc=None,
                         sliding_window=None):
        """Best-of-``num_beam`` rollout decode (reference beam search),
        batched over a beam axis.  ``rng``: a ``torch.Generator`` (all rows
        draw together) or per-row keys (N, 2) (rollout ``b`` of row ``n``
        draws slot ``s`` from ``fold_in(fold_in(rng[n], b), s)``).  Returns
        (N, num_new_tokens) context tokens."""
        if num_new_tokens % beam_width != 0:
            raise ValueError("Invalid value for beam_width!")
        n = init_tokens.shape[0]
        state = self.init_state(init_tokens, num_new_tokens, x_enc=x_enc,
                                sliding_window=sliding_window)
        if self.quantized_prefix:
            state.arrays = dict(state.arrays, caches=quantize_caches(
                state.arrays["caches"]))
        out = []
        for _ in range(num_new_tokens // beam_width):
            # shared-prefix fast path: the whole segment stays cached
            cached_left = (num_new_tokens if state.window is None else
                           max(0, (state.window - state.init_len)
                               - state.gen_count))
            if state.mode == "cached" and beam_width <= cached_left:
                needed = state.init_len + state.gen_count + beam_width
                if needed > state.cache_len:
                    new_len = _bucket_schedule(needed, state.total_len)
                    state.arrays = self._grow_cache(state.arrays, new_len)
                    state.cache_len = new_len
                state.arrays, tokens = self._rollout_segment(
                    state.arrays, rng, beam_width, num_beam, settings,
                    prefix_len=state.init_len + state.gen_count)
                state.gen_count += beam_width
                out.append(tokens)
                continue

            # shared windowed path (crossing + steady sliding segments)
            if (not self.legacy_windowed_rollouts
                    and state.window is not None
                    and beam_width < state.window):
                if state.mode == "cached":
                    n_cached = cached_left
                    needed = state.init_len + state.gen_count + n_cached
                    if n_cached > 0 and needed > state.cache_len:
                        new_len = _bucket_schedule(needed, state.total_len)
                        state.arrays = self._grow_cache(state.arrays,
                                                        new_len)
                        state.cache_len = new_len
                    state.arrays, tokens = self._windowed_rollout_segment(
                        state.arrays, rng, beam_width, num_beam,
                        settings, n_cached=n_cached, window=state.window,
                        init_len=state.init_len, gen0=state.gen_count,
                        kind="crossing")
                    state.mode = "windowed"
                else:
                    state.arrays, tokens = self._windowed_rollout_segment(
                        state.arrays, rng, beam_width, num_beam,
                        settings, n_cached=0, window=state.window,
                        init_len=state.init_len, gen0=state.gen_count,
                        kind="steady")
                state.gen_count += beam_width
                out.append(tokens)
                continue

            # legacy path (beam_width >= window, or the option): tile the
            # full state, decode, gather the winner (an int8 prefix converts
            # back once)
            if self.quantized_prefix and state.mode == "cached":
                state.arrays = dict(state.arrays, caches=dequantize_caches(
                    state.arrays["caches"]))
            tiled = DecodeState(mode=state.mode,
                                arrays=_tile(state.arrays, num_beam),
                                init_len=state.init_len,
                                gen_count=state.gen_count,
                                window=state.window,
                                cache_len=state.cache_len,
                                total_len=state.total_len)
            tokens, logp = self.segment(tiled, _rollout_rng(rng, num_beam),
                                        beam_width, settings)
            winner = torch.argmax(logp.reshape(n, num_beam), dim=1)
            state.arrays = _select_beam(tiled.arrays, winner, num_beam)
            state.mode = tiled.mode
            state.gen_count = tiled.gen_count
            state.cache_len = tiled.cache_len
            out.append(_select_beam(tokens, winner, num_beam))
        return torch.cat(out, dim=1)
