"""Faults planted in the program underneath a run, to show that the
comparison catches them: the fault test drives runs on the CPU with each
one, and ``tools/readings.py --fault`` reads them on the card at a cell's
own size.  Each takes ``patch(owner, name, value)`` (pytest's
``monkeypatch.setattr``, or :class:`Patches`) and plants itself."""

import math

import torch


class Patches:
    """``patch(owner, name, value)`` that puts everything back on
    ``undo()``."""

    def __init__(self):
        self.saved = []

    def __call__(self, owner, name, value):
        self.saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        for owner, name, value in reversed(self.saved):
            setattr(owner, name, value)
        self.saved.clear()


def token_altered(patch):
    """Row 0's sampled token moves to the next one, where it is drawn."""
    from qaig_tpu_torch.infer import decode
    sample = decode._sample

    def altered(logits, rng, s, slot=None):
        token, p = sample(logits, rng, s, slot)
        token = token.clone()
        token[0] = s.index_shift + (token[0] - s.index_shift + 1) % s.end_token
        return token, p
    patch(decode, "_sample", altered)


def half_batch(patch):
    """The cascade computes the first half of its rows and repeats them."""
    from qaig_tpu_torch.infer.pipeline import CascadePipeline
    images = CascadePipeline._images

    def half(self, num_images, row_keys, temperature, init_tokens=None,
             clock=None):
        keep = max(1, num_images // 2)
        im, tok = images(self, keep, row_keys[:keep], temperature,
                         clock=clock)
        reps = -(-num_images // keep)
        return (im.repeat(reps, 1, 1, 1)[:num_images],
                tok.repeat(reps, 1)[:num_images])
    patch(CascadePipeline, "_images", half)


def state_unchanged(patch):
    """Every rollout step after a stage's first returns the first step's
    logits: the decode state does not move."""
    from qaig_tpu_torch.models.transformer import Transformer
    step = Transformer.decode_step_shared

    def stale(self, token, *args, **kwargs):
        logits, blocks = step(self, token, *args, **kwargs)
        first = getattr(self, "_first_logits", None)
        if first is None or first.shape != logits.shape:
            self._first_logits = logits
            return logits, blocks
        return first, blocks
    patch(Transformer, "decode_step_shared", stale)


def wrong_rows(patch):
    """Each request gets its neighbour's rows of the dispatch."""
    from qaig_tpu_torch.infer.pipeline import CascadePipeline
    generate = CascadePipeline.generate

    def rolled(self, *args, **kwargs):
        images, tokens = generate(self, *args, **kwargs)
        return images.roll(1, 0), tokens.roll(1, 0)
    patch(CascadePipeline, "generate", rolled)


def no_update(patch):
    """The train step's optimizer leaves the parameters and its state as
    they are."""
    patch(torch.optim.Adam, "step", lambda self, *a, **k: None)


def _tokenize(patch, fault):
    from qaig_tpu_torch.train import transformer
    tokenize = transformer.tokenize_batch

    def broken(*args, **kwargs):
        hr_in, lr_in, hr_tgt, pos = tokenize(*args, **kwargs)
        if fault == "half":
            h = hr_in.shape[0] // 2
            return hr_in[:h], lr_in[:h], hr_tgt[:h], pos[:h]
        hr_tgt = hr_tgt.clone()
        hr_tgt[:, 0] = (hr_tgt[:, 0] + 1) % (hr_tgt.max() + 1)
        return hr_in, lr_in, hr_tgt, pos
    patch(transformer, "tokenize_batch", broken)


def train_half_batch(patch):
    """Half of each step's batch left out, the loss the mean of the rest."""
    _tokenize(patch, "half")


def train_token_altered(patch):
    """Each sample's first target token moves to the next, where the
    tokens are made."""
    _tokenize(patch, "token")


def _counted(wrapper, original):
    """``wrapper`` in ``original``'s place keeps the launch counters that
    the program reads and bumps through the name."""
    for name in ("launches", "backward_calls"):
        if hasattr(original, name):
            setattr(wrapper, name, getattr(original, name))
    return wrapper


def attn_score_scale(patch):
    """Self-attention's scores come out ``sqrt(dh)`` times too large
    (kernel A's softmax scale left out), in the forward and so in
    kernel A''s backward."""
    from qaig_tpu_torch.ops import flash_attention as fa
    attend = fa.flash_attention

    def unscaled(q, k, v, heads, causal=False):
        return attend(q * math.sqrt(q.shape[-1] // heads), k, v, heads,
                      causal)
    patch(fa, "flash_attention", _counted(unscaled, attend))


def attn_dqdk_unscaled(patch):
    """Kernel A''s dQ and dK come out without the softmax scale
    ``1/sqrt(dh)``; dV is right."""
    from qaig_tpu_torch.ops import flash_attention as fa

    def broken(backward):
        def wrong(q, k, v, out, dout, heads, causal):
            dq, dk, dv = backward(q, k, v, out, dout, heads, causal)
            factor = math.sqrt(q.shape[2] // heads)
            return dq * factor, dk * factor, dv
        return _counted(wrong, backward)
    for name in ("fused_flash_attention_backward", "flash_attention_backward"):
        patch(fa, name, broken(getattr(fa, name)))


def decode_attn_unscaled(patch):
    """Kernel B's scores come out ``sqrt(dh)`` times too large (its
    softmax scale ``1/sqrt(dh)`` left out) in every rollout step's decode
    attention over the shared prefix and the segment."""
    from qaig_tpu_torch.ops import decode_attention as da
    attend = da.shared_prefix_attention_fused_t

    def unscaled(q, kt_shared, vt_shared, k_block, v_block, index0,
                 block_index):
        return attend(q * math.sqrt(kt_shared.shape[2]), kt_shared,
                      vt_shared, k_block, v_block, index0, block_index)
    patch(da, "shared_prefix_attention_fused_t", _counted(unscaled, attend))


def codes_shifted(patch):
    """The pixel decode looks each served token up one row off in the
    codebook (token ``t`` reads code ``t + 1``): the tokens are right and
    the images are not."""
    from qaig_tpu_torch.models.codebook import Codebook
    lookup = Codebook.get_quantized_image

    def shifted(self, indices, *args, **kwargs):
        return lookup(self, (indices + 1) % self.codebook.shape[0], *args,
                      **kwargs)
    patch(Codebook, "get_quantized_image", shifted)


CASCADE = {"token_altered": token_altered, "half_batch": half_batch,
           "state_unchanged": state_unchanged,
           "decode_attn_unscaled": decode_attn_unscaled,
           "codes_shifted": codes_shifted}
SERVE = {"token_altered": token_altered, "wrong_rows": wrong_rows,
         "decode_attn_unscaled": decode_attn_unscaled,
         "codes_shifted": codes_shifted}
TRAIN = {"state_unchanged": no_update, "half_batch": train_half_batch,
         "token_altered": train_token_altered,
         "attn_score_scale": attn_score_scale,
         "attn_dqdk_unscaled": attn_dqdk_unscaled}
