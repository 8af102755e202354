"""The comparisons that decide a run's ``correct``, each a number held to a
limit of its own (``limits/<cell>.json``), and the control's readings.

Generation (:func:`cascade_readings`): for each checked image the plain
reference runs every stage once over the image's served tokens
(teacher-forced, the sliding window as the decode slides it) and recomputes
the sampling noise from the image's row key.  A served token was drawn as
``argmax(log p_T + g)`` over the tempered probabilities with <end> masked
and the Gumbel noise ``g`` of its rollout; its gap is how far its score
lies below the best score under the reference's logits.  All tokens of a
segment come from one rollout: the segment's gap is the least, over the
rollouts, of its tokens' widest gap.  ``token_gap`` is the widest segment
gap; ``pixel_err`` the root-mean-square difference between the served
pixels and the reference's decode of the served tokens over all checked
images, relative to the root mean square of that decode.

Training (:func:`train_readings`): each of the first steps' losses, the
first gradient as the optimizer holds it after one step, and the change
of the parameters over three steps, against the reference's, by the
worst leaf.
"""

import math
import statistics

import torch

from benchmark import reference as ref


def _stage_models(config, w, prec):
    models = []
    for i, st in enumerate(config["stages"]):
        models.append(ref.Model(
            w[f"stages.{i}."], config["self_attn_heads"],
            config["cross_attn_heads"], st["use_encoder"],
            st["use_sliding_window"], config["num_enc_layers"] if
            st["use_encoder"] else 0, config["num_dec_layers"], prec))
    return models


def _positions(ctx_len, init_len, offset, rows, device):
    slots = torch.arange(ctx_len, dtype=torch.float32, device=device)
    pos = slots + torch.where(slots >= init_len, float(offset), 0.0)
    return pos[None].expand(rows, ctx_len)


def stage_logits(model, ctx, init_len, enc, window, offset):
    """Logits (N, T, V) for every generated slot of context ``ctx``
    (N, init_len + T): slot ``c`` is predicted from the last ``window -
    1`` slots before it (all of them without a window), as the decode
    slides."""
    n, length = ctx.shape
    pos = (_positions(length, init_len, offset, n, ctx.device)
           if model.use_pos_cond else None)
    first_slid = length if window is None else window
    head = min(length - 1, first_slid - 1)
    out = [model.logits(ctx[:, :head], enc,
                        None if pos is None else pos[:, :head])
           [:, init_len - 1:]]
    for c in range(max(first_slid, init_len), length):
        w0 = c - (window - 1)
        out.append(model.logits(ctx[:, w0:c], enc, pos[:, w0:c]
                                if pos is not None else None)[:, -1:])
    return torch.cat(out, dim=1)


def _scores(logits, temperature, end_token):
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    probs[..., end_token] = 0.0
    return torch.log(torch.clamp(probs, min=1e-38))


def _noise(stage_keys, beams, first_slot, count, vocab):
    """Gumbel noise (N, B, count, V) of rollouts ``b`` at slots
    ``first_slot + j``, on the keys' device."""
    dev = stage_keys.device
    rollouts = ref.fold_in(stage_keys[:, None], torch.arange(
        beams, dtype=torch.int64, device=dev)[None])
    slots = torch.arange(first_slot, first_slot + count, dtype=torch.int64,
                         device=dev)
    return ref.gumbel(ref.fold_in(rollouts[:, :, None], slots[None, None]),
                      vocab)


def cascade_readings(config, weights, checked, device, control=False,
                     block=16):
    """{"token_gap", "pixel_err"} over the checked images, and with
    ``control`` also the control's (``token_gap.control``,
    ``pixel_err.control``: the reference in float8 in the program's place).

    ``checked``: dict of host tensors: ``seeds`` (M,) the seed of each
    image's call or request, ``rows`` (M,) its row there, ``stages`` a
    list of (M, T_i) served tokens of each stage (the last one the
    returned tokens), ``pixels`` (M, C, H, W) float32."""
    k = config["num_embeddings"]
    offset = config["sampler"]["pos_offset"]
    w = {f"stages.{i}.": weights.views(f"stages.{i}.")
         for i in range(len(config["stages"]))}
    w = {kk: {n: t.to(device) for n, t in v.items()} for kk, v in w.items()}
    models = _stage_models(config, w, ref.F32)
    ctrl_models = _stage_models(config, w, ref.Prec(fp8=True))
    dec_w = {n: t.to(device) for n, t in weights.views("decoder.").items()}
    codes = weights.views(f"codebooks.{len(config['codebook_patches']) - 1}."
                          )["codebook"].to(device)
    out = {"token_gap": 0.0, "pixel_err": 0.0}
    if control:
        out.update({"token_gap.control": 0.0, "pixel_err.control": 0.0})
    m = checked["seeds"].shape[0]
    sums = [0.0, 0.0, 0.0]     # squared differences, squared reference
    for lo in range(0, m, block):
        sl = slice(lo, min(m, lo + block))
        row_keys = torch.stack([
            ref.fold_in(ref.key(int(s)), int(r)) for s, r in
            zip(checked["seeds"][sl], checked["rows"][sl])])
        prev = None
        for i, st in enumerate(config["stages"]):
            served = checked["stages"][i][sl].to(device)
            n, total = served.shape
            skeys = ref.fold_in(row_keys, i).to(device)
            if not st["use_encoder"]:
                init = ref.randint(ref.fold_in(skeys, ref.INIT_TAG), k)
                ctx = torch.cat([init[:, None], served + k], 1)
                enc = None
            else:
                ctx = torch.cat([torch.full((n, 1), k, device=device,
                                            dtype=torch.long), served], 1)
                enc = prev
            window = (config["sliding_window"] if st["use_sliding_window"]
                      else None)
            temp = st["temperature"]
            with torch.no_grad():
                scores = _scores(stage_logits(models[i], ctx, 1, enc, window,
                                              offset), temp, k)
                if control:
                    c_scores = _scores(stage_logits(
                        ctrl_models[i], ctx, 1, enc, window, offset),
                        temp, k)
            gap, c_gap = _stage_gaps(scores, c_scores if control else None,
                                     served, skeys, st, device)
            out["token_gap"] = max(out["token_gap"], gap)
            if control:
                out["token_gap.control"] = max(out["token_gap.control"],
                                               c_gap)
            prev = served
        # pixels of the served final tokens
        with torch.no_grad():
            patch = tuple(config["codebook_patches"][-1])
            latent = ref.unpatchify(codes[prev], (config["image_H"],
                                                  config["image_W"]), patch)
            pixels = checked["pixels"][sl].to(device)
            px = ref.decode_pixels(dec_w, config["autoencoder"], latent)
            sums[0] += float((pixels - px).square().sum())
            sums[1] += float(px.square().sum())
            if control:
                pc = ref.decode_pixels(dec_w, config["autoencoder"], latent,
                                       ref.Prec(fp8=True))
                sums[2] += float((pc - px).square().sum())
    out["pixel_err"] = math.sqrt(sums[0] / max(sums[1], 1e-30))
    if control:
        out["pixel_err.control"] = math.sqrt(sums[2] / max(sums[1], 1e-30))
    return out


def _worst(values):
    """The largest value, a NaN counting as infinite."""
    return float(torch.nan_to_num(values, nan=math.inf).max())


def _gaps(scores, tokens):
    """How far the scores of ``tokens`` lie below the best score: 0 where
    a token's score is the best, infinite draws included (an infinite
    draw forces its token, in the program and the reference alike)."""
    best = scores.amax(-1)
    own = scores.gather(-1, tokens)[..., 0]
    return torch.where(own == best, torch.zeros_like(best), best - own)


def _stage_gaps(scores, c_scores, served, skeys, st, device):
    """(widest segment gap of the served tokens, widest gap of the
    control's first choices) of one stage over a block of images."""
    n, total, vocab = scores.shape
    beams, width = st["num_beam"], st["beam_width"]
    gap = 0.0
    c_gap = 0.0
    for s0 in range(0, total, width):
        noise = _noise(skeys, beams, 1 + s0, width, vocab)
        sc = scores[:, None, s0:s0 + width] + noise          # (N, B, w, V)
        tok = served[:, None, s0:s0 + width, None].expand(n, beams, width, 1)
        tok_gaps = _gaps(sc, tok)                             # (N, B, w)
        seg = tok_gaps.amax(-1)                               # (N, B)
        best, winner = seg.min(dim=1)
        gap = max(gap, _worst(best))
        if c_scores is not None:
            rows = torch.arange(n, device=device)
            own = sc[rows, winner]                            # (N, w, V)
            cs = c_scores[:, s0:s0 + width] + noise[rows, winner]
            first = cs.argmax(-1, keepdim=True)
            c_gap = max(c_gap, _worst(_gaps(own, first)))
    return gap, c_gap


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _worst_leaf(prog, refs, keep=None):
    """max over leaves of |norm(prog) - norm(ref)| / max(norm(ref), median
    leaf norm), over the leaves in ``keep`` (all without)."""
    names = [n for n in refs if keep is None or n in keep]
    norms = {n: float(refs[n].norm()) for n in names}
    median = statistics.median(norms.values())
    worst, worst_name = 0.0, None
    for n in names:
        d = abs(float(prog[n].norm()) - norms[n]) / max(norms[n], median,
                                                        1e-30)
        if math.isnan(d):
            d = math.inf
        if d > worst:
            worst, worst_name = d, n
    return worst, worst_name


def train_readings(prog, refr):
    """``loss_gap`` (worst relative gap of the steps' losses),
    ``grad_gap`` (first gradient, worst leaf) and ``update_gap`` (change
    over the steps, worst leaf among those whose reference gradient is a
    thousandth of the median leaf's or more).  ``prog`` / ``refr``: dicts
    with ``losses`` (list), ``grads`` ({name: tensor}) and ``deltas``
    ({name: tensor})."""
    loss_gap = max(math.inf if math.isnan(a) else abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], refr["losses"]))
    grad_norms = {n: float(g.norm()) for n, g in refr["grads"].items()}
    median = statistics.median(grad_norms.values())
    keep = {n for n, v in grad_norms.items() if v >= 1e-3 * median}
    grad_gap, grad_leaf = _worst_leaf(prog["grads"], refr["grads"])
    update_gap, update_leaf = _worst_leaf(prog["deltas"], refr["deltas"],
                                          keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": update_gap}, {"grad_leaf": grad_leaf,
                                        "update_leaf": update_leaf,
                                        "left_out": sorted(set(grad_norms)
                                                           - keep)}
