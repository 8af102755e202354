"""The comparisons that decide a run's ``correct``, each a number held to a
limit of its own (``limits/<cell>.json``), and the control's readings.

Generation (:func:`cascade_readings`): for each checked image the plain
reference runs every stage once over the image's served tokens
(teacher-forced, the sliding window as the decode slides it) and recomputes
the sampling noise from the image's row key.  A served token was drawn as
``argmax(log p_T + g)`` over the tempered probabilities with <end> masked
and the Gumbel noise ``g`` of its rollout; its gap is how far its score
lies below the best score under the reference's logits.  All tokens of a
segment come from one rollout: the one whose noise gives the segment's
tokens the least widest gap.  ``token_gap_mean`` is the mean gap of every
checked token under its segment's rollout, the number that sets a
precision apart; ``token_gap``, the widest of them, swings from seed to
seed by its nature and is held to a gross limit that a few wrong tokens
fail (``PERF.md``).  ``pixel_err``, held to a gross limit that wrong
pixels fail, is the root-mean-square difference between the served pixels
and the reference's decode of the served tokens over all checked images,
relative to the root mean square of that decode.

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
    """{"token_gap_mean", "token_gap", "pixel_err"} over the checked
    images, and with ``control`` also the control's (the same names with
    ``.control``: the reference in float8 in the program's place).

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
    widest, summed, count = [0.0, 0.0], [0.0, 0.0], 0   # program, control
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
            gaps = _stage_gaps(scores, c_scores if control else None,
                               served, skeys, st, device)
            for j, g in enumerate(gaps):
                widest[j] = max(widest[j], _worst(g))
                summed[j] += float(g.sum())
            count += gaps[0].numel()
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
    out = {"token_gap_mean": summed[0] / max(count, 1),
           "token_gap": widest[0],
           "pixel_err": math.sqrt(sums[0] / max(sums[1], 1e-30))}
    if control:
        out.update({"token_gap_mean.control": summed[1] / max(count, 1),
                    "token_gap.control": widest[1],
                    "pixel_err.control": math.sqrt(sums[2]
                                                   / max(sums[1], 1e-30))})
    return out


def _worst(values):
    """The largest value, a NaN counting as infinite."""
    return float(torch.nan_to_num(values, nan=math.inf).max())


def _gaps(scores, tokens):
    """How far the scores of ``tokens`` lie below the best score: 0 where
    a token's score is the best."""
    return scores.amax(-1) - scores.gather(-1, tokens)[..., 0]


def _stage_gaps(scores, c_scores, served, skeys, st, device):
    """The gaps (N, T) of one stage's served tokens over a block of images,
    each segment under the noise of the rollout that gives its tokens the
    least widest gap, and with ``c_scores`` the gaps of the control's
    first choices under the same noise."""
    n, total, vocab = scores.shape
    beams, width = st["num_beam"], st["beam_width"]
    rows = torch.arange(n, device=device)
    gaps, c_gaps = [], []
    for s0 in range(0, total, width):
        noise = _noise(skeys, beams, 1 + s0, width, vocab)
        sc = scores[:, None, s0:s0 + width] + noise          # (N, B, w, V)
        tok = served[:, None, s0:s0 + width, None].expand(n, beams, width, 1)
        tok_gaps = _gaps(sc, tok)                             # (N, B, w)
        winner = torch.nan_to_num(tok_gaps, nan=math.inf).amax(-1).argmin(1)
        gaps.append(tok_gaps[rows, winner])                   # (N, w)
        if c_scores is not None:
            cs = c_scores[:, s0:s0 + width] + noise[rows, winner]
            c_gaps.append(_gaps(sc[rows, winner],
                                cs.argmax(-1, keepdim=True)))
    return [torch.cat(g, 1) for g in (gaps, c_gaps) if g]


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
