"""Operations and bytes of the model's work, counted from the
configuration's shapes and the traffic, never from the program's
schedule: no cache capacity, bucket or padding enters a count.

Generation follows the decode as ``qaig_tpu`` defines it:

* every token each rollout computes passes every decoder layer once, and
  its attention reads the positions present (the shared prefix and the
  rollout's own segment so far), not a cache's capacity;
* the encoder and the cross-attention K/V run once per image per stage;
* once the window slides, each step recomputes the window's ``W - 1``
  tokens: the slots shared by an image's rollouts once per image, the
  rollout's own segment once per rollout, and in the last layer only the
  final query (all the K/V);
* a position's conditioning (its MLP, AdaLN and gate projections) is
  computed once per decode step, as every row of a step shares the
  position, and once per row and token where rows carry their own
  positions (prefill, window recompute, training);
* the pixel decode's convolutions.

A product of an (m, k) by a (k, n) matrix counts ``2 m k n``.  Sampling,
norms, softmax and elementwise work are not counted.  Training counts the
forward's products three times (the backward computes the gradient of
each operand), less the input gradient of the conditioning MLP's first
layer (its input is a sinusoid, which needs none), and the BMU's distance
products once; recompute is never counted.

The decode-attention work (:func:`decode_attention_launches`) and the
flash-attention work of training (:func:`flash_attention_work`) count each
input byte read once and each output byte written once.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class Shapes:
    """The widths one transformer of a configuration runs at."""
    d: int
    hidden: int
    vocab: int
    dec_layers: int
    enc_layers: int
    use_encoder: bool
    use_pos_cond: bool


def mlp2(rows, a, b, c):
    return 2 * rows * (a * b + b * c)


def lin(rows, a, b):
    return 2 * rows * a * b


def _blocks(sh):
    return 3 if sh.use_encoder else 2


def cond_flops(sh, rows, last_q_rows=None):
    """A position's conditioning over ``rows`` rows: the position MLP, and
    per decoder layer each block's AdaLN scale and shift and its gate.  In
    the last layer of a window recompute only ``last_q_rows`` rows go on
    past the self-attention's norm (the K/V's)."""
    if not sh.use_pos_cond:
        return 0
    d, blocks = sh.d, _blocks(sh)
    per_row = blocks * 3 * lin(1, d, d)
    last = (per_row * rows if last_q_rows is None else
            2 * lin(rows, d, d) + (per_row - 2 * lin(1, d, d)) * last_q_rows)
    return (mlp2(rows, d, sh.hidden, d) + (sh.dec_layers - 1) * per_row
            * rows + last)


def dec_layer_flops(sh, rows, ctx_sum, enc_len, q_rows=None):
    """One decoder layer over ``rows`` token rows whose self-attention
    reads ``ctx_sum`` positions in all; only ``q_rows`` of them (all by
    default) go on past the K/V projections (the last layer of a window
    recompute).  Conditioning is :func:`cond_flops`'."""
    d, h = sh.d, sh.hidden
    q_rows = rows if q_rows is None else q_rows
    f = 2 * mlp2(rows, d, h, d)                      # K and V
    f += mlp2(q_rows, d, h, d) + 4 * d * ctx_sum + lin(q_rows, d, d)
    if sh.use_encoder:
        f += mlp2(q_rows, d, h, d) + 4 * d * enc_len * q_rows \
            + lin(q_rows, d, d)
    f += mlp2(q_rows, d, h, d) + lin(q_rows, d, d)   # FFN
    return f


def classifier_flops(sh, rows):
    return mlp2(rows, sh.d, sh.hidden, sh.vocab)


def encoder_flops(sh, rows, length):
    """Encoder over ``rows`` sequences of ``length`` tokens, and the cross
    K/V of every decoder layer from its output."""
    if not sh.use_encoder:
        return 0
    d, h = sh.d, sh.hidden
    tokens = rows * length
    per_layer = (3 * mlp2(tokens, d, h, d) + 4 * d * length * tokens
                 + 2 * lin(tokens, d, d) + mlp2(tokens, d, h, d))
    return (sh.enc_layers * per_layer
            + sh.dec_layers * 2 * mlp2(tokens, d, h, d))


def causal_sum(first, count):
    """Positions read by ``count`` causal queries, the first of which reads
    ``first``."""
    return count * first + count * (count - 1) // 2


def window_step_flops(sh, n, beams, shared, block, enc_len):
    """One step of a slid window: ``shared`` slots at ``n`` rows, then
    ``block`` segment tokens per rollout (``block`` 0: the whole window at
    ``n`` rows, its last token the query)."""
    f = 0
    layers = sh.dec_layers
    if block == 0:
        f += cond_flops(sh, n * shared, last_q_rows=n)
        f += (layers - 1) * dec_layer_flops(sh, n * shared,
                                            n * causal_sum(1, shared),
                                            enc_len)
        f += dec_layer_flops(sh, n * shared, n * shared, enc_len, q_rows=n)
        return f + classifier_flops(sh, n)
    nb = n * beams
    f += cond_flops(sh, n * shared, last_q_rows=0)
    f += cond_flops(sh, nb * block, last_q_rows=nb)
    # the shared stream: every layer but the last, and the last's K/V
    f += (layers - 1) * dec_layer_flops(sh, n * shared,
                                        n * causal_sum(1, shared), enc_len)
    f += 2 * mlp2(n * shared, sh.d, sh.hidden, sh.d)
    # the segment: every layer; the last only for its final query
    f += (layers - 1) * dec_layer_flops(
        sh, nb * block, nb * causal_sum(shared + 1, block), enc_len)
    f += dec_layer_flops(sh, nb * block, nb * (shared + block), enc_len,
                         q_rows=nb)
    return f + classifier_flops(sh, nb)


def stage_schedule(init_len, total, beam_width, window):
    """The decode's segments: [(context at start, steps through the
    prefix path, steps through the window)] of one stage."""
    segments = []
    for g0 in range(0, total, beam_width):
        c0 = init_len + g0
        if window is None or c0 + beam_width <= window:
            segments.append((c0, beam_width, 0))
        elif beam_width >= window:
            raise NotImplementedError("a beam segment as wide as the window")
        else:
            cached = max(0, window - c0)
            segments.append((c0, cached, beam_width - cached))
    return segments


def stage_flops(sh, n, init_len, total, beams, beam_width, window, enc_len):
    """Products of one stage's decode of ``n`` images."""
    f = encoder_flops(sh, n, enc_len)
    # prefill: the conditioning grid, its last position classified
    f += cond_flops(sh, n * init_len)
    f += sh.dec_layers * dec_layer_flops(sh, n * init_len,
                                         n * causal_sum(1, init_len),
                                         enc_len)
    f += classifier_flops(sh, n)
    nb = n * beams
    for c0, cached, slid in stage_schedule(init_len, total, beam_width,
                                           window):
        for j in range(cached):
            f += cond_flops(sh, 1)
            f += sh.dec_layers * dec_layer_flops(sh, nb, nb * (c0 + j + 1),
                                                 enc_len)
            f += classifier_flops(sh, nb)
        for s in range(cached, cached + slid):
            f += window_step_flops(sh, n, beams, window - 1 - s, s, enc_len)
    return f


def pixel_flops(ae, latent_hw, n):
    """The FC decoder's convolutions over ``n`` latents."""
    h, w = latent_hw
    f = 0
    specs = [(ae["latent_channel"], ae["max_channel"], "conv"),
             (ae["max_channel"], ae["max_channel"], "conv")]
    curr = ae["max_channel"]
    for _ in range(ae["num_layers"]):
        specs.append((curr, curr, "conv"))
        nxt = max(curr // 2, ae["min_channel"])
        specs.append((curr, nxt, "up"))
        curr = nxt
    specs.append((curr, ae["image_channel"], "conv"))
    for cin, cout, kind in specs:
        if kind == "up":
            f += 2 * cin * cout * 16 * h * w * n
            h, w = 2 * h, 2 * w
        else:
            f += 2 * cin * cout * 9 * h * w * n
    return f


def cascade_shapes(config):
    """[(Shapes, init_len, total, enc_len, window, beams, beam_width)] of
    each stage of a cascade configuration."""
    k = config["num_embeddings"]
    ih, iw = config["image_H"], config["image_W"]
    seqs = [(ih // ph) * (iw // pw) for ph, pw in config["codebook_patches"]]
    out = []
    for i, st in enumerate(config["stages"]):
        sh = Shapes(d=config["in_dim"], hidden=config["hidden_dim"],
                    vocab=k + 1, dec_layers=config["num_dec_layers"],
                    enc_layers=(config["num_enc_layers"]
                                if st["use_encoder"] else 0),
                    use_encoder=st["use_encoder"],
                    use_pos_cond=st["use_sliding_window"])
        window = config["sliding_window"] if st["use_sliding_window"] \
            else None
        out.append((sh, seqs[i] if not st["use_encoder"] else 1,
                    seqs[i + 1], seqs[i] if st["use_encoder"] else 0,
                    window, st["num_beam"], st["beam_width"]))
    return out


def cascade_flops(config, n):
    """Products of one call generating ``n`` images."""
    f = 0
    for sh, init_len, total, enc_len, window, beams, bw in \
            cascade_shapes(config):
        f += stage_flops(sh, n, init_len, total, beams, bw, window, enc_len)
    latent = (config["image_H"], config["image_W"])
    return f + pixel_flops(config["autoencoder"], latent, n)


def decode_attention_launches(config, n, itemsize=2):
    """[(operations, bytes)] of every decode-attention launch of one call
    of ``n`` images: each rollout step's attention of every layer over the
    shared prefix and the rollout's segment so far.  Reads q, the prefix's
    K and V once per image, the segments' K and V; writes the output."""
    out = []
    for sh, init_len, total, enc_len, window, beams, bw in \
            cascade_shapes(config):
        d, nb = sh.d, n * beams
        for c0, cached, _ in stage_schedule(init_len, total, bw, window):
            for j in range(cached):
                ops = 4 * nb * d * (c0 + j + 1)
                nbytes = itemsize * (2 * nb * d + 2 * n * d * c0
                                     + 2 * nb * d * (j + 1))
                out.extend([(ops, nbytes)] * sh.dec_layers)
    return out


def train_shapes(config):
    k = config["num_embeddings"]
    return Shapes(d=config["in_dim"], hidden=config["hidden_dim"],
                  vocab=k + 1, dec_layers=config["num_dec_layers"],
                  enc_layers=config["num_enc_layers"], use_encoder=True,
                  use_pos_cond=config["use_sliding_window"])


def _train_lengths(config):
    ih, iw = config["image_H"], config["image_W"]
    lr = (ih // config["lr_patch"][0]) * (iw // config["lr_patch"][1])
    hr = (ih // config["hr_patch"][0]) * (iw // config["hr_patch"][1])
    seq = hr + 1
    if config["use_sliding_window"]:
        seq = config["sliding_window"]
    return lr, hr, seq


def train_step_flops(config, n):
    """Products of one training step at batch ``n``."""
    sh = train_shapes(config)
    lr, hr, seq = _train_lengths(config)
    k, c = config["num_embeddings"], config["image_C"]
    d_lr = c * config["lr_patch"][0] * config["lr_patch"][1]
    d_hr = c * config["hr_patch"][0] * config["hr_patch"][1]
    bmu = 2 * n * (lr * k * d_lr + hr * k * d_hr)
    fwd = encoder_flops(sh, n, lr)
    fwd += cond_flops(sh, n * seq)
    fwd += sh.dec_layers * dec_layer_flops(sh, n * seq,
                                           n * causal_sum(1, seq), lr)
    fwd += classifier_flops(sh, n * seq)
    no_grad_input = lin(n * seq, sh.d, sh.hidden) if sh.use_pos_cond else 0
    return 3 * fwd - no_grad_input + bmu


def flash_attention_work(config, n, itemsize=4):
    """[(operations, bytes)] of the self-attention of one training step,
    forward and backward, of every encoder and decoder layer."""
    sh = train_shapes(config)
    lr, _, seq = _train_lengths(config)
    out = []
    for layers, length, causal in ((sh.enc_layers, lr, False),
                                   (sh.dec_layers, seq, True)):
        reads = causal_sum(1, length) if causal else length * length
        fwd_ops = 4 * n * sh.d * reads
        io = n * length * sh.d * itemsize
        out.extend([(fwd_ops, 4 * io), (2 * fwd_ops, 8 * io)] * layers)
    return out


def least_seconds(work, peak_flops, peak_bytes):
    """The least time of a list of (operations, bytes) launches: each
    bound by the larger of its operations over the peak rate and its
    bytes over the memory bandwidth."""
    return sum(max(ops / peak_flops, nbytes / peak_bytes)
               for ops, nbytes in work)
