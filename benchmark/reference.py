"""The plain reference: the cascade's mathematics in plain PyTorch, float32,
with no kernel, cache or batching of the program's.  It imports nothing of
``qaig_tpu_torch``, ``qaig_tpu`` or ``jax``, and takes its parameters by
name from the benchmark's own copy of the weights (``weights.Weights``).

What it follows (the upstream model, as ``qaig_tpu`` defines it):

* Q, K and V are 2-layer MLPs (activation after the first layer), heads
  are a split of the width, scores scale by ``1/sqrt(head dim)``, softmax
  in float32, no output projection;
* a residual applies its activation after the skip add; the DiT gate
  multiplies the branch input before its linear; AdaLN-Zero is
  ``scale(cond) * norm(x) + shift(cond)``; the FFN is activated on both
  layers; the classifier's first layer is always silu;
* sequence positions are sinusoidal from 1; a position-conditioned
  decoder adds a 2-layer MLP over the sinusoid of each slot's absolute
  position;
* the FC decoder: 3x3 convolutions and 4x4 transposed ones of stride 2,
  silu inside, tanh at the head.

``Prec`` says how every product is computed: float32 (the reference), or
in float8 e4m3 under a per-tensor scale (the control of a bfloat16
configuration: the next precision below): a linear layer or attention
product takes float8 operands and keeps its float32 sum, as a float8
tensor-core product computes; a convolution also writes its result in
float8, as a float8 convolution chain stores its activations.
"""

import math

import torch
import torch.nn.functional as F

M32 = 0xFFFFFFFF
LN_EPS = 1e-5


# ---------------------------------------------------------------------------
# precision of the products
# ---------------------------------------------------------------------------

class Prec:
    """How the reference computes its products: ``fp8`` rounds both
    operands of each to float8 e4m3 (per-tensor scale) and keeps the
    float32 sum, and a convolution's result too; otherwise plain
    float32."""

    def __init__(self, fp8=False):
        self.fp8 = fp8

    def q(self, t):
        if not self.fp8:
            return t
        scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)

    def conv(self, x, w, b, transposed=False):
        if transposed:
            return self.q(F.conv_transpose2d(self.q(x), self.q(w), b,
                                             stride=2, padding=1))
        return self.q(F.conv2d(self.q(x), self.q(w), b, padding=1))


F32 = Prec()


# ---------------------------------------------------------------------------
# row keys and Gumbel noise (the sampling keys' hash, written out again)
# ---------------------------------------------------------------------------

def _mul32(x, c):
    return (((((x >> 16) * c) & 0xFFFF) << 16) + (x & 0xFFFF) * c) & M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _mix(k0, k1, data):
    d = data & M32
    a = _fmix32(k0 ^ _mul32(d, 0x9E3779B1))
    b = _fmix32(k1 ^ a ^ _mul32((d + 0x7F4A7C15) & M32, 0xCC9E2D51))
    return _fmix32(a ^ _mul32(b, 0x1B873593)), b


def key(seed):
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64)


def fold_in(keys, data):
    a, b = _mix(keys[..., 0], keys[..., 1], data)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def _bits(keys, count):
    counter = torch.arange(count, dtype=torch.int64, device=keys.device)
    return _mix(keys[..., :1], keys[..., 1:] ^ 0x5BD1E995, counter)[0]


def gumbel(keys, count):
    """Standard Gumbel draws from the top 24 bits of each word; the top
    word, which rounds to 1 in float32, draws the largest float32 below
    1, so that every draw is finite."""
    u = ((_bits(keys, count) >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)
    u = torch.clamp(u, max=1.0 - 2.0 ** -24)
    return -torch.log(-torch.log(u))


def randint(keys, high):
    return (_bits(keys, 1)[..., 0] * high) >> 32


def request_keys(seed, rows, start=0):
    """Row ``j`` of a request (or a call) of seed ``seed``:
    ``fold_in(key(seed), start + j)``."""
    return fold_in(key(seed), torch.arange(start, start + rows,
                                           dtype=torch.int64))


INIT_TAG = 424242


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------

def sinusoid(dim, pos):
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=pos.device)
                      * -(math.log(10000.0) / (half - 1)))
    angles = pos.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def layer_norm(x):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS)


class Model:
    """One transformer of the cascade over parameters ``p`` (names as the
    port's and ``qaig_tpu``'s trees have them)."""

    def __init__(self, p, heads, cross_heads, use_encoder, use_pos_cond,
                 num_enc_layers, num_dec_layers, prec=F32):
        self.p = p
        self.heads = heads
        self.cross_heads = cross_heads
        self.use_encoder = use_encoder
        self.use_pos_cond = use_pos_cond
        self.num_enc = num_enc_layers
        self.num_dec = num_dec_layers
        self.prec = prec

    def lin(self, name, x):
        return self.prec.linear(x, self.p[name + ".weight"],
                                self.p[name + ".bias"])

    def mlp2(self, name, x, act_last=False):
        y = self.lin(name + ".l1", F.silu(self.lin(name + ".l0", x)))
        return F.silu(y) if act_last else y

    def norm(self, name, x, cond):
        if self.use_pos_cond and cond is not None:
            return (self.lin(name + ".scale", cond) * layer_norm(x)
                    + self.lin(name + ".shift", cond))
        return layer_norm(x) * self.p[name + ".weight"] + self.p[name +
                                                                 ".bias"]

    def residual(self, name, x, skip, cond):
        if cond is not None:
            x = x * self.lin(name + ".scale", cond)
        return F.silu(self.lin(name + ".linear", x) + skip)

    def attention(self, q, k, v, heads, causal):
        n, sq, d = q.shape
        dh = d // heads
        qh = q.reshape(n, sq, heads, dh).transpose(1, 2)
        kh = k.reshape(n, k.shape[1], heads, dh).transpose(1, 2)
        vh = v.reshape(n, v.shape[1], heads, dh).transpose(1, 2)
        scores = self.prec.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(dh)
        if causal:
            sk = k.shape[1]
            mask = torch.ones(sq, sk, dtype=torch.bool,
                              device=q.device).tril(sk - sq)
            scores = scores.masked_fill(~mask, float("-inf"))
        out = self.prec.matmul(torch.softmax(scores, dim=-1), vh)
        return out.transpose(1, 2).reshape(n, sq, d)

    def block(self, name, x, enc, cond, causal):
        sa = name + ".self_attn"
        xn = self.norm(sa + ".norm", x, cond)
        att = self.attention(self.mlp2(sa + ".attn.q", xn),
                             self.mlp2(sa + ".attn.k", xn),
                             self.mlp2(sa + ".attn.v", xn), self.heads,
                             causal)
        x = self.residual(sa + ".res", att, x, cond)
        if enc is not None:
            ca = name + ".cross_attn"
            xn = self.norm(ca + ".norm", x, cond)
            att = self.attention(self.mlp2(ca + ".attn.q", xn),
                                 self.mlp2(ca + ".attn.k", enc),
                                 self.mlp2(ca + ".attn.v", enc),
                                 self.cross_heads, False)
            x = self.residual(ca + ".res", att, x, cond)
        ff = name + ".ffn"
        xn = self.norm(ff + ".norm", x, cond)
        return self.residual(ff + ".res", self.mlp2(ff + ".ff", xn, True),
                             x, cond)

    def encode(self, enc_tokens):
        h = self.p["enc_embedding.weight"][enc_tokens]
        h = h + sinusoid(h.shape[-1], torch.arange(
            1, h.shape[1] + 1, device=h.device))
        for i in range(self.num_enc):
            h = self.block(f"encoder_layers.{i}", h, None, None, False)
        return h

    def logits(self, tokens, enc_tokens=None, pos=None):
        """Teacher-forced logits (N, S, out) of the decoder over ``tokens``
        (N, S), the encoder over ``enc_tokens`` and, for a
        position-conditioned model, the absolute positions ``pos``
        (N, S)."""
        enc = self.encode(enc_tokens) if self.use_encoder else None
        h = self.p["dec_embedding.weight"][tokens]
        h = h + sinusoid(h.shape[-1], torch.arange(
            1, h.shape[1] + 1, device=h.device))
        cond = None
        if self.use_pos_cond:
            cond = self.mlp2("pos_cond_layer", sinusoid(h.shape[-1], pos))
        for i in range(self.num_dec):
            h = self.block(f"decoder_layers.{i}", h, enc, cond, True)
        return self.mlp2("classifier", h)


# ---------------------------------------------------------------------------
# codebooks and the pixel decode
# ---------------------------------------------------------------------------

def patchify(x, patch):
    n, c, h, w = x.shape
    ph, pw = patch
    x = x.reshape(n, c, h // ph, ph, w // pw, pw).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(n, (h // ph) * (w // pw), c * ph * pw)


def unpatchify(patches, image_hw, patch):
    n, _, d = patches.shape
    (h, w), (ph, pw) = image_hw, patch
    c = d // (ph * pw)
    x = patches.reshape(n, h // ph, w // pw, c, ph, pw).permute(
        0, 3, 1, 4, 2, 5)
    return x.reshape(n, c, h, w)


def bmu(x, codes, patch):
    """(N, Seq) index of the nearest code (L2) of each patch."""
    patches = patchify(x, patch)
    n, s, d = patches.shape
    flat = patches.reshape(n * s, d)
    out = []
    for block in flat.split(4096):
        dist = ((block[:, None, :] - codes[None]) ** 2).sum(-1)
        out.append(dist.argmin(dim=1))
    return torch.cat(out).reshape(n, s)


def decoder_channels(ae):
    specs = [(ae["latent_channel"], ae["max_channel"], "conv"),
             (ae["max_channel"], ae["max_channel"], "conv")]
    curr = ae["max_channel"]
    for _ in range(ae["num_layers"]):
        specs.append((curr, curr, "conv"))
        nxt = max(curr // 2, ae["min_channel"])
        specs.append((curr, nxt, "up"))
        curr = nxt
    specs.append((curr, ae["image_channel"], "head"))
    return specs


def decode_pixels(p, ae, latent, prec=F32):
    """The FC decoder: latent (N, C, h, w) -> pixels (N, 3, H, W)."""
    x = latent
    for i, (_, _, kind) in enumerate(decoder_channels(ae)):
        w, b = p[f"layers.{i}.weight"], p[f"layers.{i}.bias"]
        x = prec.conv(x, w, b, transposed=kind == "up")
        x = torch.tanh(x) if kind == "head" else F.silu(x)
    return x
