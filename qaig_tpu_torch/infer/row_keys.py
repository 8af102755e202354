"""Per-row sampling keys: the port's counterpart of the ``jax.random`` keys
that ``qaig_tpu`` folds for row-keyed (composition-invariant) sampling.

A key is two 32-bit words in the last dim of an int64 tensor (shape
(..., 2), values in [0, 2**32)).  :func:`fold_in` derives a child key from
a key and a 32-bit integer; :func:`random_bits` gives ``count`` 32-bit words
per key.  Both are a fixed counter-based integer hash (murmur3's finalizer
over the key words and the counter), so a row's draws depend only on its
own key and the indices folded into it: not on the other rows of the
batch, and with the same bits on the CPU and on CUDA (integer ops only).
Every product of two 32-bit words is split into 16-bit halves, so no
intermediate reaches 2**63 in int64.

Draws from logits are Gumbel-max, ``argmax(logits + gumbel(keys, K))``,
which is also how ``jax.random.categorical`` draws.  The numbers are not
JAX's (threefry); the property is: a row's tokens are a function of its
own key.
"""

import torch

M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2**32 for 32-bit words ``x`` and a 32-bit constant
    ``c``: the high half of x times c stays below 2**48, and so does the low
    half's product."""
    return (((((x >> 16) * c) & 0xFFFF) << 16) + (x & 0xFFFF) * c) & M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _mix(k0, k1, data):
    """Two hashed words from a key's words and a 32-bit counter; every
    output bit depends on all three inputs."""
    d = data & M32
    a = _fmix32(k0 ^ _mul32(d, 0x9E3779B1))
    b = _fmix32(k1 ^ a ^ _mul32((d + 0x7F4A7C15) & M32, 0xCC9E2D51))
    return _fmix32(a ^ _mul32(b, 0x1B873593)), b


def key(seed):
    """The (2,) key of an integer seed (CPU int64)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64)


def fold_in(keys, data):
    """Child keys ``(..., 2)`` of ``keys`` (..., 2) and ``data`` (a Python
    int or an integer tensor broadcastable to ``keys[..., 0]``)."""
    a, b = _mix(keys[..., 0], keys[..., 1], data)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def random_bits(keys, count):
    """``count`` 32-bit words per key: (..., count) int64."""
    counter = torch.arange(count, dtype=torch.int64, device=keys.device)
    # the second word is tagged so that a key's bits never equal the words
    # of the keys folded from it
    return _mix(keys[..., :1], keys[..., 1:] ^ 0x5BD1E995, counter)[0]


def uniform(keys, count):
    """``count`` float32 draws per key, strictly inside (0, 1): the top 24
    bits of each word plus one half, over 2**24.  The top word's draw,
    which rounds to 1 in float32, is the largest float32 below 1,
    ``1 - 2**-24``, so that :func:`gumbel` stays finite (about 16.6) and
    cannot lift a masked entry (log 1e-38) past a real one; every other
    word's draw is the same either way."""
    bits = random_bits(keys, count) >> 8
    u = (bits.to(torch.float32) + 0.5) * (2.0 ** -24)
    return torch.clamp(u, max=1.0 - 2.0 ** -24)


def gumbel(keys, count):
    """``count`` standard Gumbel draws per key: -log(-log(u)).  A draw
    from logits is ``argmax(logits + gumbel)`` (Gumbel-max)."""
    return -torch.log(-torch.log(uniform(keys, count)))


def randint(keys, high):
    """One integer in [0, high) per key (high < 2**31): the top of
    ``bits * high``."""
    if not 0 < high < 2 ** 31:
        raise ValueError(f"randint: high {high} outside (0, 2**31)")
    return (random_bits(keys, 1)[..., 0] * high) >> 32
