"""Full-sequence self-attention forward (counterpart of
``qaig_tpu/ops/flash_attention.py``).

On a CUDA tensor, :func:`flash_attention` launches the hand-written Hopper
kernel of ``qaig_tpu_torch/csrc/flash_attention.cu`` (tiled K/V in shared
memory, online float32 softmax, ragged S and the causal mask handled in the
kernel, so no padding).  On a CPU tensor it runs
:func:`flash_attention_reference`, the plain PyTorch version of the same
function.  There is no other route: a CUDA input the kernel does not take
raises.

The kernel reads and writes the projections' (N, S, H*dh) layout directly.
Only the forward is ported; the attention backward belongs to training.
"""

import ctypes
import math

import torch

from qaig_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def supported(q, k, v, heads, causal, kv_mask, q_offset):
    """The calls :func:`qaig_tpu_torch.ops.attention.dot_product_attention`
    sends here: self-attention over equal (N, S, D) shapes with no key mask
    and no query offset."""
    del causal
    if kv_mask is not None or q_offset is not None:
        return False
    if q.shape != k.shape or k.shape != v.shape:
        return False
    return q.shape[-1] % heads == 0


def flash_attention_reference(q, k, v, heads, causal=False):
    """Plain PyTorch attention over (N, S, D) tensors, float32 softmax,
    output in q's dtype."""
    n, s, d = q.shape
    dh = d // heads

    def split(x):
        return x.to(torch.float32).reshape(n, s, heads, dh).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    scores = (qh @ kh.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    if causal:
        future = torch.ones(s, s, dtype=torch.bool,
                            device=q.device).triu(1)
        scores = scores.masked_fill(future, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ vh
    return out.transpose(1, 2).reshape(n, s, d).to(q.dtype)


def flash_attention(q, k, v, heads, causal=False):
    """Self-attention over projected (N, S, D) tensors; returns (N, S, D)
    in q's dtype.  Kernel on CUDA tensors, plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, heads, causal)
    _check_kernel_inputs(q, k, v, heads)
    n, s, d = q.shape
    out = torch.empty_like(q)
    fn = cuda_build.function("flash_attention", "qaig_flash_attention_fwd",
                             _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             n, s, heads, d // heads, int(bool(causal)), _DTYPES[q.dtype],
             cuda_build.stream_handle(q))
    cuda_build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _check_kernel_inputs(q, k, v, heads):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype or x.shape != q.shape:
            raise ValueError(
                f"flash_attention: {name} must match q in device, dtype and "
                f"shape (q {tuple(q.shape)} {q.dtype} {q.device}, {name} "
                f"{tuple(x.shape)} {x.dtype} {x.device})")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype}")
    if q.ndim != 3 or q.shape[2] % heads:
        raise ValueError(
            f"flash_attention: q must be (N, S, H*dh), got {tuple(q.shape)} "
            f"with {heads} heads")
    dh = q.shape[2] // heads
    if dh not in _HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head dim {dh} not in {_HEAD_DIMS}")
    if q.shape[0] * heads > 65535:
        raise ValueError("flash_attention: N * heads exceeds the grid's "
                         "y dimension (65535)")
    if q.shape[1] == 0:
        raise ValueError("flash_attention: empty sequence")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
    if q.device.index != torch.cuda.current_device():
        raise ValueError("flash_attention: tensors are not on the current "
                         "CUDA device")
