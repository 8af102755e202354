"""Full-sequence self-attention (counterpart of
``qaig_tpu/ops/flash_attention.py``).

On a CUDA tensor, the forward of :func:`flash_attention` launches the
hand-written Hopper kernel of ``qaig_tpu_torch/csrc/flash_attention.cu``
(K/V tiles streamed through shared memory by ``cp.async``, online float32
softmax, bf16 products on ``mma.sync``, float32 on register-blocked FMAs;
ragged S and the causal mask handled in the kernel, so no padding).  On a
CPU tensor it runs :func:`flash_attention_reference`, the plain PyTorch
version of the same function.  There is no other route: a CUDA input the
kernel does not take raises.  The kernel reads and writes the projections'
(N, S, H*dh) layout directly.

Routing, decided from the shape alone (:func:`supported`, as
``qaig_tpu/ops/flash_attention.py::supported`` routes what its Pallas
kernel does not take to XLA einsums): the kernel instantiates head dims 8,
16, 32, 64, 128, 192 and 256, and
:func:`qaig_tpu_torch.ops.attention.dot_product_attention` sends any other
head dim to its plain products, on every device.  The Pallas kernel takes
every multiple of 64 (and no smaller head dim); this one takes those up to
256, past which a warp's 16 rows of the output no longer fit in its
registers.

The gradient is the JAX package's ``custom_vjp`` backward (``_flash_bwd``):
the log-sum-exp is recomputed from the saved (q, k, v, out) and dq, dk, dv
are formed in float32.  On CUDA tensors it launches
:func:`fused_flash_attention_backward`, the hand-written kernel pair of
``qaig_tpu_torch/csrc/flash_attention_bwd.cu`` (no (S, S) tensor in device
memory; bf16 on ``mma.sync`` at every head dim, float32 on exact FMAs);
on CPU tensors it runs :func:`flash_attention_backward`, the plain
tensor products that XLA's einsums form there.
"""

import ctypes
import math

import torch

from qaig_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims the kernels instantiate
HEAD_DIMS = (8, 16, 32, 64, 128, 192, 256)
_MAX_S = 65535 * 4   # grid y holds the backward's 4-row tiles past dh 128
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p])


def supported(q, k, v, heads, causal, kv_mask, q_offset):
    """The calls :func:`qaig_tpu_torch.ops.attention.dot_product_attention`
    sends here: self-attention over equal (N, S, D) shapes with no key mask
    and no query offset, at a head dim in :data:`HEAD_DIMS`.  Decided from
    the shapes alone, before any launch, on every device."""
    del causal
    if kv_mask is not None or q_offset is not None:
        return False
    if q.shape != k.shape or k.shape != v.shape:
        return False
    return q.shape[-1] % heads == 0 and q.shape[-1] // heads in HEAD_DIMS


def _split(x, heads):
    """(N, S, H*dh) -> float32 (N, H, S, dh)."""
    n, s, d = x.shape
    return x.to(torch.float32).reshape(n, s, heads, d // heads).transpose(
        1, 2)


def _merge(x, like):
    """(N, H, S, dh) -> (N, S, H*dh) in ``like``'s dtype."""
    return x.transpose(1, 2).reshape(like.shape).to(like.dtype)


def _scores(q, k, heads, causal):
    """Scaled float32 scores (N, H, S, S), future keys -inf when causal."""
    s = q.shape[1]
    scores = (_split(q, heads) @ _split(k, heads).transpose(-1, -2)) * (
        1.0 / math.sqrt(q.shape[2] // heads))
    if causal:
        future = torch.ones(s, s, dtype=torch.bool,
                            device=q.device).triu(1)
        scores = scores.masked_fill(future, float("-inf"))
    return scores


def flash_attention_reference(q, k, v, heads, causal=False):
    """Plain PyTorch attention over (N, S, D) tensors, float32 softmax,
    output in q's dtype."""
    probs = torch.softmax(_scores(q, k, heads, causal), dim=-1)
    return _merge(probs @ _split(v, heads), q)


def flash_attention_backward(q, k, v, out, dout, heads, causal):
    """Gradients (dq, dk, dv) of :func:`flash_attention_reference` at
    (q, k, v) with output ``out`` and output gradient ``dout``, all
    (N, S, D): ``_flash_bwd`` of the JAX package, in float32, returned in
    the inputs' dtypes."""
    scale = 1.0 / math.sqrt(q.shape[2] // heads)
    scores = _scores(q, k, heads, causal)
    lse = torch.logsumexp(scores, dim=-1, keepdim=True)  # recomputed
    p = torch.exp(scores - lse)
    qf, kf, vf, do, of = (_split(x, heads) for x in (q, k, v, dout, out))
    dv = p.transpose(-1, -2) @ do
    dp = do @ vf.transpose(-1, -2)
    delta = (do * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    return _merge(dq, q), _merge(dk, k), _merge(dv, v)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, causal):
        if q.device.type == "cpu":
            out = flash_attention_reference(q, k, v, heads, causal)
        else:
            out = _launch(q, k, v, heads, causal)
        ctx.save_for_backward(q, k, v, out)
        ctx.heads, ctx.causal = heads, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_attention_backward(q, k, v, out, dout, ctx.heads,
                                             ctx.causal)
        else:
            flash_attention.backward_calls += 1
            grads = fused_flash_attention_backward(q, k, v, out, dout,
                                                   ctx.heads, ctx.causal)
        return (*grads, None, None)


def flash_attention(q, k, v, heads, causal=False):
    """Self-attention over projected (N, S, D) tensors; returns (N, S, D)
    in q's dtype.  Kernel on CUDA tensors, plain version on CPU tensors;
    differentiable in q, k and v on both."""
    return _FlashAttention.apply(q, k, v, heads, bool(causal))


# kernel launches of the forward, and backward passes on CUDA tensors
flash_attention.launches = 0
flash_attention.backward_calls = 0


def fused_flash_attention_backward(q, k, v, out, dout, heads, causal):
    """The backward kernel: (dq, dk, dv) of :func:`flash_attention` at
    (q, k, v) with saved output ``out`` and output gradient ``dout``, all
    (N, S, H*dh) on the current CUDA device in q's dtype; the function of
    :func:`flash_attention_backward`.  ``dout`` may be non-contiguous (as
    autograd hands it over).  Two launches (dq; dk and dv) with float32
    (N, H, S) scratch for each row's log-sum-exp and delta."""
    _check_kernel_inputs(q, k, v, heads)
    dout = dout.contiguous()
    for name, x in (("out", out), ("dout", dout)):
        if x.device != q.device or x.dtype != q.dtype or x.shape != q.shape:
            raise ValueError(
                f"flash_attention backward: {name} must match q in device, "
                f"dtype and shape (q {tuple(q.shape)} {q.dtype}, {name} "
                f"{tuple(x.shape)} {x.dtype} {x.device})")
    if not out.is_contiguous():
        raise ValueError("flash_attention backward: out is not contiguous")
    if out.data_ptr() % 16 or dout.data_ptr() % 16:
        raise ValueError("flash_attention backward: inputs must be 16-byte "
                         "aligned")
    n, s, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lse2, delta = (torch.empty(n, heads, s, dtype=torch.float32,
                               device=q.device) for _ in range(2))
    fn = cuda_build.function("flash_attention_bwd",
                             "qaig_flash_attention_bwd", _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             lse2.data_ptr(), delta.data_ptr(), n, s, heads, d // heads,
             int(causal), _DTYPES[q.dtype], cuda_build.stream_handle(q))
    cuda_build.check("flash_attention_bwd", err)
    fused_flash_attention_backward.launches += 1
    return dq, dk, dv


fused_flash_attention_backward.launches = 0


def _launch(q, k, v, heads, causal):
    _check_kernel_inputs(q, k, v, heads)
    n, s, d = q.shape
    out = torch.empty_like(q)
    fn = cuda_build.function("flash_attention", "qaig_flash_attention_fwd",
                             _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             n, s, heads, d // heads, int(causal), _DTYPES[q.dtype],
             cuda_build.stream_handle(q))
    cuda_build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


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
    if dh not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: the kernel has no head dim {dh}; it takes "
            f"head dims {', '.join(map(str, HEAD_DIMS))}, and "
            f"dot_product_attention routes any other head dim to its plain "
            f"products (supported() is False)")
    if not 0 < q.shape[1] <= _MAX_S:
        raise ValueError(f"flash_attention: S {q.shape[1]} outside "
                         f"[1, {_MAX_S}]")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")
    if q.device.index != torch.cuda.current_device():
        raise ValueError("flash_attention: tensors are not on the current "
                         "CUDA device")
