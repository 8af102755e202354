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
tensor products that XLA's einsums form there.  Its form and geometry
(threads, fixed rows a block, streamed tile, head-dim split, ring stages)
come from :func:`backward_launch_plan`, which the kernel checks against
what it was built with.
"""

import ctypes
import math

import torch

from qaig_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims the kernels instantiate
HEAD_DIMS = (8, 16, 32, 64, 128, 192, 256)
_MAX_S = 65535 * 64  # grid y holds 64-row tiles
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
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


# float32 backward at dh 32-256: (streamed tile, ring depth) by head dim,
# as flash_attention_bwd.cu's F32Layout builds them
F32_BACKWARD_GEOMETRY = {32: (64, 1), 64: (64, 2), 128: (64, 2),
                         192: (32, 2), 256: (32, 1)}


def backward_launch_plan(dtype, dh, s, heads, n, sm_count=132):
    """Form and geometry of the backward kernel pair for a head dim, from
    the shape alone (the kernel refuses a plan it was not built with).

    ``form``: ``"bf16_mma_dh8"`` (``mma.sync`` m16n8k8, 8 warps of 16 rows,
    mirrored row groups), ``"bf16_mma"`` (``mma.sync`` m16n8k16, 4 warps of
    16 rows), ``"f32_rows"`` (dh 8 and 16: a row in the registers of dh / 8
    lanes, streamed keys broadcast from shared memory) or ``"f32_fma"``
    (dh 32-256: register-blocked float32 FMAs, 16 x 16 threads of 4 x 4
    micro-tiles); ``rows`` fixed rows a block (queries in pass 1, keys in
    pass 2), ``tile`` streamed rows a tile, ``split`` head-dim parts on
    grid z (``bf16_mma``),
    ``stages`` ring slots, ``cluster`` CTAs that share a block's streamed
    rows (``f32_fma``: 2 when a pass has fewer blocks than the card has
    SMs, ``sm_count``, and at least two streamed tiles), ``grid`` (x counts
    the clusters' CTAs; both passes), ``smem1`` / ``smem2`` bytes of
    dynamic shared memory."""
    return _backward_plan(dtype, dh, s, heads, n, sm_count, None)


def _backward_plan(dtype, dh, s, heads, n, sm_count, cluster):
    """:func:`backward_launch_plan`; ``cluster`` 1 or 2 forces the
    ``f32_fma`` cluster size (phase 3 of ``chip_smoke.py`` times the one
    the plan did not take), None chooses."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"backward_launch_plan: no head dim {dh}")
    f32 = dtype in (torch.float32, "f32", "float32")
    bh = n * heads
    chosen, cluster = cluster, cluster or 1
    if not f32 and dh == 8:
        form, threads, rows, tile, split = "bf16_mma_dh8", 256, 128, 256, 1
        stages = 1
        smem1 = smem2 = 0
    elif not f32:
        form, threads, rows = "bf16_mma", 128, 64
        tile = 32 if dh >= 192 else 64
        split = 2 if dh >= 128 else 1
        stages = 4 if dh <= 64 else 2
        smem1 = smem2 = ((2 * 64 + 2 * stages * tile) * (dh + 8) * 2
                         + stages * tile * 8)
    elif dh <= 16:
        form, threads, rows, tile, split = "f32_rows", 128, 128 * 8 // dh, \
            128, 1
        stages = 1
        smem1 = smem2 = 0
    else:
        form, threads, rows = "f32_fma", 256, 64
        tile, stages = F32_BACKWARD_GEOMETRY[dh]
        split = 1
        ld = dh + 4
        fixed = 2 * rows * ld + rows * (tile + 4)
        smem1 = (fixed + 2 * stages * tile * ld) * 4
        smem2 = (fixed + 2 * stages * tile * (ld + 1)) * 4
        if chosen is None and -(-s // tile) >= 2 \
                and bh * -(-s // rows) < sm_count:
            cluster = 2
    return {"form": form, "threads": threads, "rows": rows, "tile": tile,
            "split": split, "stages": stages, "cluster": cluster,
            "grid": (bh * cluster, -(-s // rows), split),
            "smem1": smem1, "smem2": smem2}


def fused_flash_attention_backward(q, k, v, out, dout, heads, causal):
    """The backward kernel: (dq, dk, dv) of :func:`flash_attention` at
    (q, k, v) with saved output ``out`` and output gradient ``dout``, all
    (N, S, H*dh) in q's dtype on one CUDA device (any card of the process:
    the launch runs there); the function of
    :func:`flash_attention_backward`.  ``dout`` may be non-contiguous (as
    autograd hands it over).  Two launches (dq; dk and dv) with float32
    (N, H, S) scratch for each row's log-sum-exp and delta, in the geometry
    of :func:`backward_launch_plan`."""
    grads = _backward(q, k, v, out, dout, heads, causal)
    fused_flash_attention_backward.launches += 1
    return grads


fused_flash_attention_backward.launches = 0


def _backward(q, k, v, out, dout, heads, causal, plan=None):
    """The backward kernel in :func:`backward_launch_plan`'s geometry, or
    in ``plan`` (a ``_backward_plan`` of another cluster size, for
    timing); not counted."""
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
    if plan is None:
        plan = backward_launch_plan(q.dtype, d // heads, s, heads, n,
                                    cuda_build.sm_count(q.device))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lse2, delta = (torch.empty(n, heads, s, dtype=torch.float32,
                               device=q.device) for _ in range(2))
    fn = cuda_build.function("flash_attention_bwd",
                             "qaig_flash_attention_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), lse2.data_ptr(), delta.data_ptr(), n, s,
                 heads, d // heads, int(causal), _DTYPES[q.dtype],
                 plan["rows"], plan["tile"], plan["split"], plan["stages"],
                 plan["cluster"], cuda_build.stream_handle(q))
    cuda_build.check("flash_attention_bwd", err)
    return dq, dk, dv


def _launch(q, k, v, heads, causal):
    _check_kernel_inputs(q, k, v, heads)
    n, s, d = q.shape
    out = torch.empty_like(q)
    fn = cuda_build.function("flash_attention", "qaig_flash_attention_fwd",
                             _ARGTYPES)
    with torch.cuda.device(q.device):
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
