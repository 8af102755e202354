"""Float32 linear layers on the tensor cores at float32 accuracy.

:func:`linear_f32` is ``F.linear`` for the port's layers.  On the card a
float32 product whose operands TMA can read goes to the hand-written Hopper
kernel of ``qaig_tpu_torch/csrc/linear_f32.cu``: three-pass ("split") TF32
on ``wgmma``, each float32 operand ``x = hi + lo`` in two TF32 numbers
rounded to nearest, ``hi.hi + hi.lo + lo.hi`` on the tensor cores; each
K-step's main term ``hi.hi`` is summed from zero and added to the
accumulator with a float32 add, the small terms in an accumulator of
their own, and the main terms' rounding toward zero is made good on
average.
Its error is float32's (``tests/test_torch_port_kernels.py`` holds it to
1.25x cuBLAS's float32 norm-wise error against a float64 product at every
product shape of the windowed stage's training step).  The backward of
:class:`LinearF32` runs ``dX = dY W`` and ``dW = dY^T X`` through the same
kernel; ``db`` is ``dY`` summed over rows, as ``F.linear``'s backward sums
it.

The shape rule (:func:`takes`), decided only by what the call sees: a
float32 CUDA product goes to the kernel when ``in`` and ``out`` features are
multiples of 4, x's rows are 16-byte aligned and the weight is contiguous
and 16-byte aligned (TMA's stride and address rule, for all three
products), and it has at least 512 rows (below that cuBLAS is faster on an
H100); any other float32 CUDA product goes to ``F.linear`` and counts in
``linear_f32.fallbacks`` (the classifier's 513 outputs, and the decode
steps of small batches, for two).
bf16 and float16 never reach the kernel (nor a call under autocast), and
a CPU tensor always runs ``F.linear``, the plain version.  ``linear_f32.launches`` counts the
kernel's products (each also launches a split of its B operand, and a
second launch that adds K-split partial sums where :func:`launch_plan`
splits K).

:func:`linear_f32_emulated` repeats the kernel's split arithmetic on the
CPU (TF32 rounding of both parts, each K-step's main term exactly and
rounded to float32, added in float32; the small terms apart) for the
error tests.
"""

import ctypes

import torch
import torch.nn.functional as F

from qaig_tpu_torch.ops import cuda_build

TILE_ROWS = 128    # output rows of one tile (64 per consumer warpgroup)
TILE_COLS = 128    # output columns of one tile
K_BLOCK = 32       # K a stage of the kernel's ring
K_STEP = 8         # K of one wgmma: the main term's partial sums
MAX_SPLITS = 32    # K-splits of a product whose tiles leave SMs idle
MIN_SPLIT_BLOCKS = 4  # K-blocks each split keeps at least
MIN_ROWS = 512     # fewer rows go to cuBLAS (the crossover on an H100)
ALIGN = 4          # in / out features and row strides: multiples of 16 bytes
_F32 = torch.float32
# qaig_linear_f32: a, lda, a_mn, bhi, blo, ldb, bias, out, c_rs, c_cs, ws,
# M, N, K, splits, grid, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]
# qaig_linear_f32_split: src, lds, R, C, transpose, permute, rp, hi, lo,
# stream
_SPLIT_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p] * 3


def launch_plan(m, n, k, sm_count):
    """(K-splits, persistent blocks) of the product C (m, n) = A (m, k) .
    B (n, k)^T.  A block takes one 128 x 128 output tile at a time; where
    the tiles leave SMs idle, K is split over up to ``MAX_SPLITS`` blocks
    a tile (each keeping at least ``MIN_SPLIT_BLOCKS`` K-blocks of 32) so
    the units fill the card."""
    tiles = -(-m // TILE_ROWS) * -(-n // TILE_COLS)
    kblocks = -(-k // K_BLOCK)
    splits = 1
    if tiles < sm_count:
        splits = max(1, min(sm_count // tiles, kblocks // MIN_SPLIT_BLOCKS,
                            MAX_SPLITS))
        per = -(-kblocks // splits)
        splits = -(-kblocks // per)
    return splits, min(tiles * splits, sm_count)


def takes(x, weight, bias=None):
    """The shape rule: whether the kernel takes ``F.linear(x, weight,
    bias)`` (the device aside).  Float32 throughout, in and out features
    multiples of 4, at least ``MIN_ROWS`` rows, x's rows (flattened to
    2-D, last dim contiguous) and the contiguous weight 16-byte aligned.
    Under 512 rows cuBLAS's SIMT product is the faster (device time on an
    H100 at in 512, out 2048, kernel / cuBLAS: 256 rows 0.0308 / 0.0284 ms,
    1024 rows 0.0427 / 0.0548 ms): the float32 decode steps of small
    batches."""
    if x.dtype != _F32 or weight.dtype != _F32 or (
            bias is not None and bias.dtype != _F32):
        return False
    if weight.ndim != 2 or x.ndim < 1:
        return False
    out_f, in_f = weight.shape
    if x.shape[-1] != in_f or in_f % ALIGN or out_f % ALIGN \
            or x.numel() < MIN_ROWS * in_f:
        return False
    if not weight.is_contiguous() or weight.data_ptr() % 16:
        return False
    x2d = x.reshape(-1, in_f)   # rows with a column stride are copied
    return x2d.stride(-1) != 1 or (x2d.stride(0) % ALIGN == 0
                                   and x2d.data_ptr() % 16 == 0)


def linear_f32(x, weight, bias=None):
    """``F.linear(x, weight, bias)``: the kernel for float32 CUDA products
    it takes (:func:`takes`), ``F.linear`` for everything else."""
    if x.device.type != "cuda" or x.dtype != _F32 \
            or torch.is_autocast_enabled("cuda"):
        return F.linear(x, weight, bias)
    if not takes(x, weight, bias):
        linear_f32.fallbacks += 1
        return F.linear(x, weight, bias)
    x2d = x.reshape(-1, x.shape[-1])
    if x2d.stride(-1) != 1:
        x2d = x2d.contiguous()
    y = LinearF32.apply(x2d, weight, bias)
    return y.reshape(*x.shape[:-1], weight.shape[0])


# kernel products (forward, dX and dW each count one), and float32 CUDA
# calls the shape rule sent to F.linear
linear_f32.launches = 0
linear_f32.fallbacks = 0


class LinearF32(torch.autograd.Function):
    """``F.linear`` on 2-D ``x``, its three products through
    :func:`_product` (the kernel on CUDA tensors, plain products on CPU
    tensors); ``db`` sums ``dY`` over rows."""

    @staticmethod
    def forward(ctx, x, weight, bias=None):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return _product(x, weight, bias, "forward")

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _product(dy, weight, None, "grad_input")
        if ctx.needs_input_grad[1]:
            dw = _product(dy, x, None, "grad_weight")
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.sum(0)
        return dx, dw, db


def _product(a, b, bias, kind):
    """forward: ``a (M, K) . b (N, K)^T + bias``; grad_input: ``a (M, N) .
    b (N, K)``; grad_weight: ``a (M, N)^T . b (M, K)``."""
    if a.device.type != "cuda":
        if kind == "forward":
            return F.linear(a, b, bias)
        return a @ b if kind == "grad_input" else a.t() @ b
    m = a.shape[0]
    if kind == "forward":
        n, k = b.shape
        hi, lo = _split(b, transpose=False)
        out = torch.empty(m, n, dtype=_F32, device=a.device)
        _gemm(a, False, hi, lo, bias, out, (n, 1), m, n, k)
    elif kind == "grad_input":
        n, k = b.shape            # dY (M, N) . W (N, K): reduced over N
        hi, lo = _split(b, transpose=True, permute=False)
        out = torch.empty(m, k, dtype=_F32, device=a.device)
        _gemm(a, False, hi, lo, None, out, (k, 1), m, k, n)
    else:
        n, k = a.shape[1], b.shape[1]   # dW (N, K), reduced over M
        out = torch.empty(n, k, dtype=_F32, device=a.device)
        if k <= n:   # C = dW: A = dY^T (M-major), B = X^T split
            hi, lo = _split(b, transpose=True, permute=True)
            _gemm(a, True, hi, lo, None, out, (k, 1), n, k, m)
        else:        # C = dW^T, stored transposed: A = X^T, B = dY^T split
            hi, lo = _split(a, transpose=True, permute=True)
            _gemm(b, True, hi, lo, None, out, (1, k), k, n, m)
    return out


def _split(src, transpose, permute=False):
    """The TF32 split (hi, lo) of ``src`` (R, C), or of its transpose,
    (C, R rounded up to 8) with zeros past R, each 8 of R permuted as the
    kernel's M-major A fragments read them where ``permute``."""
    r, c = src.shape
    shape = (c, -(-r // 8) * 8) if transpose else (r, c)
    hi = torch.empty(shape, dtype=_F32, device=src.device)
    lo = torch.empty(shape, dtype=_F32, device=src.device)
    fn = cuda_build.function("linear_f32", "qaig_linear_f32_split",
                             _SPLIT_ARGTYPES)
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), src.stride(0), r, c, int(transpose),
                 int(permute), shape[1], hi.data_ptr(), lo.data_ptr(),
                 cuda_build.stream_handle(src))
    cuda_build.check("linear_f32", err)
    return hi, lo


def _gemm(a, a_mn, hi, lo, bias, out, c_strides, m, n, k):
    """C (m, n) = A . B^T (+ bias) into ``out`` at strides ``c_strides``;
    A is ``a`` (m, k), or stored (k, m) where ``a_mn``; B is (hi, lo)
    (n, >= k)."""
    splits, grid = launch_plan(m, n, k, cuda_build.sm_count(a.device))
    ws = None
    if splits > 1:
        ws = torch.empty(splits, m, n, dtype=_F32, device=a.device)
    fn = cuda_build.function("linear_f32", "qaig_linear_f32", _ARGTYPES)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), a.stride(0), int(a_mn), hi.data_ptr(),
                 lo.data_ptr(), hi.shape[1],
                 None if bias is None else bias.contiguous().data_ptr(),
                 out.data_ptr(), c_strides[0], c_strides[1],
                 None if ws is None else ws.data_ptr(), m, n, k, splits,
                 grid, cuda_build.stream_handle(a))
    cuda_build.check("linear_f32", err)
    linear_f32.launches += 1


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero (``cvt.rna.tf32.f32``), in a float32 tensor."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(_F32)


def tf32_split(x):
    """(hi, lo): ``x = hi + lo`` in two TF32 numbers, as the kernel splits
    (lo is 0 where x is not finite)."""
    hi = tf32_round(x)
    rest = torch.where(torch.isfinite(x), x - hi, torch.zeros_like(x))
    return hi, tf32_round(rest)


def linear_f32_emulated(a, b, bias=None):
    """The kernel's arithmetic on the CPU: ``a (M, K) . b (N, K)^T (+
    bias)`` from the TF32 splits of both: each K-step of 8's main term
    ``hi.hi`` exact (in float64), rounded to float32 and added to a float32
    accumulator in order; the small terms ``lo.hi + hi.lo`` summed apart
    and added once at the end; the bias last.  (The tensor cores round the
    main terms toward zero, which the kernel compensates for on average;
    this rounds them to nearest.  The error tests on the card hold the
    kernel itself.)"""
    a_hi, a_lo = (t.double() for t in tf32_split(a.to(_F32)))
    b_hi, b_lo = (t.double() for t in tf32_split(b.to(_F32)))
    k = a.shape[1]
    acc = torch.zeros(a.shape[0], b.shape[0], dtype=_F32)
    for k0 in range(0, k, K_STEP):
        s = slice(k0, min(k, k0 + K_STEP))
        acc = acc + (a_hi[:, s] @ b_hi[:, s].T).to(_F32)
    small = (a_lo @ b_hi.T + a_hi @ b_lo.T).to(_F32)
    out = acc + small
    return out if bias is None else out + bias.to(_F32)


def flops(m, n, k):
    """Float32-accurate operations of one product (2 m n k; the kernel's
    TF32 passes do three times as many)."""
    return 2 * m * n * k


def bound_ms(m, n, k):
    """The least time of a product on an H100: the three TF32 passes at
    495 TFLOP/s, or its bytes (A, B's two split copies, C once) at
    3.35 TB/s, whichever is longer."""
    ops = 3 * flops(m, n, k)
    nbytes = 4 * (m * k + 2 * n * k + m * n)
    return max(ops / 495e12, nbytes / 3.35e12) * 1e3

