"""Fused two-layer MLP, hidden kept on chip (counterpart of the kernel of
``scripts/probe_mlp_fused.py``).

``h = silu(x w0^T + b0)`` then, per split ``i``, ``out[i] = h[:, iH:(i+1)H]
w1[i]^T + b1[i]`` (silu on it too with ``act_last``): the packed Q/K/V
projection (S 3, act on the first layer) and the FFN (S 1, act on both)
of a transformer block.  The layout is the port's own, the one
``models/blocks.py::pack_qkv`` produces: ``w0 (S*H, D)``, ``b0 (S*H,)``,
``w1 (S, D2, H)``, ``b1 (S, D2)``; an FFN's ``MLP2`` enters as
``l1.weight[None]``.  The output is ``(S, N, D2)``.  The rounding points
are ``_mlp2_kernel``'s: float32 sums and biases, the hidden rounded to x's
dtype before the second product, the output rounded last.

On a CUDA tensor, :func:`mlp2_fused` launches the hand-written Hopper
kernel of ``qaig_tpu_torch/csrc/mlp2_fused.cu``; it takes bf16 only (the
TPU kernel's type; a float32 CUDA input raises ``ValueError``) and any
number of rows (the Pallas kernel's ``tile`` block size has no counterpart:
the ragged edge is masked).  On a CPU tensor it runs
:func:`mlp2_fused_reference`, the plain version, in any float dtype.
"""

import ctypes

import torch
import torch.nn.functional as F

from qaig_tpu_torch.ops import cuda_build

ROWS_PER_BLOCK = 64
HIDDEN_CHUNK = 64
OUT_DIMS = (64, 128, 256, 512)
MAX_SMEM = 232_448   # bytes of shared memory one block may use on an H100
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def mlp2_fused_reference(x, w0, b0, w1, b1, act_last=False):
    """Plain PyTorch version: (N, D) x, weights in the port's layout ->
    (S, N, D2) in x's dtype, with the kernel's rounding points."""
    s, d2, hid = w1.shape
    h = F.silu(torch.addmm(b0.float(), x.float(), w0.float().T))
    h = h.to(x.dtype).float().view(x.shape[0], s, hid).transpose(0, 1)
    out = torch.baddbmm(b1.float()[:, None, :], h,
                        w1.float().transpose(1, 2))
    if act_last:
        out = F.silu(out)
    return out.to(x.dtype)


def smem_bytes(d, d2):
    """Shared memory of one block (``csrc/mlp2_fused.cu::smem_bytes``):
    the x tile, the w0 chunk (which also holds the float32 hidden chunk),
    the w1 chunk and the bf16 hidden chunk."""
    ldh = HIDDEN_CHUNK + 8
    w0 = max(HIDDEN_CHUNK * (d + 8) * 2,
             ROWS_PER_BLOCK * (HIDDEN_CHUNK + 4) * 4)
    return (ROWS_PER_BLOCK * (d + 8) * 2 + w0 + d2 * ldh * 2
            + ROWS_PER_BLOCK * ldh * 2)


def launch_geometry(n, splits, hidden, sm_count):
    """(row tiles, splits, parts, chunks per part): the kernel's grid.
    When row tiles x splits leave more than half the SMs idle, each
    split's hidden chunks are shared out over ``parts`` blocks (a float32
    partial sum each, added by a second launch) so the grid fills one
    wave at most."""
    row_tiles = -(-n // ROWS_PER_BLOCK)
    chunks = hidden // HIDDEN_CHUNK
    parts = min(chunks, max(1, sm_count // (row_tiles * splits)))
    per_part = -(-chunks // parts)
    return row_tiles, splits, -(-chunks // per_part), per_part


def mlp2_fused(x, w0, b0, w1, b1, act_last=False):
    """The fused MLP: the kernel on CUDA tensors, the plain version on CPU
    tensors.  (N, D) -> (S, N, D2)."""
    if x.device.type == "cpu":
        return mlp2_fused_reference(x, w0, b0, w1, b1, act_last)
    _check_kernel_inputs(x, w0, b0, w1, b1)
    n, d = x.shape
    s, d2, hid = w1.shape
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    row_tiles, _, parts, per_part = launch_geometry(n, s, hid, sm_count)
    out = torch.empty(s, n, d2, dtype=x.dtype, device=x.device)
    part = None
    if parts > 1:
        part = torch.empty(parts, s, row_tiles * ROWS_PER_BLOCK, d2,
                           dtype=torch.float32, device=x.device)
    fn = cuda_build.function("mlp2_fused", "qaig_mlp2_fused", _ARGTYPES)
    err = fn(x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
             b1.data_ptr(), out.data_ptr(),
             None if part is None else part.data_ptr(), n, d, s, hid, d2,
             int(act_last), parts, per_part, cuda_build.stream_handle(x))
    cuda_build.check("mlp2_fused", err)
    mlp2_fused.launches += 1
    return out


mlp2_fused.launches = 0


def _check_kernel_inputs(x, w0, b0, w1, b1):
    named = (("x", x, 2), ("w0", w0, 2), ("b0", b0, 1), ("w1", w1, 3),
             ("b1", b1, 2))
    for name, t, ndim in named:
        if t.device != x.device:
            raise ValueError(f"mlp2_fused: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"mlp2_fused: the kernel takes bf16 only; "
                             f"{name} is {t.dtype}")
        if t.ndim != ndim:
            raise ValueError(f"mlp2_fused: {name} must be {ndim}-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"mlp2_fused: {name} must be contiguous and "
                             f"16-byte aligned")
    n, d = x.shape
    s, d2, hid = w1.shape
    if n < 1:
        raise ValueError("mlp2_fused: no rows (N = 0)")
    if tuple(w0.shape) != (s * hid, d) or tuple(b0.shape) != (s * hid,) \
            or tuple(b1.shape) != (s, d2):
        raise ValueError(
            f"mlp2_fused: shapes x {tuple(x.shape)}, w0 {tuple(w0.shape)}, "
            f"b0 {tuple(b0.shape)}, w1 {tuple(w1.shape)}, b1 "
            f"{tuple(b1.shape)} do not fit (N, D), (S*H, D), (S*H,), "
            f"(S, D2, H), (S, D2)")
    if d % 16 or hid % HIDDEN_CHUNK or d2 not in OUT_DIMS:
        raise ValueError(f"mlp2_fused: needs D % 16 == 0 (D {d}), H % "
                         f"{HIDDEN_CHUNK} == 0 (H {hid}) and D2 in "
                         f"{OUT_DIMS} (D2 {d2})")
    if smem_bytes(d, d2) > MAX_SMEM:
        raise ValueError(f"mlp2_fused: D {d} needs {smem_bytes(d, d2)} "
                         f"bytes of shared memory, over {MAX_SMEM}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError("mlp2_fused: tensors are not on the current CUDA "
                         "device")
