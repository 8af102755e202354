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
kernel of ``qaig_tpu_torch/csrc/mlp2_fused.cu`` (``wgmma`` products on
TMA-loaded tiles, weight tiles multicast to a cluster of row tiles; its
grid, clusters and shared memory are :func:`launch_geometry` and
:func:`smem_bytes`, pure Python); it takes bf16 only (the
TPU kernel's type; a float32 CUDA input raises ``ValueError``) and any
number of rows (the Pallas kernel's ``tile`` block size has no counterpart:
the ragged edge is masked).  On a CPU tensor it runs
:func:`mlp2_fused_reference`, the plain version, in any float dtype.
"""

import collections
import ctypes

import torch
import torch.nn.functional as F

from qaig_tpu_torch.ops import cuda_build

ROWS_PER_BLOCK = 64
HIDDEN_CHUNK = 64
OUT_DIMS = (64, 128, 256, 512)
MAX_SMEM = 232_448   # bytes of shared memory one block may use on an H100
MAX_CLUSTER = 4      # row tiles that share each weight tile (TMA multicast)
_W0_STAGES = 6
_TILE = 64 * 64 * 2  # a 64 x 64 bf16 tile
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]

Geometry = collections.namedtuple(
    "Geometry", "row_tiles grid_x cluster splits parts chunks_per_part")


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
    1024 bytes of alignment slack, the resident x tile in 64-wide
    K-blocks, two bf16 hidden chunks, the ring of w0 K-blocks, the ring of
    w1 half-chunks (D2 / 2 x 64) and the mbarriers."""
    k_blocks, nf = -(-d // 64), d2 // 64
    w1_stages = 3 if nf == 8 else 4
    barriers = 5 + 2 * _W0_STAGES + 2 * w1_stages
    return (1024 + k_blocks * _TILE + 2 * _TILE + _W0_STAGES * _TILE
            + w1_stages * nf * 4096 + 8 * barriers)


def launch_geometry(n, splits, hidden, resident, cluster=None):
    """The kernel's grid (``grid_x`` row tiles, ``splits``, ``parts``),
    its clusters of ``cluster`` consecutive row tiles that share every
    weight tile, and the hidden chunks each part takes.

    ``resident``: the blocks the card holds at once in clusters of each
    size, ``{cluster: blocks}`` (:func:`resident_blocks`; an H100 holds
    132 blocks of this kernel alone or in pairs, 120 in clusters of 4), or
    an SM count, one block on every SM.  The row tiles are padded up to a
    whole number of clusters (the padding blocks read zeros and store
    nothing).  When the grid leaves more than half the resident blocks
    idle, each split's hidden chunks are shared out over ``parts`` blocks
    (a float32 partial sum each, added in order by a second launch) so the
    grid fills one wave at most.  Of the cluster sizes, the one whose waves
    x chunks per block is least wins, the largest on a tie (fewest weight
    reads); ``cluster`` (1, 2 or 4) takes that size alone, where the row
    tiles allow it."""
    if isinstance(resident, int):
        resident = {c: resident // c * c for c in (1, 2, MAX_CLUSTER)}
    row_tiles = -(-n // ROWS_PER_BLOCK)
    chunks = hidden // HIDDEN_CHUNK
    best = None
    for size in (MAX_CLUSTER, 2, 1):
        capacity = resident[size]
        if size > row_tiles or capacity < size or cluster not in (None, size):
            continue
        grid_x = -(-row_tiles // size) * size
        parts = min(chunks, max(1, capacity // (grid_x * splits)))
        per_part = -(-chunks // parts)
        parts = -(-chunks // per_part)
        waves = -(-grid_x * splits * parts // capacity)
        if best is None or waves * per_part < best[0]:
            best = (waves * per_part, Geometry(row_tiles, grid_x, size,
                                               splits, parts, per_part))
    if best is None:
        raise ValueError(f"mlp2_fused: no cluster of {cluster} fits {n} rows")
    return best[1]


def weight_l2_bytes(n, d, splits, hidden, d2, resident, cluster=None):
    """Bytes of w0 and w1 one call reads from L2: each cluster reads each
    weight tile of its split (and hidden part) once, for all its blocks."""
    g = launch_geometry(n, splits, hidden, resident, cluster)
    return g.grid_x // g.cluster * splits * hidden * (d + d2) * 2


_resident = {}


def resident_blocks(d, d2, device):
    """``{cluster: blocks}`` the card holds at once for this D and D2
    (``cudaOccupancyMaxActiveClusters``, asked once per shape)."""
    key = (device.index, d, d2)
    if key not in _resident:
        fn = cuda_build.function("mlp2_fused",
                                 "qaig_mlp2_fused_resident_blocks",
                                 [ctypes.c_int] * 3)
        with torch.cuda.device(device):
            counts = {c: fn(d, d2, c) for c in (1, 2, MAX_CLUSTER)}
        if min(counts.values()) < 0:
            raise RuntimeError(f"mlp2_fused: the occupancy query failed "
                               f"({counts})")
        _resident[key] = counts
    return _resident[key]


def mlp2_fused(x, w0, b0, w1, b1, act_last=False, cluster=None):
    """The fused MLP: the kernel on CUDA tensors, the plain version on CPU
    tensors.  (N, D) -> (S, N, D2).  ``cluster`` fixes the kernel's
    cluster size (see :func:`launch_geometry`)."""
    if x.device.type == "cpu":
        return mlp2_fused_reference(x, w0, b0, w1, b1, act_last)
    _check_kernel_inputs(x, w0, b0, w1, b1)
    n, d = x.shape
    s, d2, hid = w1.shape
    g = launch_geometry(n, s, hid, resident_blocks(d, d2, x.device),
                        cluster)
    out = torch.empty(s, n, d2, dtype=x.dtype, device=x.device)
    part = None
    if g.parts > 1:
        part = torch.empty(g.parts, s, g.grid_x * ROWS_PER_BLOCK, d2,
                           dtype=torch.float32, device=x.device)
    fn = cuda_build.function("mlp2_fused", "qaig_mlp2_fused", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
                 b1.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(), n, d, s, hid,
                 d2, int(act_last), g.grid_x, g.cluster, g.parts,
                 g.chunks_per_part, cuda_build.stream_handle(x))
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
