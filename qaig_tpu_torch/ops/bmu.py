"""Best-matching-unit (BMU) search (counterpart of ``qaig_tpu/ops/bmu.py``).

For (M, D) patches and (K, D) codes, the index of each patch's nearest
code: ``argmin_k (|c_k|^2 - 2 p . c_k)`` in float32, the first index on
ties (the ``|p|^2`` term cannot change the argmin).  The indices carry no
gradient.

On a CUDA tensor, :func:`bmu_argmin` launches :func:`fused_bmu`, the
hand-written Hopper kernel of ``qaig_tpu_torch/csrc/bmu.cu`` (float32 FMAs
only, the (M, K) distances never written out) in one of two launch
geometries that :func:`launch_plan` picks from the shape: row tiles (rows
and codes streamed through shared memory) or, for a few rows against long
codes, code-and-D-slice blocks.  On a CPU tensor it runs
:func:`bmu_argmin_reference`, the plain version.  There is no switch and no
other route: a CUDA input the kernel does not take raises.
"""

import ctypes

import torch

from qaig_tpu_torch.ops import cuda_build

_ROWS_PER_BLOCK = 32
_CODES_PER_TILE = 64
_TARGET_BLOCKS = 264   # two per SM of an H100's 132
SMALL_M_ROWS = 32      # the small-M geometry takes at most this many rows
_SMALL_M_CODES = 8     # codes per small-M block, one per warp
_SMALL_M_SLICE = 1024  # widest D slice (8 float4 per lane)
_SMALL_M_SMEM = 48 * 1024
_SMALL_M_MAX_D = 65535 * 128  # the D slices (at least 128 wide) on grid y
NEAR_TIE = 1e-5        # near-tie margin, relative to max(1, |best|)
# qaig_bmu and qaig_bmu_small_m: two pointers, five ints, four pointers
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 4)


def bmu_argmin_reference(patches, codes):
    """Plain PyTorch BMU search: (M, D) x (K, D) float32 -> (M,) int64."""
    code_sq = (codes * codes).sum(dim=-1)
    dist = code_sq[None, :] - 2.0 * (patches @ codes.T)
    return dist.argmin(dim=-1)


def near_tie_agreement(patches, codes, got, want):
    """Hold BMU indices ``got`` against ``want`` (both (M,) int) under the
    near-tie rule, in float64: the indices must be equal on every row
    whose best and second-best distances lie more than ``NEAR_TIE *
    max(1, |best|)`` apart, and ``got``'s pick must lie within that margin
    of the minimum on every row.  Summation order differs between the kernel,
    the plain version and XLA, and a flipped index is a different token,
    so only rows that are truly tied may differ.

    Raises ``AssertionError`` on a violation; otherwise returns
    ``{"near_tie_rows", "differing_rows", "max_gap"}``: the rows inside
    the margin, the rows where the indices differ, and the largest gap
    between the distance of ``got``'s pick and the minimum."""
    p64, c64 = patches.double(), codes.double()
    dist = (c64 * c64).sum(-1)[None] - 2.0 * p64 @ c64.T
    two = dist.topk(min(2, dist.shape[1]), dim=1, largest=False).values
    best = two[:, 0]
    margin = NEAR_TIE * best.abs().clamp(min=1.0)
    if two.shape[1] > 1:
        clear = two[:, 1] - best > margin
    else:   # one code: every row is clear
        clear = torch.ones_like(best, dtype=torch.bool)
    differ = got != want
    if bool((differ & clear).any()):
        raise AssertionError(f"BMU indices differ on "
                             f"{int((differ & clear).sum())} clear rows")
    gap = dist.gather(1, got[:, None].long())[:, 0] - best
    if not bool((gap <= margin).all()):
        raise AssertionError("a BMU pick lies outside the near-tie margin "
                             "of the minimum")
    return {"near_tie_rows": int((~clear).sum()),
            "differing_rows": int(differ.sum()),
            "max_gap": float(gap.max())}


def launch_plan(m, d, k, aligned=True):
    """The kernel's launch geometry for (M, D) patches against (K, D)
    codes.

    ``"small_m"`` when M <= ``SMALL_M_ROWS``, D is a multiple of 128 and
    both inputs are 16-byte aligned: blocks of 8 codes x one D slice, the
    widest slice (128-1024, dividing D, its M rows within 48 KB of shared
    memory) that still gives at least 264 blocks (two per SM), else the
    narrowest; ``splits`` = D / ``slice`` partial sums per (row, code),
    added in order by a second launch.  Otherwise ``"row_tiled"``: 32-row
    blocks over 64-code tiles, the tiles split over ``splits`` blocks per
    row tile (each taking ``tiles_per_split``) when the rows alone give
    fewer than 264 blocks, with a second launch that reduces the splits.
    Returns a dict with ``geometry``, ``blocks`` (of the first launch) and
    those fields."""
    if m <= SMALL_M_ROWS and d % 128 == 0 and d <= _SMALL_M_MAX_D and aligned:
        chunks = -(-k // _SMALL_M_CODES)
        units = d // 128
        widths = [u for u in range(min(units, _SMALL_M_SLICE // 128), 0, -1)
                  if units % u == 0 and m * u * 128 * 4 <= _SMALL_M_SMEM]
        u = next((u for u in widths
                  if chunks * (units // u) >= _TARGET_BLOCKS), widths[-1])
        return {"geometry": "small_m", "slice": 128 * u,
                "splits": units // u, "blocks": chunks * (units // u)}
    row_blocks = -(-m // _ROWS_PER_BLOCK)
    k_tiles = -(-k // _CODES_PER_TILE)
    splits = min(k_tiles, max(1, -(-_TARGET_BLOCKS // row_blocks)))
    tiles_per_split = -(-k_tiles // splits)
    splits = -(-k_tiles // tiles_per_split)
    return {"geometry": "row_tiled", "splits": splits,
            "tiles_per_split": tiles_per_split, "blocks": row_blocks * splits}


def fused_bmu(patches, codes):
    """The BMU kernel: (M, D) float32 patches x (K, D) float32 codes on one
    CUDA device (any card of the process: the launch runs there) -> (M,)
    int64 indices, in the geometry of :func:`launch_plan`."""
    _check_kernel_inputs(patches, codes)
    m, d = patches.shape
    k = codes.shape[0]
    plan = launch_plan(m, d, k, aligned=patches.data_ptr() % 16 == 0
                       and codes.data_ptr() % 16 == 0)
    splits = plan["splits"]
    dev = patches.device
    out = torch.empty(m, dtype=torch.int64, device=dev)
    if plan["geometry"] == "small_m":
        part_dot = torch.empty(splits, m, k, dtype=torch.float32, device=dev)
        part_sq = torch.empty(splits, k, dtype=torch.float32, device=dev)
        fn = cuda_build.function("bmu", "qaig_bmu_small_m", _ARGTYPES)
        args = (patches.data_ptr(), codes.data_ptr(), m, k, d, plan["slice"],
                splits, out.data_ptr(), part_dot.data_ptr(),
                part_sq.data_ptr(), cuda_build.stream_handle(patches))
    else:
        part_dist = part_idx = None
        if splits > 1:
            part_dist = torch.empty(splits, m, dtype=torch.float32,
                                    device=dev)
            part_idx = torch.empty(splits, m, dtype=torch.int32, device=dev)
        fn = cuda_build.function("bmu", "qaig_bmu", _ARGTYPES)
        args = (patches.data_ptr(), codes.data_ptr(), m, k, d, splits,
                plan["tiles_per_split"], out.data_ptr(),
                None if part_dist is None else part_dist.data_ptr(),
                None if part_idx is None else part_idx.data_ptr(),
                cuda_build.stream_handle(patches))
    with torch.cuda.device(dev):
        err = fn(*args)
    cuda_build.check("bmu", err)
    fused_bmu.launches += 1
    if plan["geometry"] == "small_m":
        fused_bmu.small_m_launches += 1
    return out


# kernel launches, and those of them in the small-M geometry
fused_bmu.launches = 0
fused_bmu.small_m_launches = 0


def bmu_argmin(patches, codes):
    """BMU indices of (M, D) patches against (K, D) codes, (M,) int64:
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    patches, codes = patches.detach(), codes.detach()
    if patches.device.type == "cpu":
        return bmu_argmin_reference(patches, codes)
    return fused_bmu(patches, codes)


def _check_kernel_inputs(patches, codes):
    if patches.device.type != "cuda":
        raise ValueError(f"fused_bmu: unsupported device {patches.device}")
    if codes.device != patches.device:
        raise ValueError(f"fused_bmu: codes on {codes.device}, patches on "
                         f"{patches.device}")
    for name, x in (("patches", patches), ("codes", codes)):
        if x.dtype != torch.float32:
            raise ValueError(f"fused_bmu: {name} must be float32, got "
                             f"{x.dtype}")
        if x.ndim != 2:
            raise ValueError(f"fused_bmu: {name} must be 2-D, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"fused_bmu: {name} is not contiguous")
    m, d = patches.shape
    k, dc = codes.shape
    if dc != d:
        raise ValueError(f"fused_bmu: patches have D {d}, codes {dc}")
    # the kernels take any M, K and D of at least 1 (csrc/bmu.cu)
    if m < 1:
        raise ValueError("fused_bmu: no patches (M = 0)")
    if k < 1:
        raise ValueError("fused_bmu: no codes (K = 0)")
    if d < 1:
        raise ValueError("fused_bmu: empty patches (D = 0)")
    if max(m, k, d) >= 2 ** 31:
        raise ValueError("fused_bmu: M, K or D does not fit a 32-bit int")
