"""Best-matching-unit (BMU) search (counterpart of ``qaig_tpu/ops/bmu.py``).

For (M, D) patches and (K, D) codes, the index of each patch's nearest
code: ``argmin_k (|c_k|^2 - 2 p . c_k)`` in float32, the first index on
ties (the ``|p|^2`` term cannot change the argmin).  The indices carry no
gradient.

On a CUDA tensor, :func:`bmu_argmin` launches :func:`fused_bmu`, the
hand-written Hopper kernel of ``qaig_tpu_torch/csrc/bmu.cu`` (rows and
codes streamed through shared memory, float32 FMAs only, the (M, K)
distances never written out).  On a CPU tensor it runs
:func:`bmu_argmin_reference`, the plain version.  There is no switch and no
other route: a CUDA input the kernel does not take raises.
"""

import ctypes

import torch

from qaig_tpu_torch.ops import cuda_build

MAX_D = 4096
MAX_K = 4096
_ROWS_PER_BLOCK = 32
_CODES_PER_TILE = 64
_TARGET_BLOCKS = 264   # two per SM of an H100's 132
NEAR_TIE = 1e-5        # near-tie margin, relative to max(1, |best|)
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


def fused_bmu(patches, codes):
    """The BMU kernel: (M, D) float32 patches x (K, D) float32 codes on the
    current CUDA device -> (M,) int64 indices."""
    _check_kernel_inputs(patches, codes)
    m, d = patches.shape
    k = codes.shape[0]
    row_blocks = -(-m // _ROWS_PER_BLOCK)
    k_tiles = -(-k // _CODES_PER_TILE)
    # split the code tiles over a second grid axis when the rows alone
    # leave the card idle; a second launch reduces the splits in order
    splits = min(k_tiles, max(1, -(-_TARGET_BLOCKS // row_blocks)))
    tiles_per_split = -(-k_tiles // splits)
    splits = -(-k_tiles // tiles_per_split)
    out = torch.empty(m, dtype=torch.int64, device=patches.device)
    part_dist = part_idx = None
    if splits > 1:
        part_dist = torch.empty(splits, m, dtype=torch.float32,
                                device=patches.device)
        part_idx = torch.empty(splits, m, dtype=torch.int32,
                               device=patches.device)
    fn = cuda_build.function("bmu", "qaig_bmu", _ARGTYPES)
    err = fn(patches.data_ptr(), codes.data_ptr(), m, k, d, splits,
             tiles_per_split, out.data_ptr(),
             None if part_dist is None else part_dist.data_ptr(),
             None if part_idx is None else part_idx.data_ptr(),
             cuda_build.stream_handle(patches))
    cuda_build.check("bmu", err)
    fused_bmu.launches += 1
    return out


fused_bmu.launches = 0


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
    if not 8 <= d <= MAX_D:
        raise ValueError(f"fused_bmu: D {d} outside [8, {MAX_D}]")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_bmu: K {k} outside [1, {MAX_K}]")
    if m < 1:
        raise ValueError("fused_bmu: no patches (M = 0)")
    if patches.device.index != torch.cuda.current_device():
        raise ValueError("fused_bmu: tensors are not on the current CUDA "
                         "device")
