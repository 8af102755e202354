// Best-matching-unit search for Hopper (sm_90a).
//
// Replaces the TPU kernel of qaig_tpu/ops/bmu.py: fused_bmu -> _bmu_kernel,
// which holds the whole (K, D) codebook in VMEM, pads M to 1024-row tiles
// and reduces the (TM, K) distance tile it computes on the MXU.
//
// Function.  patches (M, D) and codes (K, D), float32, row-major; for every
// row m, out[m] = argmin_k (|c_k|^2 - 2 p_m . c_k), the first k on ties,
// as int64.  The |p_m|^2 term cannot change the argmin and is dropped.
//
// What bounds it on the H100.  2 M K D float32 operations on (M + K) D
// input floats: at the training path's shapes (M 2048, D 16, K 512; M 512,
// D 64, K 512) that is about 0.5 us at 67 TFLOP/s and less in bytes, far
// below the few microseconds a launch costs, so launch latency and the
// number of blocks in flight set the time.  At D 4096 (the 32x32 LR patch)
// the codebook alone is 8 MB, which no shared memory holds.
//
// What the design does about it.  A block owns 32 patch rows and a range
// of 64-code tiles; it streams rows and codes through shared memory in
// 32-wide slices of D and keeps a 2x4 tile of partial dots per thread in
// registers, so neither the (M, K) distances nor a whole codebook ever
// needs to fit anywhere.  |c_k|^2 is summed from the same shared-memory
// slices.  After each code tile every thread folds its distances into a
// running (min, index); the 16 threads of a row then reduce by
// lexicographic (distance, index), so ties go to the lowest index whatever
// the order.  When the rows alone give too few blocks to fill the card,
// the code tiles are split over a second grid axis and a second launch
// reduces the per-split minima in split order.  Only float32 FMAs: no TF32
// and no tensor cores, so tokens match the float32 pipeline.  M is not
// padded: the ragged edge is masked.
//
// Small M (at most 32 rows, D a multiple of 128; the LR codebook's M 8,
// D 4096, K 512) is a second geometry, chosen by ops/bmu.py::launch_plan.
// There the row tiles would leave all but a few SMs idle while 8 MB of
// codes stream through them, so the work is cut by code and D slice
// instead: a block owns 8 codes (one a warp) and one slice of D (128-1024
// wide, picked so the grid has >= 264 blocks, two per SM), stages the M
// rows' matching slice in shared memory, and each warp streams its code's
// slice with 16-byte loads (all issued before the rows are staged, so the
// two latencies overlap), accumulates the M partial dots and the slice's
// |c|^2 per lane, and reduces them with warp shuffles.  A second launch
// sums the slices of each (row, code) in slice order and takes the
// lexicographic (distance, index) minimum per row.  A code's sum runs in
// the same order whichever block, warp or lane holds it (per lane over its
// float4s, the shuffle tree, then the slices in order), so equal codes get
// bit-equal distances and the first index wins.
//
// Limits (from the kernels as written; ops/bmu.py checks them).  M, K and D
// are ints of at least 1.  The row tiles take any D (the 32-wide slices
// are masked at D's edge, so D 2 is one partly filled slice and D 8192 is
// 256 slices), any K (64-code tiles, the last masked) and any M (grid x is
// M / 32; the splits on grid y are at most 264), at any alignment.  The
// small-M geometry needs M <= 32, D a multiple of 128 with D / slice <=
// 65535 (grid y), 16-byte aligned inputs, and M * slice floats within 48
// KB of shared memory (launch_plan picks the slice); its scratch part_dot is
// (D / slice, M, K) float32: 2 MB at M 32, D 8192, K 512 (slice 256), 32 MB
// at K 8192.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTM = 32;       // patch rows per block
constexpr int kTK = 64;       // codes per tile
constexpr int kTD = 32;       // D slice staged in shared memory
constexpr int kThreads = 256; // 16 x 16: ty owns rows, tx owns codes
constexpr int kRows = kTM / 16;   // rows per thread
constexpr int kCodes = kTK / 16;  // codes per thread
constexpr int kNone = 0x7fffffff;

__device__ __forceinline__ bool better(float d, int i, float best,
                                       int best_i) {
  return d < best || (d == best && i < best_i);
}

// Stage rows [r0, r0 + rows) x columns [d0, d0 + kTD) of a row-major
// (total, D) matrix into dst (rows x (kTD + 1)), zeros past either edge.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int r0, int rows, int total, int D,
                                      int d0) {
  for (int i = threadIdx.x; i < rows * kTD; i += kThreads) {
    const int r = i / kTD, d = i % kTD;
    const int gr = r0 + r, gd = d0 + d;
    dst[r * (kTD + 1) + d] =
        gr < total && gd < D ? src[(size_t)gr * D + gd] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads) bmu_kernel(
    const float* __restrict__ patches, const float* __restrict__ codes,
    int M, int K, int D, int tiles_per_split, int64_t* __restrict__ out,
    float* __restrict__ part_dist, int* __restrict__ part_idx) {
  __shared__ float ps[kTM * (kTD + 1)];
  __shared__ float cs[kTK * (kTD + 1)];
  __shared__ float csq[kTK];

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * kTM;
  const int k_begin = blockIdx.y * tiles_per_split * kTK;
  const int k_end = min(K, k_begin + tiles_per_split * kTK);
  const bool rows_resident = D <= kTD;  // one slice: stage rows once

  float best[kRows];
  int best_i[kRows];
  for (int i = 0; i < kRows; ++i) {
    best[i] = INFINITY;
    best_i[i] = kNone;
  }

  if (rows_resident) stage(ps, patches, m0, kTM, M, D, 0);
  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
    float acc[kRows][kCodes] = {};
    float sq = 0.f;  // |c|^2 of code k0 + threadIdx.x (threads < kTK)
    for (int d0 = 0; d0 < D; d0 += kTD) {
      __syncthreads();  // the previous slice's reads are done
      if (!rows_resident) stage(ps, patches, m0, kTM, M, D, d0);
      stage(cs, codes, k0, kTK, k_end, D, d0);
      __syncthreads();
      if (threadIdx.x < kTK) {
        const float* c = cs + threadIdx.x * (kTD + 1);
#pragma unroll 8
        for (int d = 0; d < kTD; ++d) sq = fmaf(c[d], c[d], sq);
      }
#pragma unroll 8
      for (int d = 0; d < kTD; ++d) {
        float p[kRows], c[kCodes];
        for (int i = 0; i < kRows; ++i) p[i] = ps[(ty + 16 * i) * (kTD + 1) + d];
        for (int j = 0; j < kCodes; ++j) c[j] = cs[(tx + 16 * j) * (kTD + 1) + d];
        for (int i = 0; i < kRows; ++i)
          for (int j = 0; j < kCodes; ++j) acc[i][j] = fmaf(p[i], c[j], acc[i][j]);
      }
    }
    if (threadIdx.x < kTK) csq[threadIdx.x] = sq;
    __syncthreads();
    for (int j = 0; j < kCodes; ++j) {  // increasing code index
      const int k = k0 + tx + 16 * j;
      if (k >= k_end) break;
      for (int i = 0; i < kRows; ++i) {
        const float dist = csq[tx + 16 * j] - 2.f * acc[i][j];
        if (better(dist, k, best[i], best_i[i])) {
          best[i] = dist;
          best_i[i] = k;
        }
      }
    }
  }

  // the 16 threads of a row are 16 consecutive lanes of one warp
  for (int i = 0; i < kRows; ++i) {
    float b = best[i];
    int bi = best_i[i];
    for (int offset = 8; offset > 0; offset >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, b, offset);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, offset);
      if (better(ob, oi, b, bi)) {
        b = ob;
        bi = oi;
      }
    }
    const int m = m0 + ty + 16 * i;
    if (tx == 0 && m < M) {
      if (gridDim.y == 1) {
        out[m] = bi == kNone ? 0 : bi;
      } else {
        part_dist[(size_t)blockIdx.y * M + m] = b;
        part_idx[(size_t)blockIdx.y * M + m] = bi;
      }
    }
  }
}

__global__ void bmu_reduce_kernel(const float* __restrict__ part_dist,
                                  const int* __restrict__ part_idx, int M,
                                  int splits, int64_t* __restrict__ out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float b = INFINITY;
  int bi = kNone;
  for (int s = 0; s < splits; ++s) {
    const float d = part_dist[(size_t)s * M + m];
    const int i = part_idx[(size_t)s * M + m];
    if (better(d, i, b, bi)) {
      b = d;
      bi = i;
    }
  }
  out[m] = bi == kNone ? 0 : bi;
}

constexpr int kSmallWarps = 8;      // codes per block, one per warp
constexpr int kSliceChunks = 8;     // float4 per lane: slices <= 1024 wide

template <int MAXM>
__global__ void __launch_bounds__(kSmallWarps * 32) bmu_small_m_kernel(
    const float* __restrict__ patches, const float* __restrict__ codes,
    int M, int K, int D, int slice, float* __restrict__ part_dot,
    float* __restrict__ part_sq) {
  extern __shared__ float4 rows[];  // M x slice / 4
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = blockIdx.y;
  const int d0 = split * slice;
  const int k = blockIdx.x * kSmallWarps + warp;
  const int chunks = slice / 128;
  const int row4 = slice / 4;

  // the code's slice first: its loads are in flight while the rows stage
  float4 c[kSliceChunks];
#pragma unroll
  for (int t = 0; t < kSliceChunks; ++t) {
    c[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < K && t < chunks)
      c[t] = __ldcs(reinterpret_cast<const float4*>(
                        codes + (size_t)k * D + d0) + lane + 32 * t);
  }
  for (int i = threadIdx.x; i < M * row4; i += kSmallWarps * 32) {
    const int r = i / row4, c4 = i % row4;
    rows[i] = reinterpret_cast<const float4*>(patches + (size_t)r * D + d0)[c4];
  }
  __syncthreads();
  if (k >= K) return;

  float acc[MAXM];
#pragma unroll
  for (int m = 0; m < MAXM; ++m) acc[m] = 0.f;
  float sq = 0.f;
#pragma unroll
  for (int t = 0; t < kSliceChunks; ++t) {
    if (t >= chunks) break;
    const float4 cv = c[t];
    sq = fmaf(cv.x, cv.x, sq);
    sq = fmaf(cv.y, cv.y, sq);
    sq = fmaf(cv.z, cv.z, sq);
    sq = fmaf(cv.w, cv.w, sq);
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m >= M) break;
      const float4 p = rows[m * row4 + lane + 32 * t];
      acc[m] = fmaf(p.x, cv.x, acc[m]);
      acc[m] = fmaf(p.y, cv.y, acc[m]);
      acc[m] = fmaf(p.z, cv.z, acc[m]);
      acc[m] = fmaf(p.w, cv.w, acc[m]);
    }
  }
  // butterfly sums: every lane ends with the same bits
  for (int offset = 16; offset > 0; offset >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, offset);
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m >= M) break;
    for (int offset = 16; offset > 0; offset >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], offset);
  }
  if (lane == 0) {
    part_sq[(size_t)split * K + k] = sq;
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m >= M) break;
      part_dot[((size_t)split * M + m) * K + k] = acc[m];
    }
  }
}

// one block per row: the slices of each code summed in slice order, then
// the lexicographic (distance, index) minimum over the codes
__global__ void __launch_bounds__(256) bmu_small_m_reduce_kernel(
    const float* __restrict__ part_dot, const float* __restrict__ part_sq,
    int M, int K, int splits, int64_t* __restrict__ out) {
  __shared__ float warp_best[8];
  __shared__ int warp_idx[8];
  const int m = blockIdx.x;
  float b = INFINITY;
  int bi = kNone;
  for (int k = threadIdx.x; k < K; k += 256) {  // increasing code index
    float sq = 0.f, dot = 0.f;
    for (int s = 0; s < splits; ++s) {
      sq += part_sq[(size_t)s * K + k];
      dot += part_dot[((size_t)s * M + m) * K + k];
    }
    const float dist = sq - 2.f * dot;
    if (better(dist, k, b, bi)) {
      b = dist;
      bi = k;
    }
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, b, offset);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, offset);
    if (better(ob, oi, b, bi)) {
      b = ob;
      bi = oi;
    }
  }
  if ((threadIdx.x & 31) == 0) {
    warp_best[threadIdx.x >> 5] = b;
    warp_idx[threadIdx.x >> 5] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < 8; ++w)
      if (better(warp_best[w], warp_idx[w], b, bi)) {
        b = warp_best[w];
        bi = warp_idx[w];
      }
    out[m] = bi == kNone ? 0 : bi;
  }
}

}  // namespace

extern "C" {

// patches (M, D), codes (K, D): float32, contiguous.  out: (M,) int64.
// splits > 1 needs part_dist (splits, M) float32 and part_idx (splits, M)
// int32 as scratch; tiles_per_split * 64 * splits >= K.  Returns the
// cudaError_t of the launches.
int qaig_bmu(const void* patches, const void* codes, int M, int K, int D,
             int splits, int tiles_per_split, void* out, void* part_dist,
             void* part_idx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + kTM - 1) / kTM, splits);
  bmu_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(patches), static_cast<const float*>(codes), M,
      K, D, tiles_per_split, static_cast<int64_t*>(out),
      static_cast<float*>(part_dist), static_cast<int*>(part_idx));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  bmu_reduce_kernel<<<(M + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part_dist), static_cast<const int*>(part_idx),
      M, splits, static_cast<int64_t*>(out));
  return (int)cudaGetLastError();
}

// The small-M geometry: M <= 32, D a multiple of `slice`, slice a multiple
// of 128 and at most 1024, M * slice floats of shared memory (at most 48
// KB); patches and codes 16-byte aligned.  part_dot (splits, M, K) and
// part_sq (splits, K) float32 are scratch, splits = D / slice.  Returns the
// cudaError_t of the launches.
int qaig_bmu_small_m(const void* patches, const void* codes, int M, int K,
                     int D, int slice, int splits, void* out, void* part_dot,
                     void* part_sq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((K + kSmallWarps - 1) / kSmallWarps, splits);
  const size_t smem = (size_t)M * slice * sizeof(float);
  const float* p = static_cast<const float*>(patches);
  const float* c = static_cast<const float*>(codes);
  float* dot = static_cast<float*>(part_dot);
  float* sq = static_cast<float*>(part_sq);
  if (M <= 8)
    bmu_small_m_kernel<8><<<grid, kSmallWarps * 32, smem, st>>>(
        p, c, M, K, D, slice, dot, sq);
  else
    bmu_small_m_kernel<32><<<grid, kSmallWarps * 32, smem, st>>>(
        p, c, M, K, D, slice, dot, sq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bmu_small_m_reduce_kernel<<<M, 256, 0, st>>>(dot, sq, M, K, splits,
                                               static_cast<int64_t*>(out));
  return (int)cudaGetLastError();
}

const char* qaig_bmu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
