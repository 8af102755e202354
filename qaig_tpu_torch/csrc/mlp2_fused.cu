// Fused two-layer MLP for Hopper (sm_90a): the hidden activation never
// goes to device memory.
//
// Replaces the TPU kernel of scripts/probe_mlp_fused.py:58 (mlp2_fused ->
// _mlp2_kernel), which takes a tile of rows, keeps the weights resident in
// VMEM (constant index_map blocks, fetched once) and the whole hidden row
// tile in VMEM between the two products.
//
// Function.  x (N, D), w0 (S*H, D), b0 (S*H,), w1 (S, D2, H), b1 (S, D2),
// out (S, N, D2), bf16, row-major (the port's layout: w0 and w1 as the
// Linear weights of models/blocks.py::pack_qkv; an FFN is S = 1).
//   h   = silu(x w0^T + b0)                  float32 sums and bias, then bf16
//   out[i] = h[:, iH:(i+1)H] w1[i]^T + b1[i]  float32 sums and bias, then
//                                             silu if act_last, then bf16
// These are _mlp2_kernel's rounding points.  silu only, as the TPU kernel
// hard-codes it.  Float32 inputs are refused by the wrapper (bf16 only).
//
// What bounds it on the H100.  2 N D S H + 2 N S H D2 operations on
// N D + S H (D + D2) + S N D2 bf16 elements: at the probe's shapes (D 512,
// H 2048, D2 512, S 3 or 1, N 1024 or 8192) that is 160-2200 operations
// per byte, above the ~295 of the roofline at N 8192 and near it at N 1024,
// so the bound is the tensor cores' (0.104 ms for packed QKV at N 8192,
// 0.0043 ms for the FFN at N 1024).  What XLA's two products add on top is
// the hidden's round trip through device memory (N S H bf16 written and
// read, 100 MB per packed-QKV layer at N 8192).
//
// What the design does about it.  A block takes 64 rows and one split and
// walks that split's hidden in chunks of 64 columns: it computes
// h_c = silu(x_tile w0_c^T + b0_c) on the tensor cores (WMMA 16x16x16 bf16,
// float32 accumulate) from the chunk's w0 rows in shared memory, rounds h_c
// to bf16 in shared memory, and accumulates h_c w1_c^T, from the matching
// 64 columns of w1[split] in shared memory, into a float32 64 x D2
// accumulator held in registers (16 warps, a 16 x D2/4 band each: 64
// registers a thread at D2 512).  b1, act_last and the rounding come only
// after the split's last chunk, so silu never sees a partial sum.  Each
// split's hidden columns are its own, so nothing is computed twice: the
// kernel does exactly the function's operations.  The hidden lives in
// shared memory one chunk at a time and never reaches device memory.
//
// Copies.  Weights move with cp.async one step ahead of the products: w1
// of chunk c lands while the first product of c runs, w0 of chunk c + 1
// while the second product of c runs.  The float32 hidden chunk reuses the
// w0 buffer between the two, so the double use fits in 216 KB of shared
// memory at D 512.  (The first version copied synchronously through
// registers before each product: 4-8 dependent global loads per thread
// per chunk left the tensor cores idle most of the time.)  wgmma and TMA
// are later work.
//
// Weights.  The TPU kernel fetches the weights once; here every block
// re-reads its split's w0 and w1 (4.2 MB for packed QKV at H 2048), once
// per 64-row tile.  A packed-QKV layer's 12.6 MB fits in the 50 MB L2, so
// the re-reads come from L2, not device memory; their L2 traffic (N / 64
// tiles x 12.6 MB) is what a larger row tile or TMA multicast across a
// cluster would cut, later work.
//
// Occupancy.  One block of 16 warps per SM.  When the row tiles x splits
// leave more than half of the 132 SMs idle (N 1024: 16 x 3 or 16 x 1
// blocks), the wrapper also splits each split's hidden chunks over `parts`
// blocks, each writing its float32 partial sums to a scratch (parts, S,
// Npad, D2); a second launch adds the parts in order, then b1, act_last
// and the rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;  // 16 warps
constexpr int kBM = 64;        // rows per block
constexpr int kHC = 64;        // hidden columns per chunk
constexpr int kLdH = kHC + 8;  // pitch (bf16) of the hidden chunk and w1's
constexpr int kLdF = kHC + 4;  // pitch (float) of the float32 hidden chunk

__device__ __forceinline__ float silu(float v) {
  return v * (1.f / (1.f + expf(-v)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `n` of this thread's newest copy groups are pending
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// rows x cols (cols % 8 == 0) bf16 from src (pitch ld_src) into dst (pitch
// ld_dst) as 16-byte asynchronous copies; rows at or past `valid` are
// zero-filled with plain stores.  The caller commits the group.
__device__ __forceinline__ void copy_rows_async(bf16* dst, int ld_dst,
                                                const bf16* __restrict__ src,
                                                size_t ld_src, int rows,
                                                int cols, int valid) {
  const int vecs = cols / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs, v = i % vecs;
    bf16* d = dst + r * ld_dst + v * 8;
    if (r < valid)
      cp_async16(d, src + (size_t)r * ld_src + v * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Bytes of the w0-chunk buffer, which also holds the float32 hidden chunk
// once the first product is done with it.
__host__ __device__ __forceinline__ int w0_bytes(int D) {
  const int w = kHC * (D + 8) * 2, f = kBM * kLdF * 4;
  return w > f ? w : f;
}

// D2 = 64 * NF output columns; warp w owns rows 16 (w & 3) .. +16 and, in
// the second product, the band of D2 / 4 columns w >> 2 (NF fragments); in
// the first product, hidden columns 16 (w >> 2) .. +16 of the chunk.
// Copies run one chunk ahead: w1 of chunk c lands during the first
// product of c, w0 of chunk c + 1 during the second product of c.
template <int NF>
__global__ void __launch_bounds__(kThreads, 1) mlp2_fused_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w0,
    const bf16* __restrict__ b0, const bf16* __restrict__ w1,
    const bf16* __restrict__ b1, bf16* __restrict__ out,
    float* __restrict__ part, int N, int D, int S, int H, int act_last,
    int chunks_per_part) {
  constexpr int D2 = 64 * NF;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = D + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);               // kBM x ldx
  unsigned char* w0_region = smem + kBM * ldx * 2;
  bf16* w0s = reinterpret_cast<bf16*>(w0_region);         // kHC x ldx
  float* hf = reinterpret_cast<float*>(w0_region);        // kBM x kLdF
  bf16* w1s = reinterpret_cast<bf16*>(w0_region + w0_bytes(D));  // D2 x kLdH
  bf16* hb = w1s + D2 * kLdH;                             // kBM x kLdH

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rf = warp & 3, band = warp >> 2;
  const int row0 = blockIdx.x * kBM;
  const int s = blockIdx.y, p = blockIdx.z;
  const int c_begin = p * chunks_per_part;
  const int c_end = min(H / kHC, c_begin + chunks_per_part);
  const bf16* w1_split = w1 + (size_t)s * D2 * H;

  copy_rows_async(xs, ldx, x + (size_t)row0 * D, D, kBM, D,
                  min(kBM, N - row0));
  copy_rows_async(w0s, ldx, w0 + (size_t)(s * H + c_begin * kHC) * D, D,
                  kHC, D, kHC);
  cp_async_commit();
  copy_rows_async(w1s, kLdH, w1_split + c_begin * kHC, H, D2, kHC, D2);
  cp_async_commit();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int c = c_begin; c < c_end; ++c) {
    const int hcol = s * H + c * kHC;  // the chunk's first row of w0
    cp_async_wait<1>();                // x and w0 of chunk c have landed
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> h;
    wmma::fill_fragment(h, 0.f);
    for (int k = 0; k < D; k += 16) {  // h_c = x_tile w0_c^T
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, xs + rf * 16 * ldx + k, ldx);
      wmma::load_matrix_sync(b, w0s + band * 16 * ldx + k, ldx);
      wmma::mma_sync(h, a, b, h);
    }
    __syncthreads();  // w0s is read: its buffer takes the float32 chunk
    wmma::store_matrix_sync(hf + rf * 16 * kLdF + band * 16, h, kLdF,
                            wmma::mem_row_major);
    __syncthreads();
    // bias and silu in float32, rounded to bf16
    for (int i = threadIdx.x; i < kBM * kHC; i += kThreads) {
      const int r = i / kHC, col = i % kHC;
      const float v = hf[r * kLdF + col] + __bfloat162float(b0[hcol + col]);
      hb[r * kLdH + col] = __float2bfloat16(silu(v));
    }
    __syncthreads();  // the buffer is free: fetch w0 of the next chunk
    if (c + 1 < c_end)
      copy_rows_async(w0s, ldx, w0 + (size_t)(hcol + kHC) * D, D, kHC, D,
                      kHC);
    cp_async_commit();
    cp_async_wait<1>();  // w1 of chunk c has landed
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < kHC; k += 16) {  // acc += h_c w1_c^T
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, hb + rf * 16 * kLdH + k, kLdH);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, w1s + (band * 16 * NF + j * 16) * kLdH + k,
                               kLdH);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();  // w1s is read: fetch w1 of the next chunk
    if (c + 1 < c_end)
      copy_rows_async(w1s, kLdH, w1_split + (c + 1) * kHC, H, D2, kHC, D2);
    cp_async_commit();
  }
  cp_async_wait<0>();

  const int r0 = row0 + rf * 16;
  if (part != nullptr) {  // float32 partial sums; the reduce launch ends it
    const size_t npad = (size_t)gridDim.x * kBM;
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(
          part + (((size_t)p * S + s) * npad + r0) * D2 + band * 16 * NF +
              j * 16,
          acc[j], D2, wmma::mem_row_major);
    return;
  }
  float* stage = hf + warp * 256;  // this warp's 16 x 16 (hf is free now)
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int n0 = band * 16 * NF + j * 16;
    wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, col = e & 15;
      if (r0 + r < N) {
        float v = stage[e] + __bfloat162float(b1[s * D2 + n0 + col]);
        if (act_last) v = silu(v);
        out[((size_t)s * N + r0 + r) * D2 + n0 + col] = __float2bfloat16(v);
      }
    }
    __syncwarp();
  }
}

// out[s, n, :] = act(sum_p part[p, s, n, :] + b1[s]) in bf16, parts added
// in order.
__global__ void mlp2_reduce_kernel(const float* __restrict__ part,
                                   const bf16* __restrict__ b1,
                                   bf16* __restrict__ out, int N, int npad,
                                   int S, int D2, int parts, int act_last) {
  const size_t total = (size_t)S * N * D2;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int col = (int)(i % D2);
    const size_t sn = i / D2;
    const int n = (int)(sn % N), s = (int)(sn / N);
    float v = 0.f;
    for (int q = 0; q < parts; ++q)
      v += part[(((size_t)q * S + s) * npad + n) * D2 + col];
    v += __bfloat162float(b1[s * D2 + col]);
    if (act_last) v = silu(v);
    out[i] = __float2bfloat16(v);
  }
}

size_t smem_bytes(int D, int D2) {
  return (size_t)kBM * (D + 8) * 2 + w0_bytes(D) + (size_t)D2 * kLdH * 2 +
         (size_t)kBM * kLdH * 2;
}

template <int NF>
cudaError_t launch(const bf16* x, const bf16* w0, const bf16* b0,
                   const bf16* w1, const bf16* b1, bf16* out, float* part,
                   int N, int D, int S, int H, int act_last, int parts,
                   int chunks_per_part, cudaStream_t st) {
  auto kernel = mlp2_fused_kernel<NF>;
  const size_t smem = smem_bytes(D, 64 * NF);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBM - 1) / kBM, S, parts);
  kernel<<<grid, kThreads, smem, st>>>(x, w0, b0, w1, b1, out, part, N, D, S,
                                       H, act_last, chunks_per_part);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (N, D), w0 (S*H, D), b0 (S*H,), w1 (S, D2, H), b1 (S, D2), out
// (S, N, D2): bf16, contiguous, 16-byte aligned.  D % 16 == 0, H % 64 ==
// 0, D2 in {64, 128, 256, 512}.  parts > 1 splits each split's H / 64
// chunks into runs of chunks_per_part and needs part, float32 scratch of
// (parts, S, ceil(N / 64) * 64, D2).  Returns the cudaError_t of the
// launches.
int qaig_mlp2_fused(const void* x, const void* w0, const void* b0,
                    const void* w1, const void* b1, void* out, void* part,
                    int N, int D, int S, int H, int D2, int act_last,
                    int parts, int chunks_per_part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w0b = static_cast<const bf16*>(w0);
  const bf16* b0b = static_cast<const bf16*>(b0);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* b1b = static_cast<const bf16*>(b1);
  bf16* outb = static_cast<bf16*>(out);
  float* partf = parts > 1 ? static_cast<float*>(part) : nullptr;
  cudaError_t err;
  switch (D2) {
    case 64:
      err = launch<1>(xb, w0b, b0b, w1b, b1b, outb, partf, N, D, S, H,
                      act_last, parts, chunks_per_part, st);
      break;
    case 128:
      err = launch<2>(xb, w0b, b0b, w1b, b1b, outb, partf, N, D, S, H,
                      act_last, parts, chunks_per_part, st);
      break;
    case 256:
      err = launch<4>(xb, w0b, b0b, w1b, b1b, outb, partf, N, D, S, H,
                      act_last, parts, chunks_per_part, st);
      break;
    case 512:
      err = launch<8>(xb, w0b, b0b, w1b, b1b, outb, partf, N, D, S, H,
                      act_last, parts, chunks_per_part, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || partf == nullptr) return (int)err;
  const int npad = (N + kBM - 1) / kBM * kBM;
  const size_t total = (size_t)S * N * D2;
  const int blocks = (int)((total + 255) / 256 < 65536 ? (total + 255) / 256
                                                        : 65536);
  mlp2_reduce_kernel<<<blocks, 256, 0, st>>>(partf, b1b, outb, N, npad, S,
                                             D2, parts, act_last);
  return (int)cudaGetLastError();
}

const char* qaig_mlp2_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
