// Float32 products of the linear layers on Hopper's tensor cores at float32
// accuracy: three-pass ("split") TF32 on wgmma.
//
// Replaces no TPU kernel: the JAX package leaves its linear layers to XLA,
// which runs float32 products at full precision on the TPU's matrix unit.
// On the H100, PyTorch sends a float32 product (TF32 off, as every entry
// point of the port sets) to cuBLAS's SIMT sgemm, which runs on the CUDA
// cores at most at the float32 FMA peak of 67 TFLOP/s.  The training step
// of the windowed stage spends three quarters of its device time there.
//
// Function.  C (M, N) = A (M, K) . B (N, K)^T (+ bias (N,)), float32 in and
// out.  Each operand is split into two TF32 numbers, x = hi + lo, hi =
// tf32_rna(x), lo = tf32_rna(x - hi) (round to nearest, as Ootomo & Yokota,
// "Recovering single precision accuracy from Tensor Cores while surpassing
// the FP32 theoretical peak performance", IJHPCA 2022, choose: it keeps 22
// of float32's 24 bits); the products hi.hi + hi.lo + lo.hi are run on
// wgmma.m64n128k8.f32.tf32.tf32 and lo.lo (~2^-22 of a product) is
// dropped.  Nothing is computed in a lower precision than TF32 and no term
// but lo.lo is left out.
//
// Accumulation (after the same paper).  The tensor cores round every
// result toward zero, so a chain of wgmmas on one accumulator loses half
// an ulp of each partial sum, always towards zero.  On an H100, blocks of
// 32 of K chained that way shrank the windowed stage's first gradients by
// 3.3e-6-4.1e-6 of their norm against a plain float32 reference, where
// float32 or float64 products read under 5e-7.  So:
//   - the main term hi.hi of each K-step of 8 is summed alone, from zero,
//     and added to the accumulator with a round-to-nearest float32 add;
//   - the small terms hi.lo + lo.hi (2^-11 of the main) chain in an
//     accumulator of their own, where their rounding is 2^-11 smaller and
//     the main term never truncates them;
//   - each main term's one rounding toward zero loses, on average, half an
//     ulp, 2^-24 / (2 ln 2) of its value for log-uniform mantissas; that
//     much of the accumulated main term is added back with the small terms,
//     in the final sum's one rounding.
// The same gradients then read 7.1e-7-8.2e-7.
//
// What bounds it.  At the training cell's shapes (rows 16,384 or 4,096, K
// and N 512 or 2,048) a product is compute-bound: 6 M N K TF32 operations
// on 4 (M K + 2 N K + M N) bytes, over 400 operations a byte, against the
// card's 495e12 / 3.35e12 = 148.  The bound is 495 / 3 = 165 TFLOP/s of
// float32-accurate work.  Shared memory is the next limit: at the full
// TF32 rate the B tiles wgmma reads (hi twice, lo once a pass) take 64 of
// the SM's 128 bytes a clock, the TMA writes of A and both B tiles ~31,
// the A fragments ~10.
//
// Operand layout (the design's core problem).  TF32 wgmma reads shared-
// memory operands K-major only; A may come from registers instead.  So:
//   - A (raw float32) is loaded by TMA into a 128-byte-swizzled tile as it
//     lies in memory, K-major or M-major, and each consumer thread loads
//     its fragment from it and splits it in registers;
//   - B is split (hi, lo) beforehand by a small kernel into two K-major
//     copies, transposed where B lies M-major; wgmma reads both from
//     shared memory.
// The three products of F.linear, at rows M, in K, out N:
//   forward  Y  = X . W^T:  A = X (K-major), B = W (N, K), split as it lies
//                           (2 N K floats written; 8 MB at 2048 x 512);
//   grad in  dX = dY . W:   A = dY (K-major), B = W^T, a transposed split
//                           copy (the same 8 MB);
//   grad w   dW = dY^T . X: reduced over M, both operands M-major; the
//                           narrower of X and dY (512 of 512 / 2048) is
//                           split transposed, (cols, M) x 2: at 16,384 rows
//                           32 MB read, 64 MB written and 64 MB read back
//                           by the product, against the product's 0.2-0.3
//                           ms of compute; the other is A, M-major.  When
//                           dY is split, C is dW^T, stored transposed.
// Taking B through registers instead is not possible (wgmma's B is shared
// memory only); splitting B inside the kernel would cost each K-block a
// read and two writes of the B tile in shared memory, about 25% more of
// its bandwidth, which the TF32 passes already use most of.
// Where A is M-major its fragment reads would meet 2-way bank conflicts in
// the swizzled tile; the transposed split copy therefore permutes each 8
// of its K (k -> 2k for k < 4, 2(k - 4) + 1 otherwise) and each thread
// reads the A rows in the same order, which makes them conflict-free.
//
// Shape of the kernel.  Persistent blocks (one per SM, 197.7 KB of shared
// memory) walk over 128 x 128 output tiles (times K-splits, below), warp-
// specialised: one producer thread (warpgroup 2, registers given up with
// setmaxnreg) keeps a 4-stage TMA ring of (A, B hi, B lo) 128 x 32 tiles
// in flight; consumer warpgroups 0 and 1 each own 64 rows x 128 columns:
// the accumulator, the small terms and one K-step's main term, 64
// registers each a thread.  A K-step's main term is one commit group and
// its small terms the next, so the warpgroup adds the main term into the
// accumulator while the small terms run.  Where the output tiles do not
// fill the card (dW: 16 or 64 tiles), K is split over up to 32 blocks;
// each writes its float32 partial sums to a scratch and a second launch
// adds them in order (no atomics: a graph replay gives the eager bits).
// The bias is added in the epilogue (or in the adding launch).  Ragged M,
// N and K: TMA fills what lies past the tensors with zeros, and the stores
// are masked.

#include "hopper.cuh"

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;  // consumer warpgroups 0-1, producer 2
constexpr int kBM = 128;       // output rows a tile (64 a consumer warpgroup)
constexpr int kBN = 128;       // output columns a tile
constexpr int kBK = 32;        // K a stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kTile = 128 * 128;  // bytes of a 128 x 32 float32 tile
constexpr int kStageBytes = 3 * kTile;  // A, B hi, B lo
constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes + 16 * kStages;
// E[half an ulp / |x|] = 2^-24 E[1 / m] = 2^-24 / (2 ln 2) for mantissas m
// spread log-uniformly over [1, 2)
constexpr float kRZ = 0.7213475f * 5.9604645e-8f;

using namespace qaig;

// ---- TF32 split ------------------------------------------------------------

// x = hi + lo, both TF32 (round to nearest, ties away); lo is 0 where x is
// not finite
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  float r = x - __uint_as_float(hi);
  r = isfinite(x) ? r : 0.f;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
}

// ---- wgmma ------------------------------------------------------------------

// d (64 x 128, float32) = a b^T + d (d ignored when scale_d is 0): a the
// warpgroup's 64 x 8 TF32 fragment in registers (warp w rows 16w + g and
// + 8, g = lane / 4; a0 / a1 column lane % 4, a2 / a3 that + 4), b 128 x 8
// from shared memory.  Accumulator: thread t holds, for each 8 columns j,
// rows 16 (t / 32) + (t % 32) / 4 (+ 8 in d[4j + 2..3]), columns
// 8j + 2 (t % 4) and + 1.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// ---- the product ------------------------------------------------------------

// Byte offset, in a stage's A tile, of A element (row, k) of this thread's
// fragment: row = 64 wg + 16 warp + g + 8 e, k = 8 ks + tq + 4 h.
//   K-major: the tile is 128 rows x 32 floats, 128-byte swizzled.
//   M-major: four 32 x 32 sub-tiles (32 rows of K x 32 output rows each,
//   4 KB apart), 128-byte swizzled; fragment position k reads tile row
//   8 ks + 2 tq + h (the permuted order of the split B copy).
template <bool kMN>
__device__ __forceinline__ int a_offset(int row, int ks, int tq, int h) {
  if (kMN) {
    const int krow = 8 * ks + 2 * tq + h, mm = row & 31;
    return (row >> 5) * 4096 + krow * 128 +
           ((((mm >> 2) ^ (krow & 7))) << 4) + ((mm & 3) << 2);
  }
  return row * 128 + ((((2 * ks + h) ^ (row & 7))) << 4) + (tq << 2);
}

// C = A . B^T (+ bias) over units (output tile, K-split) of this block.
// splits > 1: a unit writes its partial sums to ws[split] (M x N, row-
// major), no bias; otherwise C(m, n) = out[m c_rs + n c_cs].
template <bool kMN>
__global__ void __launch_bounds__(kThreads, 1) linear_f32_kernel(
    const __grid_constant__ CUtensorMap a_map,
    const __grid_constant__ CUtensorMap bhi_map,
    const __grid_constant__ CUtensorMap blo_map,
    const float* __restrict__ bias, float* __restrict__ out,
    float* __restrict__ ws, long long c_rs, long long c_cs, int M, int N,
    int K, int splits) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* tiles = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int n_tiles = (N + kBN - 1) / kBN;
  const int units = (M + kBM - 1) / kBM * n_tiles * splits;
  const int kblocks = (K + kBK - 1) / kBK;
  const int per_split = (kblocks + splits - 1) / splits;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int n = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int tile = u / splits, sp = u % splits;
        const int m0 = tile / n_tiles * kBM, n0 = tile % n_tiles * kBN;
        const int kb_end = min(kblocks, (sp + 1) * per_split);
        for (int kb = sp * per_split; kb < kb_end; ++kb, ++n) {
          const int st = n % kStages;
          mbar_wait(&empty[st], ((n / kStages) & 1) ^ 1);
          unsigned char* s = tiles + st * kStageBytes;
          mbar_expect_tx(&full[st], kStageBytes);
          if (kMN) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              tma_load(&a_map, s + j * 4096, &full[st], m0 + 32 * j,
                       kb * kBK);
          } else {
            tma_load(&a_map, s, &full[st], kb * kBK, m0);
          }
          tma_load(&bhi_map, s + kTile, &full[st], kb * kBK, n0);
          tma_load(&blo_map, s + 2 * kTile, &full[st], kb * kBK, n0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg, rows 64 wg .. 64 wg + 63 of a tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int t = threadIdx.x & 127, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row = 64 * wg + 16 * (t >> 5) + g;  // and row + 8
  float acc[64], corr[64], part[64];
  int n = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u / splits, sp = u % splits;
    const int m0 = tile / n_tiles * kBM, n0 = tile % n_tiles * kBN;
    const int kb_end = min(kblocks, (sp + 1) * per_split);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = corr[i] = 0.f;
    for (int kb = sp * per_split; kb < kb_end; ++kb, ++n) {
      const int st = n % kStages;
      mbar_wait(&full[st], (n / kStages) & 1);
      const unsigned char* s = tiles + st * kStageBytes;
      // fragments of the 4 K-steps: [4 ks + r], r = a0..a3 (e = r & 1
      // the + 8 row, h = r >> 1 the + 4 column)
      uint32_t hi[16], lo[16];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = *reinterpret_cast<const float*>(
              s + a_offset<kMN>(row + 8 * (r & 1), ks, tq, r >> 1));
          split_tf32(x, hi[4 * ks + r], lo[4 * ks + r]);
        }
      wgmma_fence();
      // each K-step: hi . hi alone from zero (the main term, one rounding
      // of 8 products), added to acc in float32; the small terms chained
      // in corr; the next step's main term queues behind them
      const uint64_t bh = desc(s + kTile), bl = desc(s + 2 * kTile);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_tf32(part, hi[4 * ks], hi[4 * ks + 1], hi[4 * ks + 2],
                   hi[4 * ks + 3], bh + 2 * ks, 0);
        wgmma_commit();
        wgmma_tf32(corr, lo[4 * ks], lo[4 * ks + 1], lo[4 * ks + 2],
                   lo[4 * ks + 3], bh + 2 * ks, 1);
        wgmma_tf32(corr, hi[4 * ks], hi[4 * ks + 1], hi[4 * ks + 2],
                   hi[4 * ks + 3], bl + 2 * ks, 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
        wgmma_fence();
      }
      wgmma_wait<0>();
      fence_regs(corr);
      fence_regs(hi);
      fence_regs(lo);
      if (t == 0) mbar_arrive(&empty[st]);
    }
    // The tensor cores round each main term toward zero: half an ulp lost
    // on average, kRZ of the value, so kRZ x acc over the K-steps; added
    // back with corr, in the sum's one rounding.
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += fmaf(acc[i], kRZ, corr[i]);

    // epilogue
    float* dst = out;
    long long rs = c_rs, cs = c_cs;
    const float* b = bias;
    if (splits > 1) {
      dst = ws + (size_t)sp * M * N;
      rs = N;
      cs = 1;
      b = nullptr;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * tq;
      if (col >= N) continue;
      float b0 = 0.f, b1 = 0.f;
      if (b != nullptr) {
        b0 = b[col];
        b1 = b[col + 1];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + row + 8 * e;
        if (m >= M) continue;
        const float v0 = acc[4 * j + 2 * e] + b0;
        const float v1 = acc[4 * j + 2 * e + 1] + b1;
        if (cs == 1) {
          *reinterpret_cast<float2*>(dst + m * rs + col) =
              make_float2(v0, v1);
        } else {
          dst[m * rs + col * cs] = v0;
          dst[m * rs + (col + 1) * cs] = v1;
        }
      }
    }
  }
}

// C(m, n) = sum_s ws[s](m, n) (+ bias[n]), the splits added in order
__global__ void linear_f32_reduce_kernel(const float* __restrict__ ws,
                                         const float* __restrict__ bias,
                                         float* __restrict__ out,
                                         long long c_rs, long long c_cs,
                                         int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const long long col = (long long)(i % N), m = (long long)(i / N);
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v += ws[(size_t)s * total + i];
    if (bias != nullptr) v += bias[col];
    out[m * c_rs + col * c_cs] = v;
  }
}

// ---- the split of B ---------------------------------------------------------

// hi, lo (R, C), contiguous = split of src (R, C), row stride lds
__global__ void split_kernel(const float* __restrict__ src, long long lds,
                             int R, int C, uint32_t* __restrict__ hi,
                             uint32_t* __restrict__ lo) {
  const size_t total = (size_t)R * C;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / C, c = i % C;
    split_tf32(src[r * lds + c], hi[i], lo[i]);
  }
}

// hi, lo (C, Rp), contiguous = split of src^T, src (R, C) with row stride
// lds; columns R .. Rp - 1 are zero.  permute: each 8 of R in the order the
// M-major A fragments read (column p of a group holds row 2p for p < 4,
// 2 (p - 4) + 1 otherwise).  Blocks of 32 x 8 threads, 32 x 32 tiles.
__global__ void split_t_kernel(const float* __restrict__ src, long long lds,
                               int R, int C, int Rp, int permute,
                               uint32_t* __restrict__ hi,
                               uint32_t* __restrict__ lo) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = blockIdx.x * 32;
  const int p = tx & 7;
  const int lr = permute ? (tx & ~7) | (p < 4 ? 2 * p : 2 * (p - 4) + 1) : tx;
  for (int c0 = blockIdx.y * 32; c0 < C; c0 += gridDim.y * 32) {
    for (int i = ty; i < 32; i += 8) {
      const int r = r0 + i, c = c0 + tx;
      tile[i][tx] = (r < R && c < C) ? src[(size_t)r * lds + c] : 0.f;
    }
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {
      const int c = c0 + i, col = r0 + tx;
      if (c < C && col < Rp) {
        const size_t o = (size_t)c * Rp + col;
        split_tf32(tile[lr][i], hi[o], lo[o]);
      }
    }
    __syncthreads();
  }
}

// ---- host side --------------------------------------------------------------

template <bool kMN>
cudaError_t launch(const CUtensorMap& a_map, const CUtensorMap& bhi_map,
                   const CUtensorMap& blo_map, const float* bias, float* out,
                   float* ws, long long c_rs, long long c_cs, int M, int N,
                   int K, int splits, int grid, cudaStream_t st) {
  auto kernel = linear_f32_kernel<kMN>;
  static bool allowed[qaig::kMaxDevices] = {};  // the attribute, per device
  const cudaError_t set = qaig::once_per_device(allowed, [&] {
    return cudaFuncSetAttribute((const void*)kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kSmem);
  });
  if (set != cudaSuccess) return set;
  kernel<<<grid, kThreads, kSmem, st>>>(a_map, bhi_map, blo_map, bias, out,
                                        ws, c_rs, c_cs, M, N, K, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// hi, lo = the TF32 split of src (R, C), row stride lds (elements, 16-byte
// aligned rows).  transpose 0: hi, lo (R, C) contiguous.  transpose 1:
// hi, lo (C, rp) contiguous, rp >= R, columns past R zero, each 8 of R
// permuted when `permute` (see split_t_kernel).
int qaig_linear_f32_split(const void* src, long long lds, int R, int C,
                          int transpose, int permute, int rp, void* hi,
                          void* lo, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(src);
  uint32_t* h = static_cast<uint32_t*>(hi);
  uint32_t* l = static_cast<uint32_t*>(lo);
  if (R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (transpose) {
    if (rp < R || rp % 8) return (int)cudaErrorInvalidValue;
    const dim3 grid((rp + 31) / 32, (C + 31) / 32 < 65535 ? (C + 31) / 32
                                                          : 65535);
    split_t_kernel<<<grid, dim3(32, 8), 0, st>>>(s, lds, R, C, rp, permute,
                                                 h, l);
  } else {
    const size_t total = (size_t)R * C;
    const int blocks =
        (int)((total + 255) / 256 < 65536 ? (total + 255) / 256 : 65536);
    split_kernel<<<blocks, 256, 0, st>>>(s, lds, R, C, h, l);
  }
  return (int)cudaGetLastError();
}

// C (M, N) = A . B^T (+ bias), C(m, n) at out[m c_rs + n c_cs].
// A: a_mn 0: (M, K) with row stride lda; a_mn 1: stored as (K, M) with row
// stride lda.  B: bhi, blo (N, ldb) TF32 splits, K <= ldb (columns past K
// are zero), or past the tensor.  Strides in elements, multiples of 4;
// pointers 16-byte aligned; c_cs == 1 needs c_rs even.  splits > 1 needs
// ws, float32 scratch of (splits, M, N), and adds the splits in a second
// launch.  grid: persistent blocks (at most one per SM).  Returns the
// cudaError_t of the launches.
int qaig_linear_f32(const void* a, long long lda, int a_mn, const void* bhi,
                    const void* blo, long long ldb, const void* bias,
                    void* out, long long c_rs, long long c_cs, void* ws,
                    int M, int N, int K, int splits, int grid,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || splits < 1 || grid < 1 ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap a_map, bhi_map, blo_map;
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const bool a_ok = a_mn ? tensor_map(&a_map, kF32, 4, a, K, M, lda, 32)
                         : tensor_map(&a_map, kF32, 4, a, M, K, lda, kBM);
  if (!a_ok || !tensor_map(&bhi_map, kF32, 4, bhi, N, ldb, ldb, kBN) ||
      !tensor_map(&blo_map, kF32, 4, blo, N, ldb, ldb, kBN))
    return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  const cudaError_t err =
      a_mn ? launch<true>(a_map, bhi_map, blo_map, b, o, w, c_rs, c_cs, M, N,
                          K, splits, grid, st)
           : launch<false>(a_map, bhi_map, blo_map, b, o, w, c_rs, c_cs, M,
                           N, K, splits, grid, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t total = (size_t)M * N;
  const int blocks =
      (int)((total + 255) / 256 < 65536 ? (total + 255) / 256 : 65536);
  linear_f32_reduce_kernel<<<blocks, 256, 0, st>>>(w, b, o, c_rs, c_cs, M, N,
                                                   splits);
  return (int)cudaGetLastError();
}

const char* qaig_linear_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
