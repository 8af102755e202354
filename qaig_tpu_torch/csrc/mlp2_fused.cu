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
// read, 100 MB per packed-QKV layer at N 8192).  Inside the kernel a
// block of 64 rows does 128 operations per weight element it reads, so the
// weights cross L2 once per row tile unless blocks share them.
//
// What the design does about it.  A block takes 64 rows and one split and
// walks that split's hidden in chunks of 64 columns, warp-specialised:
//   - one producer thread (warpgroup 2, its registers given up with
//     setmaxnreg) issues TMA copies, 128-byte swizzled: the block's x tile
//     once (64 x D, resident), then the w0 chunks in 64 x 64 K-blocks and
//     the w1 chunks in two halves (D2 / 2 x 64 each), into two rings of
//     shared-memory stages with full / empty mbarriers;
//   - two consumer warpgroups run both products on wgmma, A and B read from
//     shared memory through matrix descriptors.  The chunks go in pairs:
//     warpgroup i computes product 1 of chunk 2p + i, h_c = x_tile w0_c^T
//     (m64n64k16 over D), adds b0, applies silu in registers, rounds to
//     bf16 and stores the 64 x 64 tile into hidden buffer i in the swizzled
//     layout wgmma reads (mbarriers hand the buffer over).  Then each
//     warpgroup runs product 2 of both chunks on its half of D2,
//     acc += h_c w1_c[iD2/2 .. (i+1)D2/2)^T (m64n(D2/2)k16), into a
//     float32 64 x D2/2 accumulator in registers (128 a thread at D2 512).
//     Every commit is followed by a wait for all but the newest group, so
//     a warpgroup's next products queue behind the running ones, and the
//     stages the finished group read are released then.
//   b1, act_last and the rounding come only after the split's last chunk,
//   so silu never sees a partial sum.  Each split's hidden columns are its
//   own: the kernel does exactly the function's operations.
//
// Weights.  Blocks of a thread-block cluster (2 or 4 consecutive row tiles
// of the same split and hidden part) share every w0 and w1 tile: the
// cluster's first block issues each weight copy once with TMA multicast
// into the same stage of every block of the cluster, after all of them
// have released it (one arrival per consumer warpgroup, across the
// cluster); the other blocks only arm their own full barriers.  Weight
// reads from L2 fall by the cluster size: packed QKV at N 8192 reads
// 1.61 GB per call in 64-row blocks alone, 0.81 GB in pairs, 0.40 GB in
// clusters of 4.  The card holds 132 blocks of this kernel alone or in
// pairs but 120 in clusters of 4, so the wrapper takes clusters of 4 only
// where they add no wave (ops/mlp_fused.py::launch_geometry): measured on
// the H100, the loads are a small share of the time, and a wave is not.
//
// Occupancy.  One block of 3 warpgroups per SM (the x tile and the rings
// take up to 225 KB of shared memory).  When the row tiles x splits leave
// more than half of the resident blocks idle (N 1024: 16 x 3 or 16 x 1
// blocks), the wrapper also splits each split's hidden chunks over `parts`
// blocks, each writing its float32 partial sums to a scratch (parts, S,
// Npad, D2); a second launch adds the parts in order (no atomics), then
// b1, act_last and the rounding.  Ragged N and D: TMA fills what lies
// past the tensors with zeros, and the stores are masked.

#include "hopper.cuh"

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace qaig;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;   // consumer warpgroups 0-1, producer 2
constexpr int kBM = 64;         // rows per block
constexpr int kHC = 64;         // hidden columns per chunk
constexpr int kTile = 8192;     // bytes of a 64 x 64 bf16 tile (128-byte rows)
constexpr int kW0Stages = 6;    // w0 K-blocks in flight

// w1 half-chunks (D2 / 2 rows x 64 hidden) in flight
__host__ __device__ constexpr int w1_stages(int nf) {
  return nf == 8 ? 3 : 4;
}

__host__ __device__ inline size_t smem_bytes(int D, int D2) {
  const int kb = (D + 63) / 64, nf = D2 / 64;
  const int bars = 5 + 2 * kW0Stages + 2 * w1_stages(nf);
  return 1024 + (size_t)kb * kTile + 2 * kTile + kW0Stages * kTile +
         (size_t)w1_stages(nf) * nf * 4096 + 8 * bars;
}

// silu from the special function unit's exponential and reciprocal
// (ex2.approx, rcp.approx; relative error ~1e-6, far under the bf16
// rounding that follows).  expf and an IEEE division take several times
// the instructions, and the hidden epilogue's 64 x 64 of them per chunk
// run while the tensor cores wait.
__device__ __forceinline__ float silu(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-1.4426950408889634f * v));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return v * r;
}

// ---- clusters ---------------------------------------------------------------

// arrive on the barrier at b's offset in block `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* b, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::
          "r"(smem_addr(b)),
      "r"(cta)
      : "memory");
}

// the same tile into the same offset of every block in `mask`, each
// block's barrier at bar's offset receiving the bytes
__device__ __forceinline__ void tma_load_multicast(const CUtensorMap* map,
                                                   void* dst, uint64_t* bar,
                                                   int c0, int c1,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// d (64 x N, float32; the warpgroup's accumulator fragments) = a b^T + d
// (d ignored when scale_d is 0), a 64 x 16 and b N x 16 from shared memory.
// Fragment: thread t of the warpgroup holds, for each 8 columns j, rows
// 16 (t / 32) + (t % 32) / 4 (+ 8 in d[4j + 2..3]), columns 8j + 2 (t % 4)
// and + 1.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


// ---- the kernel -----------------------------------------------------------

// D2 = 64 * NF.  Grid (row tiles padded to the cluster, S, parts); blocks
// of a cluster are consecutive row tiles.  The split's hidden chunks go in
// pairs: warpgroup i computes product 1 of chunk 2p + i of pair p (the
// whole 64 x 64 hidden tile, m64n64k16) into hidden buffer i, then both
// warpgroups run product 2 of both chunks on their halves of D2.
template <int NF>
__global__ void __launch_bounds__(kThreads, 1) mlp2_fused_kernel(
    const __grid_constant__ CUtensorMap x_map,
    const __grid_constant__ CUtensorMap w0_map,
    const __grid_constant__ CUtensorMap w1_map, const bf16* __restrict__ b0,
    const bf16* __restrict__ b1, bf16* __restrict__ out,
    float* __restrict__ part, int N, int D, int S, int H, int act_last,
    int chunks_per_part) {
  constexpr int D2 = 64 * NF;
  constexpr int kHalf = D2 / 2;            // product 2's columns a warpgroup
  constexpr int kW1Stages = w1_stages(NF);
  constexpr int kW1Bytes = kHalf * 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* xs = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const int KB = (D + 63) / 64;  // 64-wide K-blocks of x and w0
  unsigned char* hs = xs + KB * kTile;     // two bf16 hidden chunks
  unsigned char* w0s = hs + 2 * kTile;     // kW0Stages tiles
  unsigned char* w1s = w0s + kW0Stages * kTile;
  uint64_t* xbar = reinterpret_cast<uint64_t*>(w1s + kW1Stages * kW1Bytes);
  uint64_t* w0_full = xbar + 1;
  uint64_t* w0_empty = w0_full + kW0Stages;
  uint64_t* w1_full = w0_empty + kW0Stages;
  uint64_t* w1_empty = w1_full + kW1Stages;
  uint64_t* h_full = w1_empty + kW1Stages;  // per hidden buffer
  uint64_t* h_empty = h_full + 2;

  const int row0 = blockIdx.x * kBM;
  const int s = blockIdx.y;
  const int c_begin = blockIdx.z * chunks_per_part;
  const int nch = min(H / kHC, c_begin + chunks_per_part) - c_begin;
  const uint32_t rank = cluster_rank(), nblocks = cluster_blocks();

  if (threadIdx.x == 0) {
    mbar_init(xbar, 1);
    // the empty barriers count only in the cluster's first block, which
    // issues the copies: one arrival per consumer warpgroup of every block
    // (each stage has one reader in a block)
    for (int i = 0; i < kW0Stages; ++i) {
      mbar_init(&w0_full[i], 1);
      mbar_init(&w0_empty[i], nblocks);
    }
    for (int i = 0; i < kW1Stages; ++i) {
      mbar_init(&w1_full[i], 1);
      mbar_init(&w1_empty[i], nblocks);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&h_full[i], 128);  // every thread of the writing warpgroup
      mbar_init(&h_empty[i], 2);   // both warpgroups' product 2 is done
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      const uint16_t mask = (uint16_t)((1u << nblocks) - 1);
      // load n of a ring, round r = n / stages: the first block waits for
      // every block's consumers to release the stage; the others only for
      // their own barrier's previous round to complete before arming it
      auto acquire = [&](uint64_t* full, uint64_t* empty, int r) {
        if (rank == 0)
          mbar_wait(empty, (r & 1) ^ 1);
        else if (r > 0)
          mbar_wait(full, (r - 1) & 1);
      };
      auto load = [&](const CUtensorMap* map, void* dst, uint64_t* full,
                      int c0, int c1) {
        if (rank != 0) return;
        if (nblocks > 1)
          tma_load_multicast(map, dst, full, c0, c1, mask);
        else
          tma_load(map, dst, full, c0, c1);
      };
      mbar_expect_tx(xbar, KB * kTile);
      for (int kb = 0; kb < KB; ++kb)
        tma_load(&x_map, xs + kb * kTile, xbar, kb * 64, row0);
      int n0 = 0, n1 = 0;
      for (int pr = 0; 2 * pr < nch; ++pr) {
        const int nc = min(2, nch - 2 * pr);  // chunks of this pair
        const int c = c_begin + 2 * pr;
        // w0 K-blocks of the pair's chunks, interleaved as the two
        // warpgroups read them
        for (int kb = 0; kb < KB; ++kb) {
          for (int i = 0; i < nc; ++i, ++n0) {
            const int st = n0 % kW0Stages;
            acquire(&w0_full[st], &w0_empty[st], n0 / kW0Stages);
            mbar_expect_tx(&w0_full[st], kTile);
            load(&w0_map, w0s + st * kTile, &w0_full[st], kb * 64,
                 s * H + (c + i) * kHC);
          }
        }
        for (int i = 0; i < nc; ++i) {
          for (int half = 0; half < 2; ++half, ++n1) {
            const int st = n1 % kW1Stages;
            acquire(&w1_full[st], &w1_empty[st], n1 / kW1Stages);
            mbar_expect_tx(&w1_full[st], kW1Bytes);
            load(&w1_map, w1s + st * kW1Bytes, &w1_full[st], (c + i) * kHC,
                 s * D2 + half * kHalf);
          }
        }
      }
    }
    __syncwarp();
    cluster_sync();
  } else {
    // ---- consumers: warpgroup wg ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = threadIdx.x & 127, lane = t & 31;
    const int r_lo = 16 * (t >> 5) + (lane >> 2);  // rows r_lo, r_lo + 8
    const int q2 = 2 * (lane & 3);                 // columns q2, q2 + 1
    float acc[kHalf / 2];
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) acc[i] = 0.f;
    float h[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) h[i] = 0.f;
    // Each commit is followed by a wait for all but the newest group; the
    // stages and hidden buffer the group before it read are then released
    // by one thread (the warpgroup's products are complete): ring stages
    // to the cluster's first block, which refills them.
    int pend_w0 = -1, pend_w1 = -1, pend_h = -1;
    auto retire = [&]() {
      if (t == 0) {
        if (pend_w0 >= 0) {
          if (nblocks > 1)
            mbar_arrive_cluster(&w0_empty[pend_w0], 0);
          else
            mbar_arrive(&w0_empty[pend_w0]);
        }
        if (pend_w1 >= 0) {
          if (nblocks > 1)
            mbar_arrive_cluster(&w1_empty[pend_w1], 0);
          else
            mbar_arrive(&w1_empty[pend_w1]);
        }
        if (pend_h >= 0) mbar_arrive(&h_empty[pend_h]);
      }
      pend_w0 = pend_w1 = pend_h = -1;
    };
    mbar_wait(xbar, 0);
    for (int pr = 0; 2 * pr < nch; ++pr) {
      const int nc = min(2, nch - 2 * pr);
      if (wg < nc) {
        const int c = c_begin + 2 * pr + wg;
        // this thread's b0 pairs, loaded before product 1 so that their
        // latency hides behind it
        __nv_bfloat162 bias[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          bias[j] = *reinterpret_cast<const __nv_bfloat162*>(
              b0 + (size_t)s * H + c * kHC + 8 * j + q2);
        // product 1: h = x_tile w0_c^T
        for (int kb = 0; kb < KB; ++kb) {
          const int n0 = 2 * KB * pr + nc * kb + wg;
          const int st = n0 % kW0Stages;
          mbar_wait(&w0_full[st], (n0 / kW0Stages) & 1);
          wgmma_fence();
          const uint64_t da = desc(xs + kb * kTile);
          const uint64_t db = desc(w0s + st * kTile);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_ss<64>(h, da + 2 * ks, db + 2 * ks, (kb | ks) != 0);
          wgmma_commit();
          wgmma_wait<1>();
          retire();
          pend_w0 = st;
        }
        wgmma_wait<0>();
        fence_regs(h);
        retire();

        // bias, silu, bf16, into hidden buffer wg in the swizzled layout
        // product 2 reads, once both warpgroups are done with its last use
        if (pr > 0) mbar_wait(&h_empty[wg], (pr - 1) & 1);
        unsigned char* ht = hs + wg * kTile;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 b = __bfloat1622float2(bias[j]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = r_lo + 8 * e;
            const __nv_bfloat162 v =
                __floats2bfloat162_rn(silu(h[4 * j + 2 * e] + b.x),
                                      silu(h[4 * j + 2 * e + 1] + b.y));
            *reinterpret_cast<__nv_bfloat162*>(
                ht + r * 128 + ((j ^ (r & 7)) << 4) + q2 * 2) = v;
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(&h_full[wg]);
      }

      // product 2 of the pair's chunks: acc += h_c w1_c[wg D2/2 ..]^T
      for (int b = 0; b < nc; ++b) {
        mbar_wait(&h_full[b], pr & 1);
        const int n1 = 2 * (2 * pr + b) + wg;
        const int st1 = n1 % kW1Stages;
        mbar_wait(&w1_full[st1], (n1 / kW1Stages) & 1);
        wgmma_fence();
        const uint64_t da = desc(hs + b * kTile);
        const uint64_t db = desc(w1s + st1 * kW1Bytes);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss<kHalf>(acc, da + 2 * ks, db + 2 * ks, 1);
        wgmma_commit();
        wgmma_wait<1>();
        retire();
        pend_w1 = st1;
        pend_h = b;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int col0 = wg * kHalf + q2;
    if (part != nullptr) {  // float32 partial sums; the reduce launch ends it
      const size_t npad = (size_t)gridDim.x * kBM;
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(
              part + (((size_t)blockIdx.z * S + s) * npad + row0 + r_lo +
                      8 * e) * D2 + col0 + 8 * j) =
              make_float2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
    } else {
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b1 + s * D2 + col0 +
                                                     8 * j));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = row0 + r_lo + 8 * e;
          float v0 = acc[4 * j + 2 * e] + b.x;
          float v1 = acc[4 * j + 2 * e + 1] + b.y;
          if (act_last) {
            v0 = silu(v0);
            v1 = silu(v1);
          }
          if (r < N)
            *reinterpret_cast<__nv_bfloat162*>(
                out + ((size_t)s * N + r) * D2 + col0 + 8 * j) =
                __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    cluster_sync();
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

// ---- host side ------------------------------------------------------------

// every block may take the card's most shared memory (232,448 bytes)
cudaError_t allow_max_smem(const void* kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
}

template <int NF>
cudaError_t launch(const bf16* x, const bf16* w0, const bf16* b0,
                   const bf16* w1, const bf16* b1, bf16* out, float* part,
                   int N, int D, int S, int H, int act_last, int grid_x,
                   int cluster, int parts, int chunks_per_part,
                   cudaStream_t st) {
  constexpr int D2 = 64 * NF;
  auto kernel = mlp2_fused_kernel<NF>;
  const size_t smem = smem_bytes(D, D2);
  static bool allowed[qaig::kMaxDevices] = {};  // the attribute, per device
  const cudaError_t set = qaig::once_per_device(
      allowed, [&] { return allow_max_smem((const void*)kernel); });
  if (set != cudaSuccess) return set;
  CUtensorMap x_map, w0_map, w1_map;
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!tensor_map(&x_map, kBf16, 2, x, N, D, D, 64) ||
      !tensor_map(&w0_map, kBf16, 2, w0, (uint64_t)S * H, D, D, 64) ||
      !tensor_map(&w1_map, kBf16, 2, w1, (uint64_t)S * D2, H, H, D2 / 2))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, S, parts);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, x_map, w0_map, w1_map, b0, b1, out,
                         part, N, D, S, H, act_last, chunks_per_part);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (N, D), w0 (S*H, D), b0 (S*H,), w1 (S, D2, H), b1 (S, D2), out
// (S, N, D2): bf16, contiguous, 16-byte aligned.  D % 16 == 0, H % 64 ==
// 0, D2 in {64, 128, 256, 512}.  grid_x: row tiles of 64 padded to a
// multiple of `cluster` (1, 2 or 4).  parts > 1 splits each split's H / 64
// chunks into runs of chunks_per_part and needs part, float32 scratch of
// (parts, S, grid_x * 64, D2).  Returns the cudaError_t of the launches.
int qaig_mlp2_fused(const void* x, const void* w0, const void* b0,
                    const void* w1, const void* b1, void* out, void* part,
                    int N, int D, int S, int H, int D2, int act_last,
                    int grid_x, int cluster, int parts, int chunks_per_part,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w0b = static_cast<const bf16*>(w0);
  const bf16* b0b = static_cast<const bf16*>(b0);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* b1b = static_cast<const bf16*>(b1);
  bf16* outb = static_cast<bf16*>(out);
  float* partf = parts > 1 ? static_cast<float*>(part) : nullptr;
  if (grid_x % cluster != 0 || grid_x * 64 < N)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (D2) {
    case 64:
      err = launch<1>(xb, w0b, b0b, w1b, b1b, outb, partf, N, D, S, H,
                      act_last, grid_x, cluster, parts, chunks_per_part, st);
      break;
    case 128:
      err = launch<2>(xb, w0b, b0b, w1b, b1b, outb, partf, N, D, S, H,
                      act_last, grid_x, cluster, parts, chunks_per_part, st);
      break;
    case 256:
      err = launch<4>(xb, w0b, b0b, w1b, b1b, outb, partf, N, D, S, H,
                      act_last, grid_x, cluster, parts, chunks_per_part, st);
      break;
    case 512:
      err = launch<8>(xb, w0b, b0b, w1b, b1b, outb, partf, N, D, S, H,
                      act_last, grid_x, cluster, parts, chunks_per_part, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || partf == nullptr) return (int)err;
  const int npad = grid_x * 64;
  const size_t total = (size_t)S * N * D2;
  const int blocks = (int)((total + 255) / 256 < 65536 ? (total + 255) / 256
                                                        : 65536);
  mlp2_reduce_kernel<<<blocks, 256, 0, st>>>(partf, b1b, outb, N, npad, S,
                                             D2, parts, act_last);
  return (int)cudaGetLastError();
}

// Blocks in clusters of `cluster` (1, 2 or 4) that the card holds at once
// for D and D2 as in qaig_mlp2_fused (cudaOccupancyMaxActiveClusters x
// cluster), or -1 on an error.
int qaig_mlp2_fused_resident_blocks(int D, int D2, int cluster) {
  const void* kernel;
  switch (D2) {
    case 64: kernel = (const void*)mlp2_fused_kernel<1>; break;
    case 128: kernel = (const void*)mlp2_fused_kernel<2>; break;
    case 256: kernel = (const void*)mlp2_fused_kernel<4>; break;
    case 512: kernel = (const void*)mlp2_fused_kernel<8>; break;
    default: return -1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(D, D2);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (allow_max_smem(kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess)
    return -1;
  return clusters * cluster;
}

const char* qaig_mlp2_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
