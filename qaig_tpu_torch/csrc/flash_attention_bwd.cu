// Full-sequence self-attention backward for Hopper (sm_90a).
//
// Replaces the gradient of qaig_tpu/ops/flash_attention.py: _flash_bwd, the
// custom_vjp backward of flash_attention, which the JAX package leaves to
// XLA einsums (no pallas_call) over whole (S, S) float32 score matrices.
//
// Function.  q, k, v, out, dout are (N, S, H*dh) with the heads side by
// side in the feature axis (the forward's layout).  For each (n, h), with
// s = q k^T / sqrt(dh) in float32 (masked causally when asked) and lse its
// row log-sum-exp, recomputed here from those exact scores:
//   p = exp(s - lse), delta = rowsum(dout * out)  (out as the forward
//   rounded it), dv = p^T dout, ds = p * (dout v^T - delta),
//   dq = ds k / sqrt(dh), dk = ds^T q / sqrt(dh),
// returned in the inputs' dtype.  Ragged S and the causal mask are handled
// in the kernels, so nothing is padded or transposed.
//
// What bounds it on the H100.  Five products over the live (query, key)
// pairs, 10 * N * H * pairs * dh flops, on 8 * N * S * H*dh elements moved:
// at S 256 that is ~S / 2 operations per byte, so the bytes bound it on
// paper (5 us at N 8, H 64, S 256 in bf16).  In practice the latency of a
// block's chain of products sets it, and in float32 the FMAs.
//
// What the design does about it.  FlashAttention-2's split into two
// launches, so no (S, S) tensor reaches device memory and nothing needs an
// atomic (deterministic):
//   pass 1, over query tiles: recompute s, keep each row's running max and
//     sum (online softmax, base 2) and accumulate dq, rescaling it when the
//     max moves; write dq, and the row's log2-sum-exp and delta as float32
//     (N, H, S) scratch;
//   pass 2, over key tiles: stream Q, dout, lse and delta (causal: only the
//     queries at or after the block's first key), recompute each (query,
//     key) pair's p and ds, and accumulate dk and dv.
// Four forms of the two passes:
//   bf16 at dh 16-256: tensor cores, mma.sync m16n8k16 (bf16 in, float32
//     accumulate), the forward's building blocks.  A block is 4 warps of 16
//     fixed rows (queries in pass 1, keys in pass 2); the streamed tiles
//     (K/V, or Q/dout with their lse and delta) go through a ring of
//     cp.async slots (all of S <= 256 in flight up to dh 64).  The fixed
//     rows' A fragments come from ldmatrix (kept in registers up to dh 64),
//     the streamed rows' B fragments from ldmatrix, and from ldmatrix.trans
//     for the products whose depth is the tile (dq += ds K, dv += p^T dout,
//     dk += ds^T q).  The score and dP accumulators (a bf16 x bf16 product
//     is exact in float32) are repacked pairwise, rounded to bf16 (relative
//     error 2^-9), as the A fragments of those products, so p and ds never
//     touch shared memory.  Past dh 64 a block writes half of the head dim
//     of the gradients (grid z): a warp's 16 x dh float32 accumulators (two
//     in pass 2, dh registers a lane) would not fit beside the score tiles,
//     and each half recomputes the scores, two products of dh against the
//     four of dh / 2 it keeps.  Past dh 128 the tiles are 32 rows wide.
//     Causal tiles stop at the diagonal and the longest query tiles start
//     first; column tiles with no live pair for a warp are skipped.
//   bf16 at dh 8 (the training path's 64 heads of 8): the same products as
//     mma.sync m16n8k8 without padding dh; a block of 8 warps takes row
//     groups 4b..4b+3 from the front of the sequence and their mirror
//     images from the back, so causal blocks carry equal work.
//   float32 at dh 32-256: exact float32 FMAs (no TF32, no tensor cores),
//     as the port's float32 numerics require, register-blocked as the
//     forward's float32 form: 256 threads as 16 x 16 over 64 fixed rows
//     (queries in pass 1, keys in pass 2), a thread owning 4 fixed rows x 4
//     streamed rows (2 at dh 192 and 256, whose streamed tiles are 32 rows)
//     of the score and dP tiles, both accumulated over dh from float4 rows
//     in shared memory.  Row statistics move once per tile by 16-lane
//     shuffles (pass 1 keeps the online max and sum and rescales dq once a
//     tile).  p and ds go through a per-row strip of shared memory that
//     only the 16 lanes of those rows touch, and the gradients are
//     register-blocked products, 4 rows x dh / 16 columns a thread (dq in
//     pass 1; dv, then dk through the same strip, in pass 2).  The streamed
//     tiles (K/V, or Q/dout with their log2-sum-exp and delta) go through a
//     ring of one or two cp.async slots.  Where a pass has fewer blocks than
//     the card has SMs (8 rows of 4 heads of 128, 2 of 256), a cluster of 2
//     CTAs shares each block's streamed tiles, rank r taking tiles r, r + 2,
//     .., and rank 0 folds rank 1's running max, sum and partial gradients
//     in through distributed shared memory, in rank order (deterministic);
//     the plan chooses (flash_attention.backward_launch_plan).
//   float32 at dh 8 and 16: a row in the registers of dh / 8 lanes, every
//     key (query) read from shared memory feeding the 32 rows of a warp; at
//     these head dims it beats the register-blocked tiles (one or no
//     shuffle a pair, 24 FMAs a lane for each broadcast read).
//   In float32 the error against the plain version is the summation order.
// Head dims 8, 16, 32, 64, 128, 192 and 256, as the forward.

#include "common.cuh"

#include <cooperative_groups.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

using qaig::fast_exp2;
using qaig::mma_16x8x8;
using qaig::pack_bf16;
using qaig::unpack_bf16;

constexpr float kLog2e = 1.4426950408889634f;


// ---- float32 at dh 8 and 16: a row in registers ---------------------------
//
// Each query (pass 1) or key (pass 2) row lives in the registers of dh / 8
// lanes; the streamed tiles go through shared memory and every key (query)
// read there serves the 32 rows of a warp.  At dh 8 and 16 this beat the
// register-blocked tiles below on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md: 0.1349 against 0.1833 ms at dh 8, 0.1269 against 0.1544 at
// dh 16, N8 S256 causal): a whole row's products take no shuffle at dh
// 8 and one at dh 16, and a broadcast key feeds 24 FMAs of each of 32
// lanes, where the tiles read both operands from shared memory.

constexpr int kRowThreads = 128;
constexpr int kRowLane = 8;     // head-dim elements a lane holds
constexpr int kRowTile = 128;   // keys (pass 1) or queries (pass 2) a tile

// E consecutive elements, E a multiple of 2: 16-byte accesses where E and
// the alignment allow (E a multiple of 8 elements), else 8-byte (float32) or
// 4-byte (bf16) ones
template <int E>
__device__ __forceinline__ void load_e(const float* p, float (&x)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 a = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = a.x; x[4 * i + 1] = a.y; x[4 * i + 2] = a.z; x[4 * i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const float2 a = reinterpret_cast<const float2*>(p)[i];
      x[2 * i] = a.x; x[2 * i + 1] = a.y;
    }
  }
}

template <int E>
__device__ __forceinline__ void store_e(float* p, const float (&x)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < E / 2; ++i)
      reinterpret_cast<float2*>(p)[i] = make_float2(x[2 * i], x[2 * i + 1]);
  }
}

template <int E>
__device__ __forceinline__ void load_e_or_zero(const float* p, bool live,
                                               float (&x)[E]) {
  if (live) {
    load_e(p, x);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = 0.f;
  }
}

// sum over the G lanes that hold one row; every lane gets the same bits
// (each butterfly step adds the same two values in either order)
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int offset = G / 2; offset > 0; offset >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

// Stage rows [r0, r0 + rows) of one head of an (N, S, H*DH) tensor as
// float32 into dst (rows x DH).
template <int DH>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      size_t base, int D, int r0, int rows) {
  constexpr int E = kRowLane;
  constexpr int G = DH / E;
  for (int i = threadIdx.x; i < rows * G; i += kRowThreads) {
    const int r = i / G, c = (i % G) * E;
    float x[E];
    load_e(src + base + (size_t)(r0 + r) * D + c, x);
    store_e(dst + r * DH + c, x);
  }
}

// Pass 1: dq, and the rows' log2-sum-exp and delta.
template <int DH>
__global__ void __launch_bounds__(kRowThreads) flash_bwd_dq_rows_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ out,
    const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ lse2, float* __restrict__ delta,
    int S, int H, int causal, float scale, float scale_log2) {
  constexpr int E = kRowLane;
  constexpr int G = DH / E;  // lanes per query row
  constexpr int kRows = kRowThreads / G;
  constexpr int kTile = kRowTile;
  __shared__ __align__(16) float ks[kTile * DH];
  __shared__ __align__(16) float vs[kTile * DH];

  const int tid = threadIdx.x;
  const int c = (tid % G) * E;  // this lane's head-dim slice
  const int bh = blockIdx.x;
  // the longest causal rows first: blocks start in order of blockIdx.y
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int r = q0 + tid / G;
  const bool live = r < S;
  const int D = H * DH;
  const size_t base = (size_t)(bh / H) * S * D + (size_t)(bh % H) * DH;
  const size_t at = base + (size_t)r * D + c;

  float qr[E], dor[E], acc[E];
  load_e_or_zero(q + at, live, qr);
  load_e_or_zero(dout + at, live, dor);
  float dl = 0.f;
  {
    float o[E];
    load_e_or_zero(out + at, live, o);
#pragma unroll
    for (int i = 0; i < E; ++i) dl = fmaf(dor[i], o[i], dl);
  }
  dl = group_sum<G>(dl);
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  // the rows of this warp: keys past its last row are masked for all
  const int warp_first = q0 + (tid & ~31) / G;
  const int warp_last = min(S - 1, warp_first + 32 / G - 1);
  const int kend = causal ? min(S, q0 + kRows) : S;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    const int nk = min(kTile, kend - k0);
    __syncthreads();  // the previous tile's reads are done
    stage<DH>(ks, k, base, D, k0, nk);
    stage<DH>(vs, v, base, D, k0, nk);
    __syncthreads();
    int wk = causal ? min(nk, warp_last + 1 - k0) : nk;
    if (warp_first >= S) wk = 0;
#pragma unroll 1
    for (int j = 0; j < wk; ++j) {
      float kk[E], vv[E];
      load_e(ks + j * DH + c, kk);
      load_e(vs + j * DH + c, vv);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        s = fmaf(qr[i], kk[i], s);
        dp = fmaf(dor[i], vv[i], dp);
      }
      s = group_sum<G>(s) * scale_log2;
      dp = group_sum<G>(dp);
      if (live && (!causal || k0 + j <= r)) {
        if (s > m) {  // the running max moves: rescale the sums
          const float f = fast_exp2(m - s);
          l *= f;
#pragma unroll
          for (int i = 0; i < E; ++i) acc[i] *= f;
          m = s;
        }
        const float e = fast_exp2(s - m);
        l += e;
        const float t = e * (dp - dl);
#pragma unroll
        for (int i = 0; i < E; ++i) acc[i] = fmaf(t, kk[i], acc[i]);
      }
    }
  }

  if (live) {
    // every row keeps key 0, so l >= 1
    const float f = scale / l;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] *= f;
    store_e(dq + at, acc);
    if (c == 0) {
      lse2[(size_t)bh * S + r] = m + log2f(l);
      delta[(size_t)bh * S + r] = dl;
    }
  }
}

// Pass 2: dk and dv.
template <int DH>
__global__ void __launch_bounds__(kRowThreads) flash_bwd_dkdv_rows_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv,
    int S, int H, int causal, float scale, float scale_log2) {
  constexpr int E = kRowLane;
  constexpr int G = DH / E;  // lanes per key row
  constexpr int kRows = kRowThreads / G;
  constexpr int kTile = kRowTile;
  __shared__ __align__(16) float qs[kTile * DH];
  __shared__ __align__(16) float dos[kTile * DH];
  __shared__ float2 stats[kTile];  // (log2-sum-exp, delta) per query

  const int tid = threadIdx.x;
  const int c = (tid % G) * E;
  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * kRows;
  const int j = j0 + tid / G;
  const bool live = j < S;
  const int D = H * DH;
  const size_t base = (size_t)(bh / H) * S * D + (size_t)(bh % H) * DH;
  const size_t at = base + (size_t)j * D + c;

  float kk[E], vv[E], dka[E], dva[E];
  load_e_or_zero(k + at, live, kk);
  load_e_or_zero(v + at, live, vv);
#pragma unroll
  for (int i = 0; i < E; ++i) dka[i] = dva[i] = 0.f;

  // queries before this warp's first key are masked for all its keys
  const int warp_first = j0 + (tid & ~31) / G;
  for (int i0 = causal ? j0 : 0; i0 < S; i0 += kTile) {
    const int nq = min(kTile, S - i0);
    __syncthreads();
    stage<DH>(qs, q, base, D, i0, nq);
    stage<DH>(dos, dout, base, D, i0, nq);
    for (int i = tid; i < nq; i += kRowThreads)
      stats[i] = make_float2(lse2[(size_t)bh * S + i0 + i],
                             delta[(size_t)bh * S + i0 + i]);
    __syncthreads();
    int first = causal ? max(0, warp_first - i0) : 0;
    if (warp_first >= S) first = nq;
#pragma unroll 1
    for (int i = first; i < nq; ++i) {
      float qi[E], doi[E];
      load_e(qs + i * DH + c, qi);
      load_e(dos + i * DH + c, doi);
      const float2 st = stats[i];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < E; ++d) {
        s = fmaf(qi[d], kk[d], s);
        dp = fmaf(doi[d], vv[d], dp);
      }
      s = group_sum<G>(s);
      dp = group_sum<G>(dp);
      if (live && (!causal || i0 + i >= j)) {
        const float p = fast_exp2(fmaf(s, scale_log2, -st.x));
        const float ds = p * (dp - st.y);
#pragma unroll
        for (int d = 0; d < E; ++d) {
          dva[d] = fmaf(p, doi[d], dva[d]);
          dka[d] = fmaf(ds, qi[d], dka[d]);
        }
      }
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < E; ++i) dka[i] *= scale;
    store_e(dk + at, dka);
    store_e(dv + at, dva);
  }
}


// ---- float32 at dh 32-256: register-blocked FMAs --------------------------

constexpr int kF32Threads = 256;  // 16 x 16
constexpr int kF32Rows = 64;      // fixed rows a block: queries, then keys

template <int DH>
struct F32Layout {
  static constexpr int LD = DH + 4;  // float pitch: rows tx + 16c conflict-free
  // streamed rows (keys in pass 1, queries in pass 2) per tile: 32 past
  // dh 128, where two 64-row tiles would not fit beside the fixed rows
  static constexpr int kTile = DH >= 192 ? 32 : 64;
  // tiles in flight: two where they fit beside the fixed rows, one at dh
  // 256; one at dh 32 too, which ran faster there (PERF.md)
  static constexpr int kStages = DH == 32 || DH == 256 ? 1 : 2;
  static constexpr int kCols = kTile / 16;  // streamed rows of a thread
  static constexpr int kLdP = kTile + 4;    // pitch of the p / ds strip
  static constexpr size_t fixed_floats = 2 * kF32Rows * LD + kF32Rows * kLdP;
  // pass 1: Q and dout fixed, kStages K/V tiles; pass 2: K and V fixed,
  // kStages Q/dout tiles with their log2-sum-exp and delta
  static constexpr size_t bytes1 =
      (fixed_floats + (size_t)2 * kStages * kTile * LD) * 4;
  static constexpr size_t bytes2 =
      (fixed_floats + (size_t)2 * kStages * kTile * (LD + 1)) * 4;
};

// Copy `rows` rows from r0 of one head of an (N, S, H*DH) float32 tensor
// into dst (pitch LD) with 16-byte cp.async; rows at or past S are zeroed.
template <int DH, int LD>
__device__ __forceinline__ void load_rows_f32(float* dst,
                                              const float* __restrict__ src,
                                              size_t base, int D, int r0,
                                              int rows, int S) {
  constexpr int kChunks = DH / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += kF32Threads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool live = r0 + r < S;
    qaig::cp_async16(dst + r * LD + c,
                     src + base + (size_t)(live ? r0 + r : 0) * D + c, live);
  }
}

// 4-byte cp.async (zero-filled when not live)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   qaig::smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

// Columns of a lane's OC-wide share of a row (16 lanes cover 16 * OC
// columns): float4 groups 64 apart when OC is a multiple of 4, else float2
// groups 32 apart; neighbouring lanes on neighbouring addresses.
template <int OC>
__device__ __forceinline__ void load_cols(const float* row, int tx,
                                          float (&x)[OC]) {
  if constexpr (OC % 4 == 0) {
#pragma unroll
    for (int h = 0; h < OC / 4; ++h) {
      const float4 a = *reinterpret_cast<const float4*>(row + 64 * h + 4 * tx);
      x[4 * h] = a.x; x[4 * h + 1] = a.y; x[4 * h + 2] = a.z; x[4 * h + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int h = 0; h < OC / 2; ++h) {
      const float2 a = *reinterpret_cast<const float2*>(row + 32 * h + 2 * tx);
      x[2 * h] = a.x; x[2 * h + 1] = a.y;
    }
  }
}

template <int OC>
__device__ __forceinline__ void store_cols(float* row, int tx,
                                           const float (&x)[OC], float f) {
  if constexpr (OC % 4 == 0) {
#pragma unroll
    for (int h = 0; h < OC / 4; ++h)
      *reinterpret_cast<float4*>(row + 64 * h + 4 * tx) =
          make_float4(x[4 * h] * f, x[4 * h + 1] * f, x[4 * h + 2] * f,
                      x[4 * h + 3] * f);
  } else {
#pragma unroll
    for (int h = 0; h < OC / 2; ++h)
      *reinterpret_cast<float2*>(row + 32 * h + 2 * tx) =
          make_float2(x[2 * h] * f, x[2 * h + 1] * f);
  }
}

// sum over the 16 lanes of a row (one half of the warp)
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

// s[i][c] = fixed row (4ty + i) . streamed row (tx + 16c) over DH, both
// read as float4 from shared memory
template <int DH, int LD, int KC>
__device__ __forceinline__ void dot_tile(float (&s)[4][KC], const float* fr,
                                         const float* sr, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < KC; ++c) s[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], b[KC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(fr + (4 * ty + i) * LD + d);
#pragma unroll
    for (int c = 0; c < KC; ++c)
      b[c] = *reinterpret_cast<const float4*>(sr + (tx + 16 * c) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        s[i][c] = fmaf(a[i].x, b[c].x, s[i][c]);
        s[i][c] = fmaf(a[i].y, b[c].y, s[i][c]);
        s[i][c] = fmaf(a[i].z, b[c].z, s[i][c]);
        s[i][c] = fmaf(a[i].w, b[c].w, s[i][c]);
      }
  }
}

// acc[i][.] += sum over the tile's streamed rows j of strip[4ty + i][j] *
// x[j][this lane's columns] (x a streamed tile); only the 16 lanes of
// these rows write and read these strip rows
template <int LD, int KT, int OC>
__device__ __forceinline__ void strip_product(float (&acc)[4][OC],
                                              const float* strip,
                                              const float* x, int tx, int ty) {
  constexpr int kLdP = KT + 4;
#pragma unroll 2
  for (int j = 0; j < KT; j += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(strip + (4 * ty + i) * kLdP + j);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float xv[OC];
      load_cols<OC>(x + (j + u) * LD, tx, xv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                      : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(p, xv[c], acc[i][c]);
      }
    }
  }
}

// this half-warp's 4 rows of the strip <- v (4 x KC, streamed rows tx + 16c)
template <int KT, int KC>
__device__ __forceinline__ void write_strip(float* strip, const float (&v)[4][KC],
                                            int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < KC; ++c)
      strip[(4 * ty + i) * (KT + 4) + tx + 16 * c] = v[i][c];
}

// Pass 1: dq, and the rows' log2-sum-exp and delta.  A cluster of `cs`
// CTAs owns 64 query rows (the last query tiles first); rank r takes key
// tiles r, r + cs, ..., and rank 0 combines the ranks' running max, sum
// and dq through distributed shared memory, in rank order.  Thread (ty,
// tx) holds rows 4ty..4ty+3 and keys tx + 16c of each K/V tile.
template <int DH>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ out,
    const float* __restrict__ dout, float* __restrict__ dq,
    float* __restrict__ lse2, float* __restrict__ delta, int S, int H,
    int causal, float scale, float scale_log2) {
  using L = F32Layout<DH>;
  constexpr int LD = L::LD, KT = L::kTile, KC = L::kCols;
  constexpr int STAGES = L::kStages;
  constexpr int OC = DH / 16;  // dq columns of a thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kF32Rows * LD;
  float* ps = dos + kF32Rows * LD;  // ds strip
  float* ks = ps + kF32Rows * L::kLdP;
  float* vs = ks + STAGES * KT * LD;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x / cs;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32Rows;
  const int row0 = q0 + 4 * ty;
  const int D = H * DH;
  const size_t base = (size_t)(bh / H) * S * D + (size_t)(bh % H) * DH;
  const int kend = causal ? min(S, q0 + kF32Rows) : S;
  const int ntiles = ((kend + KT - 1) / KT - rank + cs - 1) / cs;

  auto load_kv = [&](int j) {  // this rank's j-th tile
    if (j < ntiles) {
      const int slot = (j % STAGES) * KT * LD;
      const int r0 = (rank + j * cs) * KT;
      load_rows_f32<DH, LD>(ks + slot, k, base, D, r0, KT, S);
      load_rows_f32<DH, LD>(vs + slot, v, base, D, r0, KT, S);
    }
    qaig::cp_async_commit();
  };
  load_rows_f32<DH, LD>(qs, q, base, D, q0, kF32Rows, S);
  load_rows_f32<DH, LD>(dos, dout, base, D, q0, kF32Rows, S);
  qaig::cp_async_commit();
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) load_kv(j);

  // delta = rowsum(dout * out), straight from device memory
  float dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x = 0.f;
    if (row0 + i < S) {
      const size_t at = base + (size_t)(row0 + i) * D;
      for (int c = tx; c < DH; c += 16) x = fmaf(dout[at + c], out[at + c], x);
    }
    dl[i] = row_sum16(x);
  }

  float acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = (rank + it * cs) * KT;
    load_kv(it + STAGES - 1);  // into the slot that tile it - 1 freed
    qaig::cp_async_wait<STAGES - 1>();
    __syncthreads();
    const float* kt = ks + (it % STAGES) * KT * LD;
    const float* vt = vs + (it % STAGES) * KT * LD;

    float s[4][KC], dp[4][KC];
    dot_tile<DH, LD, KC>(s, qs, kt, tx, ty);
    dot_tile<DH, LD, KC>(dp, dos, vt, tx, ty);

    const bool need_mask = k0 + KT > S || (causal && k0 + KT - 1 > row0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        float x = s[i][c] * scale_log2;
        if (need_mask) {
          const int key = k0 + tx + 16 * c;
          if (key >= S || (causal && key > row0 + i)) x = -INFINITY;
        }
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int offset = 8; offset > 0; offset >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, offset));
      const float m_new = fmaxf(m[i], mx);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = fast_exp2(m[i] - mu);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const float e = fast_exp2(s[i][c] - mu);
        sum += e;
        s[i][c] = e * (dp[i][c] - dl[i]);  // ds, unnormalised
      }
      l[i] = l[i] * alpha + sum;  // this thread's keys; summed at the end
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }

    // this half-warp's 4 rows of ds, then dq (4 x DH/16) += ds K
    write_strip<KT, KC>(ps, s, tx, ty);
    __syncwarp();
    strip_product<LD, KT, OC>(acc, ps, kt, tx, ty);
    __syncwarp();
    __syncthreads();  // this slot's reads are done before it is refilled
  }

  if (cs > 1) {
    // ranks > 0 leave (m, l, dq) in their shared memory, [value][thread];
    // rank 0 folds them in, in rank order
    qaig::cp_async_wait<0>();
    __syncthreads();  // every thread's copies have landed (a rank may have
                      // had no tile to wait on)
    float* xs = reinterpret_cast<float*>(smem4);
    if (rank > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xs[i * kF32Threads + tid] = m[i];
        xs[(4 + i) * kF32Threads + tid] = l[i];
#pragma unroll
        for (int c = 0; c < OC; ++c)
          xs[(8 + i * OC + c) * kF32Threads + tid] = acc[i][c];
      }
    }
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < cs; ++r) {
        const float* rs = cluster.map_shared_rank(xs, r);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float mr = rs[i * kF32Threads + tid];
          const float mx = fmaxf(m[i], mr);
          const float mu = mx == -INFINITY ? 0.f : mx;
          const float a = fast_exp2(m[i] - mu), b = fast_exp2(mr - mu);
          l[i] = l[i] * a + rs[(4 + i) * kF32Threads + tid] * b;
#pragma unroll
          for (int c = 0; c < OC; ++c)
            acc[i][c] = acc[i][c] * a +
                        rs[(8 + i * OC + c) * kF32Threads + tid] * b;
          m[i] = mx;
        }
      }
    }
    cluster.sync();  // no CTA leaves while rank 0 reads its shared memory
    if (rank > 0) return;
  }

  // every row keeps key 0, so l >= 1
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = row_sum16(l[i]);
    if (row0 + i < S)
      store_cols<OC>(dq + base + (size_t)(row0 + i) * D, tx, acc[i],
                     scale / l[i]);
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (row0 + i < S) {
        lse2[(size_t)bh * S + row0 + i] = m[i] + log2f(l[i]);
        delta[(size_t)bh * S + row0 + i] = dl[i];
      }
    }
  }
}

// Pass 2: dk and dv.  A cluster of `cs` CTAs owns 64 key rows (the first
// key tiles, the longest causal ones, first); rank r takes streamed query
// tiles r, r + cs, ... from the first live one, and rank 0 adds the ranks'
// dk and dv in rank order.  Thread (ty, tx) holds keys 4ty..4ty+3 and queries
// tx + 16c of each Q/dout tile.
template <int DH>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int S, int H, int causal,
    float scale, float scale_log2) {
  using L = F32Layout<DH>;
  constexpr int LD = L::LD, KT = L::kTile, KC = L::kCols;
  constexpr int STAGES = L::kStages;
  constexpr int OC = DH / 16;  // dk and dv columns of a thread
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kF32Rows * LD;
  float* ps = vs + kF32Rows * LD;  // p, then ds, strip
  float* qs = ps + kF32Rows * L::kLdP;
  float* dos = qs + STAGES * KT * LD;
  float* sl = dos + STAGES * KT * LD;  // log2-sum-exp of the streamed rows
  float* sd = sl + STAGES * KT;        // delta of the streamed rows

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x / cs;
  const int j0 = blockIdx.y * kF32Rows;
  const int key0 = j0 + 4 * ty;
  const int D = H * DH;
  const size_t base = (size_t)(bh / H) * S * D + (size_t)(bh % H) * DH;
  const int first = (causal ? j0 / KT : 0) + rank;
  const int ntiles = ((S + KT - 1) / KT - first + cs - 1) / cs;

  auto load_q = [&](int j) {  // this rank's j-th tile
    if (j < ntiles) {
      const int slot = j % STAGES;
      const int i0 = (first + j * cs) * KT;
      load_rows_f32<DH, LD>(qs + slot * KT * LD, q, base, D, i0, KT, S);
      load_rows_f32<DH, LD>(dos + slot * KT * LD, dout, base, D, i0, KT, S);
      for (int r = threadIdx.x; r < KT; r += kF32Threads) {
        const bool live = i0 + r < S;
        const size_t at = (size_t)bh * S + (live ? i0 + r : 0);
        cp_async4(sl + slot * KT + r, lse2 + at, live);
        cp_async4(sd + slot * KT + r, delta + at, live);
      }
    }
    qaig::cp_async_commit();
  };
  load_rows_f32<DH, LD>(ks, k, base, D, j0, kF32Rows, S);
  load_rows_f32<DH, LD>(vs, v, base, D, j0, kF32Rows, S);
  qaig::cp_async_commit();
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) load_q(j);

  float dka[4][OC], dva[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int i0 = (first + it * cs) * KT;
    load_q(it + STAGES - 1);
    qaig::cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int slot = it % STAGES;
    const float* qt = qs + slot * KT * LD;
    const float* dot = dos + slot * KT * LD;

    float s[4][KC], dp[4][KC];
    dot_tile<DH, LD, KC>(s, ks, qt, tx, ty);
    dot_tile<DH, LD, KC>(dp, vs, dot, tx, ty);
    const bool need_mask = i0 + KT > S || (causal && i0 < key0 + 3);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const int r = tx + 16 * c;
      const float lr = sl[slot * KT + r], dr = sd[slot * KT + r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = fast_exp2(fmaf(s[i][c], scale_log2, -lr));
        if (need_mask && (i0 + r >= S || (causal && i0 + r < key0 + i)))
          p = 0.f;
        s[i][c] = p;
        dp[i][c] = p * (dp[i][c] - dr);  // ds
      }
    }

    // this half-warp's 4 key rows of p, dv += p dout; then of ds,
    // dk += ds q
    write_strip<KT, KC>(ps, s, tx, ty);
    __syncwarp();
    strip_product<LD, KT, OC>(dva, ps, dot, tx, ty);
    __syncwarp();
    write_strip<KT, KC>(ps, dp, tx, ty);
    __syncwarp();
    strip_product<LD, KT, OC>(dka, ps, qt, tx, ty);
    __syncwarp();
    __syncthreads();  // this slot's reads are done before it is refilled
  }

  if (cs > 1) {
    // ranks > 0 leave (dk, dv) in their shared memory, [value][thread];
    // rank 0 adds them, in rank order
    qaig::cp_async_wait<0>();
    __syncthreads();  // every thread's copies have landed (a rank may have
                      // had no tile to wait on)
    float* xs = reinterpret_cast<float*>(smem4);
    if (rank > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          xs[(i * OC + c) * kF32Threads + tid] = dka[i][c];
          xs[((4 + i) * OC + c) * kF32Threads + tid] = dva[i][c];
        }
    }
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < cs; ++r) {
        const float* rs = cluster.map_shared_rank(xs, r);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < OC; ++c) {
            dka[i][c] += rs[(i * OC + c) * kF32Threads + tid];
            dva[i][c] += rs[((4 + i) * OC + c) * kF32Threads + tid];
          }
      }
    }
    cluster.sync();  // no CTA leaves while rank 0 reads its shared memory
    if (rank > 0) return;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (key0 + i < S) {
      const size_t at = base + (size_t)(key0 + i) * D;
      store_cols<OC>(dk + at, tx, dka[i], scale);
      store_cols<OC>(dv + at, tx, dva[i], 1.f);
    }
  }
}

// ---- bf16 at dh 8: tensor-core products ----------------------------------

constexpr int kTcTile = 256;             // keys / queries per staged tile
constexpr int kTcPitch = kTcTile + 8;    // bf16 pitch of the transposed tiles

// elements (row, 2t) and (row, 2t + 1) of one head, zeros past the sequence
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* x,
                                              size_t base, int row, int t,
                                              int S, int D) {
  return row < S ? *reinterpret_cast<const uint32_t*>(
                       x + base + (size_t)row * D + 2 * t)
                 : 0u;
}

// the 16-row group of this warp: block b of nb (grid y) takes groups
// 4b..4b+3 (warps 0-3) and 8nb-1-4b-k (warps 4-7, k = w - 4)
__device__ __forceinline__ int tc_group() {
  const int w = threadIdx.x >> 5, k = w & 3;
  const int b = blockIdx.y, nb = gridDim.y;
  return w < 4 ? 4 * b + k : 8 * nb - 1 - 4 * b - k;
}

// Stage rows [r0, r0 + rows8) of one head (dh 8) into x (row-major) and
// xt (transposed, pitch kTcPitch), zeros past the sequence.
__device__ __forceinline__ void stage_tc(__nv_bfloat16* x, __nv_bfloat16* xt,
                                         const __nv_bfloat16* __restrict__ src,
                                         size_t base, int D, int r0,
                                         int rows8, int S) {
  for (int i = threadIdx.x; i < rows8; i += 256) {
    const uint4 u = r0 + i < S ? *reinterpret_cast<const uint4*>(
                                     src + base + (size_t)(r0 + i) * D)
                               : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(x + i * 8) = u;
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int d = 0; d < 8; ++d) xt[d * kTcPitch + i] = e[d];
  }
}

__global__ void __launch_bounds__(256, 4) flash_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
    float* __restrict__ lse2, float* __restrict__ delta, int S, int H,
    int causal, float scale, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTcTile * 8];
  __shared__ __align__(16) __nv_bfloat16 vs[kTcTile * 8];
  __shared__ __align__(16) __nv_bfloat16 kts[8 * kTcPitch];

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = tc_group() * 16;
  const int ra = r0 + g, rb = ra + 8;  // this thread's two rows
  const int bh = blockIdx.x, D = H * 8;
  const size_t base = (size_t)(bh / H) * S * D + (size_t)(bh % H) * 8;

  const uint32_t aq0 = load_pair(q, base, ra, t, S, D);
  const uint32_t aq1 = load_pair(q, base, rb, t, S, D);
  const uint32_t ad0 = load_pair(dout, base, ra, t, S, D);
  const uint32_t ad1 = load_pair(dout, base, rb, t, S, D);
  float da, db;
  {
    const float2 d0 = unpack_bf16(ad0), d1 = unpack_bf16(ad1);
    const float2 o0 = unpack_bf16(load_pair(out, base, ra, t, S, D));
    const float2 o1 = unpack_bf16(load_pair(out, base, rb, t, S, D));
    da = fmaf(d0.y, o0.y, d0.x * o0.x);
    db = fmaf(d1.y, o1.y, d1.x * o1.x);
    for (int offset = 1; offset < 4; offset <<= 1) {
      da += __shfl_xor_sync(0xffffffffu, da, offset);
      db += __shfl_xor_sync(0xffffffffu, db, offset);
    }
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;

  // the block's last row is in its first mirrored group
  const int kend =
      causal ? min(S, 16 * (8 * (int)gridDim.y - 4 * (int)blockIdx.y)) : S;
  for (int k0 = 0; k0 < kend; k0 += kTcTile) {
    const int nk = min(kTcTile, kend - k0);
    __syncthreads();
    stage_tc(ks, kts, k, base, D, k0, (nk + 7) & ~7, S);
    for (int i = threadIdx.x; i < ((nk + 7) & ~7); i += 256)
      *reinterpret_cast<uint4*>(vs + i * 8) =
          k0 + i < S ? *reinterpret_cast<const uint4*>(
                           v + base + (size_t)(k0 + i) * D)
                     : make_uint4(0, 0, 0, 0);
    __syncthreads();
    int n = causal ? min(nk, r0 + 16 - k0) : nk;
    if (r0 >= S) n = 0;
    for (int kb = 0; kb < n; kb += 8) {
      const uint32_t bk =
          *reinterpret_cast<const uint32_t*>(ks + (kb + g) * 8 + 2 * t);
      const uint32_t bv =
          *reinterpret_cast<const uint32_t*>(vs + (kb + g) * 8 + 2 * t);
      float sc[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_16x8x8(sc, aq0, aq1, bk);
      mma_16x8x8(dp, ad0, ad1, bv);
      const int key0 = k0 + kb + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = key0 + (i & 1), row = i < 2 ? ra : rb;
        const bool live = key < S && row < S && (!causal || key <= row);
        sc[i] = live ? sc[i] * scale_log2 : -INFINITY;
      }
      float xa = fmaxf(sc[0], sc[1]), xb = fmaxf(sc[2], sc[3]);
      for (int offset = 1; offset < 4; offset <<= 1) {
        xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, offset));
        xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, offset));
      }
      const float na = fmaxf(ma, xa), nb = fmaxf(mb, xb);
      // a row with no live key so far keeps p = 0
      const float ua = na == -INFINITY ? 0.f : na;
      const float ub = nb == -INFINITY ? 0.f : nb;
      const float fa = fast_exp2(ma - ua), fb = fast_exp2(mb - ub);
      ma = na;
      mb = nb;
      const float p0 = fast_exp2(sc[0] - ua), p1 = fast_exp2(sc[1] - ua);
      const float p2 = fast_exp2(sc[2] - ub), p3 = fast_exp2(sc[3] - ub);
      la = fmaf(la, fa, p0 + p1);
      lb = fmaf(lb, fb, p2 + p3);
      acc[0] *= fa;
      acc[1] *= fa;
      acc[2] *= fb;
      acc[3] *= fb;
      const uint32_t ds0 = pack_bf16(p0 * (dp[0] - da), p1 * (dp[1] - da));
      const uint32_t ds1 = pack_bf16(p2 * (dp[2] - db), p3 * (dp[3] - db));
      const uint32_t bkt =
          *reinterpret_cast<const uint32_t*>(kts + g * kTcPitch + kb + 2 * t);
      mma_16x8x8(acc, ds0, ds1, bkt);
    }
  }

  for (int offset = 1; offset < 4; offset <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, offset);
    lb += __shfl_xor_sync(0xffffffffu, lb, offset);
  }
  if (ra < S) {
    const float f = scale / la;
    *reinterpret_cast<uint32_t*>(dq + base + (size_t)ra * D + 2 * t) =
        pack_bf16(acc[0] * f, acc[1] * f);
    if (t == 0) {
      lse2[(size_t)bh * S + ra] = ma + log2f(la);
      delta[(size_t)bh * S + ra] = da;
    }
  }
  if (rb < S) {
    const float f = scale / lb;
    *reinterpret_cast<uint32_t*>(dq + base + (size_t)rb * D + 2 * t) =
        pack_bf16(acc[2] * f, acc[3] * f);
    if (t == 0) {
      lse2[(size_t)bh * S + rb] = mb + log2f(lb);
      delta[(size_t)bh * S + rb] = db;
    }
  }
}

__global__ void __launch_bounds__(256, 4) flash_bwd_dkdv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S,
    int H, int causal, float scale, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 qs[kTcTile * 8];
  __shared__ __align__(16) __nv_bfloat16 dos[kTcTile * 8];
  __shared__ __align__(16) __nv_bfloat16 qts[8 * kTcPitch];
  __shared__ __align__(16) __nv_bfloat16 dots[8 * kTcPitch];
  __shared__ __align__(16) float2 stats[kTcTile];  // (log2-sum-exp, delta)

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int j0 = tc_group() * 16;
  const int ja = j0 + g, jb = ja + 8;  // this thread's two keys
  const int bh = blockIdx.x, D = H * 8;
  const size_t base = (size_t)(bh / H) * S * D + (size_t)(bh % H) * 8;

  const uint32_t ak0 = load_pair(k, base, ja, t, S, D);
  const uint32_t ak1 = load_pair(k, base, jb, t, S, D);
  const uint32_t av0 = load_pair(v, base, ja, t, S, D);
  const uint32_t av1 = load_pair(v, base, jb, t, S, D);
  float dka[4] = {0.f, 0.f, 0.f, 0.f}, dva[4] = {0.f, 0.f, 0.f, 0.f};

  // the block's first key is in its first front group
  for (int i0 = causal ? 64 * blockIdx.y : 0; i0 < S; i0 += kTcTile) {
    const int nq8 = (min(kTcTile, S - i0) + 7) & ~7;
    __syncthreads();
    stage_tc(qs, qts, q, base, D, i0, nq8, S);
    stage_tc(dos, dots, dout, base, D, i0, nq8, S);
    for (int i = threadIdx.x; i < nq8; i += 256)
      stats[i] = i0 + i < S ? make_float2(lse2[(size_t)bh * S + i0 + i],
                                          delta[(size_t)bh * S + i0 + i])
                            : make_float2(0.f, 0.f);
    __syncthreads();
    int first = causal ? (max(0, j0 - i0) & ~7) : 0;
    if (j0 >= S) first = nq8;
    for (int qb = first; qb < nq8; qb += 8) {
      const uint32_t bq =
          *reinterpret_cast<const uint32_t*>(qs + (qb + g) * 8 + 2 * t);
      const uint32_t bd =
          *reinterpret_cast<const uint32_t*>(dos + (qb + g) * 8 + 2 * t);
      float st[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_16x8x8(st, ak0, ak1, bq);
      mma_16x8x8(dp, av0, av1, bd);
      const float4 ld = *reinterpret_cast<const float4*>(stats + qb + 2 * t);
      const int query0 = i0 + qb + 2 * t;
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int query = query0 + (i & 1), key = i < 2 ? ja : jb;
        const float l = (i & 1) ? ld.z : ld.x, dl = (i & 1) ? ld.w : ld.y;
        const bool live = query < S && (!causal || query >= key);
        p[i] = live ? fast_exp2(fmaf(st[i], scale_log2, -l)) : 0.f;
        ds[i] = p[i] * (dp[i] - dl);
      }
      const uint32_t bdt =
          *reinterpret_cast<const uint32_t*>(dots + g * kTcPitch + qb + 2 * t);
      const uint32_t bqt =
          *reinterpret_cast<const uint32_t*>(qts + g * kTcPitch + qb + 2 * t);
      mma_16x8x8(dva, pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]), bdt);
      mma_16x8x8(dka, pack_bf16(ds[0], ds[1]), pack_bf16(ds[2], ds[3]), bqt);
    }
  }

  if (ja < S) {
    const size_t at = base + (size_t)ja * D + 2 * t;
    *reinterpret_cast<uint32_t*>(dk + at) =
        pack_bf16(dka[0] * scale, dka[1] * scale);
    *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(dva[0], dva[1]);
  }
  if (jb < S) {
    const size_t at = base + (size_t)jb * D + 2 * t;
    *reinterpret_cast<uint32_t*>(dk + at) =
        pack_bf16(dka[2] * scale, dka[3] * scale);
    *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(dva[2], dva[3]);
  }
}

// ---- bf16 at dh 16-256: mma.sync m16n8k16 ---------------------------------

using bf16 = __nv_bfloat16;

template <int DH>
struct MmaLayout {
  // bf16 pitch: 8 rows of an ldmatrix land in distinct 16-byte bank groups
  static constexpr int LD = DH + 8;
  // past dh 64 a block writes half the head dim of the gradients (grid z):
  // a warp's two float32 accumulators of 16 x dh would not fit beside the
  // score tiles, and recomputing a half's scores costs two products of
  // dh, against four of dh / 2 that the split saves in registers
  static constexpr int kSplit = DH >= 128 ? 2 : 1;
  static constexpr int DHP = DH / kSplit;
  // keys (pass 1) or queries (pass 2) per streamed tile
  static constexpr int kTile = DH >= 192 ? 32 : 64;
  // tiles in flight: all of S <= 256 up to dh 64, two past it
  static constexpr int kStages = DH <= 64 ? 4 : 2;
  // up to dh 64 the fixed rows' A fragments stay in registers
  static constexpr bool kRegs = DH <= 64;
  // 64 fixed rows of two tensors, kStages tiles of two, and (pass 2) the
  // streamed queries' log2-sum-exp and delta
  static constexpr size_t bytes =
      (size_t)(2 * 64 + 2 * kStages * kTile) * LD * 2 + kStages * kTile * 8;
};

// rows [r0, r0 + ROWS) of one head of an (N, S, H*DH) bf16 tensor into dst
// (pitch LD) by 16-byte cp.async; rows at or past S are zeroed
template <int ROWS, int DH, int LD>
__device__ __forceinline__ void load_rows(bf16* dst,
                                          const bf16* __restrict__ src,
                                          size_t base, int D, int r0, int S) {
  constexpr int kChunks = DH / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += 128) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool live = r0 + r < S;
    qaig::cp_async16(dst + r * LD + c,
                     src + base + (size_t)(live ? r0 + r : 0) * D + c, live);
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   qaig::smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

// A fragments (16 x 16 at depth 16s) of rows 16w.. of a tile with pitch LD
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* x, int w,
                                       int s) {
  const int lane = threadIdx.x & 31;
  qaig::ldmatrix_x4(a, x + (w * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                           s * 16 + (lane >> 4) * 8);
}

// d[2p], d[2p+1] += a . (rows 16p..16p+15 of x at depth 16s)^T: the B
// fragments of a row-major tile whose rows are the product's columns
template <int LD>
__device__ __forceinline__ void mma_rows(float (&d0)[4], float (&d1)[4],
                                         const uint32_t (&a)[4], const bf16* x,
                                         int p, int s) {
  const int lane = threadIdx.x & 31;
  uint32_t b[4];
  qaig::ldmatrix_x4(b, x + (16 * p + (lane >> 4) * 8 + (lane & 7)) * LD +
                           s * 16 + ((lane >> 3) & 1) * 8);
  qaig::mma_16x8x16(d0, a, b[0], b[1]);
  qaig::mma_16x8x16(d1, a, b[2], b[3]);
}

// d[2c], d[2c+1] += a . x[16s..16s+15, col..col+15]: the B fragments of a
// row-major tile whose rows are the product's depth (ldmatrix.trans)
template <int LD>
__device__ __forceinline__ void mma_cols(float (&d0)[4], float (&d1)[4],
                                         const uint32_t (&a)[4], const bf16* x,
                                         int s, int col) {
  const int lane = threadIdx.x & 31;
  uint32_t b[4];
  qaig::ldmatrix_x4_trans(
      b, x + (16 * s + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + col +
             (lane >> 4) * 8);
  qaig::mma_16x8x16(d0, a, b[0], b[1]);
  qaig::mma_16x8x16(d1, a, b[2], b[3]);
}

// Write a warp's 16 x DHP float32 accumulator, times f[row half], as bf16
// through its own 16 rows of a shared tile (pitch LD) to rows r0w.. and
// columns c0.. of one head of an (N, S, H*DH) tensor.
template <int DH, int DHP, int LD>
__device__ __forceinline__ void store_rows(bf16* stage,
                                           const float (&acc)[DHP / 8][4],
                                           const float (&f)[2], bf16* dst,
                                           size_t base, int D, int r0w,
                                           int c0, int S) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int d = 0; d < DHP / 8; ++d) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + 8 * d + 2 * t) =
        pack_bf16(acc[d][0] * f[0], acc[d][1] * f[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + 8 * d + 2 * t) =
        pack_bf16(acc[d][2] * f[1], acc[d][3] * f[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * (DHP / 8); i += 32) {
    const int r = i / (DHP / 8), c = (i % (DHP / 8)) * 8;
    if (r0w + r < S)
      *reinterpret_cast<uint4*>(dst + base + (size_t)(r0w + r) * D + c0 + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

// Pass 1: dq (columns c0.. of block z), and the rows' log2-sum-exp and
// delta.  4 warps of 16 query rows; K/V tiles stream through a cp.async
// ring; the longest causal rows start first.
template <int DH>
__global__ void __launch_bounds__(128) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ out,
    const bf16* __restrict__ dout, bf16* __restrict__ dq,
    float* __restrict__ lse2, float* __restrict__ delta, int S, int H,
    int causal, float scale, float scale_log2) {
  using L = MmaLayout<DH>;
  constexpr int LD = L::LD, kBK = L::kTile, kStages = L::kStages;
  constexpr int NB = kBK / 8;      // 8-key column tiles of a score tile
  constexpr int kSteps = DH / 16;  // depth steps of the score products
  constexpr int kDt = L::DHP / 8;  // 8-wide column tiles of dq
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // later the dq tile
  bf16* dos = qs + 64 * LD;
  bf16* ks = dos + 64 * LD;                      // kStages K tiles
  bf16* vs = ks + kStages * kBK * LD;            // kStages V tiles

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const int r0w = q0 + w * 16;  // this warp's first row
  const int c0 = blockIdx.z * L::DHP;
  const int D = H * DH;
  const size_t base = (size_t)(bh / H) * S * D + (size_t)(bh % H) * DH;
  const int kend = causal ? min(S, q0 + 64) : S;
  const int ntiles = (kend + kBK - 1) / kBK;

  auto load_kv = [&](int j) {
    if (j < ntiles) {
      const int slot = (j % kStages) * kBK * LD;
      load_rows<kBK, DH, LD>(ks + slot, k, base, D, j * kBK, S);
      load_rows<kBK, DH, LD>(vs + slot, v, base, D, j * kBK, S);
    }
    qaig::cp_async_commit();
  };
  load_rows<64, DH, LD>(qs, q, base, D, q0, S);
  load_rows<64, DH, LD>(dos, dout, base, D, q0, S);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_kv(j);

  uint32_t qa[L::kRegs ? kSteps : 1][4], da[L::kRegs ? kSteps : 1][4];
  float acc[kDt][4];
#pragma unroll
  for (int d = 0; d < kDt; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  // running max of the scaled base-2 scores, this lane's share of the sum,
  // and delta, for rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2];

  for (int j = 0; j < ntiles; ++j) {
    load_kv(j + kStages - 1);  // into the slot that tile j - 1 freed
    qaig::cp_async_wait<kStages - 1>();
    __syncthreads();
    if (j == 0) {
      if constexpr (L::kRegs) {
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          frag_a<LD>(qa[s], qs, w, s);
          frag_a<LD>(da[s], dos, w, s);
        }
      }
      // delta = rowsum(dout * out): two lanes a row, half the head dim each
      const int rr = lane >> 1, row = r0w + rr;
      float sum = 0.f;
      if (row < S) {
#pragma unroll
        for (int c = (lane & 1) * (DH / 2); c < (lane & 1) * (DH / 2) + DH / 2;
             c += 8) {
          const uint4 o = *reinterpret_cast<const uint4*>(
              out + base + (size_t)row * D + c);
          const uint4 d = *reinterpret_cast<const uint4*>(
              dos + (w * 16 + rr) * LD + c);
          const uint32_t* ou = reinterpret_cast<const uint32_t*>(&o);
          const uint32_t* du = reinterpret_cast<const uint32_t*>(&d);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fo = unpack_bf16(ou[e]), fd = unpack_bf16(du[e]);
            sum = fmaf(fd.x, fo.x, sum);
            sum = fmaf(fd.y, fo.y, sum);
          }
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      dl[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
      dl[1] = __shfl_sync(0xffffffffu, sum, 2 * g + 16);
    }
    const int k0 = j * kBK;
    const bf16* kt = ks + (j % kStages) * kBK * LD;
    const bf16* vt = vs + (j % kStages) * kBK * LD;

    // 8-key column tiles [0, jlive) hold a live key for some row of this
    // warp; the rest are skipped (and masked)
    int jlive = min(NB, (S - k0 + 7) / 8);
    if (causal) jlive = r0w + 15 < k0 ? 0 : min(jlive, (r0w + 15 - k0) / 8 + 1);
    if (r0w >= S) jlive = 0;
    const bool need_mask = k0 + kBK > S || (causal && k0 + kBK - 1 > r0w);

    // scores S = Q K^T and dP = dO V^T for 16 rows x kBK keys
    float sc[NB][4], dp[NB][4];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[c][e] = dp[c][e] = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t aq[4], ad[4];
      if constexpr (L::kRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          aq[e] = qa[s][e];
          ad[e] = da[s][e];
        }
      } else {
        frag_a<LD>(aq, qs, w, s);
        frag_a<LD>(ad, dos, w, s);
      }
#pragma unroll
      for (int p = 0; p < NB / 2; ++p) {
        if (2 * p >= jlive) break;
        mma_rows<LD>(sc[2 * p], sc[2 * p + 1], aq, kt, p, s);
        mma_rows<LD>(dp[2 * p], dp[2 * p + 1], ad, vt, p, s);
      }
    }

    // online softmax of rows g and g + 8 (elements 0-1 and 2-3), as in the
    // forward; dS = P (dP - delta), rounded to bf16 as the A fragments of
    // dQ += dS K
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < NB; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (need_mask) {
          const int key = k0 + 8 * c + 2 * t + (e & 1);
          const int row = r0w + g + (e >> 1) * 8;
          if (key >= S || (causal && key > row)) sc[c][e] = -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[c][e]);
      }
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      // a row with no live key so far keeps p = 0
      mu[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = fast_exp2(m[r] - mu[r]);
      m[r] = m_new;
    }
    uint32_t dsa[NB / 2][4];
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = fast_exp2(fmaf(sc[c][e], scale_log2, -mu[e >> 1]));
      ls[0] += p[0] + p[1];
      ls[1] += p[2] + p[3];
      dsa[c >> 1][(c & 1) * 2] =
          pack_bf16(p[0] * (dp[c][0] - dl[0]), p[1] * (dp[c][1] - dl[0]));
      dsa[c >> 1][(c & 1) * 2 + 1] =
          pack_bf16(p[2] * (dp[c][2] - dl[1]), p[3] * (dp[c][3] - dl[1]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
    for (int d = 0; d < kDt; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }
#pragma unroll
    for (int s = 0; s < NB / 2; ++s) {
      if (2 * s >= jlive) break;
#pragma unroll
      for (int d = 0; d < kDt / 2; ++d)
        mma_cols<LD>(acc[2 * d], acc[2 * d + 1], dsa[s], kt, s, c0 + 16 * d);
    }
    __syncthreads();  // this slot's reads are done before it is refilled
  }

  // every live row keeps key 0, so l > 0
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    f[r] = scale / l[r];
  }
  // the warp's own 16 rows of qs (only it reads them) stage dq
  store_rows<DH, L::DHP, LD>(qs + w * 16 * LD, acc, f, dq, base, D, r0w, c0,
                             S);
  if (blockIdx.z == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0w + g + 8 * r;
      if (row < S) {
        lse2[(size_t)bh * S + row] = m[r] + log2f(l[r]);
        delta[(size_t)bh * S + row] = dl[r];
      }
    }
  }
}

// Pass 2: dk and dv (columns c0.. of block z).  4 warps of 16 keys; Q/dO
// tiles with their log2-sum-exp and delta stream through a cp.async ring
// (causal: from the block's first key on).
template <int DH>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int causal,
    float scale, float scale_log2) {
  using L = MmaLayout<DH>;
  constexpr int LD = L::LD, kBQ = L::kTile, kStages = L::kStages;
  constexpr int NB = kBQ / 8;      // 8-query column tiles of a score tile
  constexpr int kSteps = DH / 16;
  constexpr int kDt = L::DHP / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // later the dk tile
  bf16* vs = ks + 64 * LD;                       // later the dv tile
  bf16* qs = vs + 64 * LD;                       // kStages Q tiles
  bf16* dos = qs + kStages * kBQ * LD;           // kStages dO tiles
  float* lse_s = reinterpret_cast<float*>(dos + kStages * kBQ * LD);
  float* del_s = lse_s + kStages * kBQ;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * 64;
  const int j0w = j0 + w * 16;  // this warp's first key
  const int c0 = blockIdx.z * L::DHP;
  const int D = H * DH;
  const size_t base = (size_t)(bh / H) * S * D + (size_t)(bh % H) * DH;
  const int it0 = causal ? j0 / kBQ : 0;  // the first query tile
  const int ntiles = (S + kBQ - 1) / kBQ - it0;
  const float* lse_bh = lse2 + (size_t)bh * S;
  const float* del_bh = delta + (size_t)bh * S;

  auto load_q = [&](int j) {
    if (j < ntiles) {
      const int slot = j % kStages, i0 = (it0 + j) * kBQ;
      load_rows<kBQ, DH, LD>(qs + slot * kBQ * LD, q, base, D, i0, S);
      load_rows<kBQ, DH, LD>(dos + slot * kBQ * LD, dout, base, D, i0, S);
      for (int i = threadIdx.x; i < kBQ; i += 128) {
        const bool live = i0 + i < S;
        cp_async4(lse_s + slot * kBQ + i, lse_bh + (live ? i0 + i : 0), live);
        cp_async4(del_s + slot * kBQ + i, del_bh + (live ? i0 + i : 0), live);
      }
    }
    qaig::cp_async_commit();
  };
  load_rows<64, DH, LD>(ks, k, base, D, j0, S);
  load_rows<64, DH, LD>(vs, v, base, D, j0, S);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_q(j);

  uint32_t ka[L::kRegs ? kSteps : 1][4], va[L::kRegs ? kSteps : 1][4];
  float dka[kDt][4], dva[kDt][4];
#pragma unroll
  for (int d = 0; d < kDt; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    load_q(j + kStages - 1);
    qaig::cp_async_wait<kStages - 1>();
    __syncthreads();
    if constexpr (L::kRegs) {
      if (j == 0) {
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          frag_a<LD>(ka[s], ks, w, s);
          frag_a<LD>(va[s], vs, w, s);
        }
      }
    }
    const int slot = j % kStages, i0 = (it0 + j) * kBQ;
    const bf16* qt = qs + slot * kBQ * LD;
    const bf16* dot = dos + slot * kBQ * LD;

    // 8-query column tiles [clo, chi) hold a live query for some key of
    // this warp: causal ones before the warp's first key and ones past S
    // are skipped (and masked)
    const int clo = causal && j0w > i0 ? min(NB, (j0w - i0) / 8) : 0;
    int chi = min(NB, (S - i0 + 7) / 8);
    if (j0w >= S) chi = 0;
    const bool need_mask = i0 + kBQ > S || (causal && i0 < j0w + 15);

    // S^T = K Q^T and dP^T = V dO^T for 16 keys x kBQ queries
    float st[NB][4], dpt[NB][4];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[c][e] = dpt[c][e] = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t ak[4], av[4];
      if constexpr (L::kRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ak[e] = ka[s][e];
          av[e] = va[s][e];
        }
      } else {
        frag_a<LD>(ak, ks, w, s);
        frag_a<LD>(av, vs, w, s);
      }
#pragma unroll
      for (int p = 0; p < NB / 2; ++p) {
        if (2 * p + 1 < clo || 2 * p >= chi) continue;
        mma_rows<LD>(st[2 * p], st[2 * p + 1], ak, qt, p, s);
        mma_rows<LD>(dpt[2 * p], dpt[2 * p + 1], av, dot, p, s);
      }
    }

    // P^T = exp2(s scale_log2 - lse2[query]) and dS^T = P^T (dP^T -
    // delta[query]), rounded to bf16 as the A fragments of dV += P^T dO and
    // dK += dS^T Q
    uint32_t pa[NB / 2][4], dsa[NB / 2][4];
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const float2 ls = *reinterpret_cast<const float2*>(
          lse_s + slot * kBQ + 8 * c + 2 * t);
      const float2 ds2 = *reinterpret_cast<const float2*>(
          del_s + slot * kBQ + 8 * c + 2 * t);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int query = i0 + 8 * c + 2 * t + (e & 1);
        const int key = j0w + g + 8 * (e >> 1);
        const bool live =
            !need_mask || (query < S && (!causal || query >= key));
        const float lq = (e & 1) ? ls.y : ls.x, dq_ = (e & 1) ? ds2.y : ds2.x;
        p[e] = live ? fast_exp2(fmaf(st[c][e], scale_log2, -lq)) : 0.f;
        ds[e] = p[e] * (dpt[c][e] - dq_);
      }
      pa[c >> 1][(c & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[c >> 1][(c & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[c >> 1][(c & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[c >> 1][(c & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int s = 0; s < NB / 2; ++s) {
      if (2 * s + 1 < clo || 2 * s >= chi) continue;
#pragma unroll
      for (int d = 0; d < kDt / 2; ++d) {
        mma_cols<LD>(dva[2 * d], dva[2 * d + 1], pa[s], dot, s, c0 + 16 * d);
        mma_cols<LD>(dka[2 * d], dka[2 * d + 1], dsa[s], qt, s, c0 + 16 * d);
      }
    }
    __syncthreads();  // this slot's reads are done before it is refilled
  }

  // the warp's own 16 rows of ks / vs (only it reads them) stage dk / dv
  const float fk[2] = {scale, scale}, fv[2] = {1.f, 1.f};
  store_rows<DH, L::DHP, LD>(ks + w * 16 * LD, dka, fk, dk, base, D, j0w, c0,
                             S);
  store_rows<DH, L::DHP, LD>(vs + w * 16 * LD, dva, fv, dv, base, D, j0w, c0,
                             S);
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, void* dq, void* dk,
                       void* dv, float* lse2, float* delta, int N, int S,
                       int H, int causal, cudaStream_t stream) {
  using L = MmaLayout<DH>;
  auto pass1 = flash_bwd_dq_mma_kernel<DH>;
  auto pass2 = flash_bwd_dkdv_mma_kernel<DH>;
  static bool attributes_set[qaig::kMaxDevices] = {};  // per head dim
  if (L::bytes > 48 * 1024) {
    const cudaError_t set = qaig::once_per_device(attributes_set, [&] {
      cudaError_t e = cudaFuncSetAttribute(
          pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            pass2, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)L::bytes);
      return e;
    });
    if (set != cudaSuccess) return set;
  }
  // (n, h) on x, 64-row tiles on y, head-dim halves on z
  const dim3 grid(N * H, (S + 63) / 64, L::kSplit);
  const float scale = 1.0f / sqrtf((float)DH);
  const float scale_log2 = scale * kLog2e;
  pass1<<<grid, 128, L::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), lse2, delta, S,
      H, causal, scale, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pass2<<<grid, 128, L::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse2,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, causal,
      scale, scale_log2);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* out, const void* dout, void* dq, void* dk,
                      void* dv, float* lse2, float* delta, int N, int S,
                      int H, int causal, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  // (n, h) on x, 8 groups of 16 rows a block on y
  const dim3 grid(N * H, (S + 127) / 128);
  const float scale = 1.0f / sqrtf(8.f);
  const float scale_log2 = scale * kLog2e;
  flash_bwd_dq_tc_kernel<<<grid, 256, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), lse2, delta, S,
      H, causal, scale, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_tc_kernel<<<grid, 256, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse2,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, causal,
      scale, scale_log2);
  return cudaGetLastError();
}

// The geometry the wrapper's plan (flash_attention.backward_launch_plan)
// names; a launch whose plan is not the one built is refused.
struct Plan {
  int rows, tile, split, stages, cluster;
};

// float32 at dh 8 and 16: the row form
template <int DH>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, void* dq, void* dk,
                        void* dv, float* lse2, float* delta, int N, int S,
                        int H, int causal, cudaStream_t stream) {
  constexpr int kRows = kRowThreads / (DH / kRowLane);
  const dim3 grid(N * H, (S + kRows - 1) / kRows);
  const float scale = 1.0f / sqrtf((float)DH);
  const float scale_log2 = scale * kLog2e;
  flash_bwd_dq_rows_kernel<DH><<<grid, kRowThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<float*>(dq), lse2, delta,
      S, H, causal, scale, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_rows_kernel<DH><<<grid, kRowThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse2,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), S, H, causal,
      scale, scale_log2);
  return cudaGetLastError();
}

// a launch in clusters of `cluster` CTAs along grid x
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid,
                            size_t smem, int cluster, cudaStream_t stream,
                            Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kF32Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// float32 at dh 32-256: the register-blocked tiles
template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, void* dq, void* dk,
                       void* dv, float* lse2, float* delta, int N, int S,
                       int H, int causal, Plan plan, cudaStream_t stream) {
  using L = F32Layout<DH>;
  auto pass1 = flash_bwd_dq_f32_kernel<DH>;
  auto pass2 = flash_bwd_dkdv_f32_kernel<DH>;
  constexpr size_t bytes1 = L::bytes1, bytes2 = L::bytes2;
  static bool attributes_set[qaig::kMaxDevices] = {};  // per head dim
  const cudaError_t set = qaig::once_per_device(attributes_set, [&] {
    cudaError_t e = cudaSuccess;
    if (bytes1 > 48 * 1024)
      e = cudaFuncSetAttribute(
          pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes1);
    if (e == cudaSuccess && bytes2 > 48 * 1024)
      e = cudaFuncSetAttribute(
          pass2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes2);
    return e;
  });
  if (set != cudaSuccess) return set;
  const float scale = 1.0f / sqrtf((float)DH);
  const float scale_log2 = scale * kLog2e;
  // (n, h) x cluster rank on x, 64-row tiles on y
  const unsigned tiles = (S + kF32Rows - 1) / kF32Rows;
  const cudaError_t err = launch_clusters(
      pass1, dim3(N * H * plan.cluster, tiles), bytes1, plan.cluster,
      stream, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<float*>(dq), lse2, delta,
      S, H, causal, scale, scale_log2);
  if (err != cudaSuccess) return err;
  return launch_clusters(
      pass2, dim3(N * H * plan.cluster, tiles), bytes2,
      plan.cluster, stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse2),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, causal, scale, scale_log2);
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, void* dq, void* dk,
                   void* dv, float* lse2, float* delta, int N, int S, int H,
                   int causal, Plan plan, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && DH == 8) {
    if (plan.rows != 128 || plan.tile != kTcTile || plan.split != 1 ||
        plan.stages != 1 || plan.cluster != 1)
      return cudaErrorInvalidValue;
    return launch_tc(q, k, v, out, dout, dq, dk, dv, lse2, delta, N, S, H,
                     causal, stream);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using L = MmaLayout<DH>;
    if (plan.rows != 64 || plan.tile != L::kTile || plan.split != L::kSplit ||
        plan.stages != L::kStages || plan.cluster != 1)
      return cudaErrorInvalidValue;
    return launch_mma<DH>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N, S,
                          H, causal, stream);
  } else if constexpr (DH <= 16) {
    if (plan.rows != kRowThreads / (DH / kRowLane) ||
        plan.tile != kRowTile || plan.split != 1 || plan.stages != 1 ||
        plan.cluster != 1)
      return cudaErrorInvalidValue;
    return launch_rows<DH>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N, S,
                           H, causal, stream);
  } else {
    using L = F32Layout<DH>;
    // clusters of 1 or 2: 4 ran slower than 2 at every head dim timed
    if (plan.rows != kF32Rows || plan.tile != L::kTile || plan.split != 1 ||
        plan.stages != L::kStages || plan.cluster < 1 || plan.cluster > 2)
      return cudaErrorInvalidValue;
    return launch_f32<DH>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N, S,
                          H, causal, plan, stream);
  }
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, void* dq, void* dk,
                        void* dv, float* lse2, float* delta, int N, int S,
                        int H, int dh, int causal, Plan plan,
                        cudaStream_t stream) {
  switch (dh) {
    case 8:
      return launch<T, 8>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N, S,
                          H, causal, plan, stream);
    case 16:
      return launch<T, 16>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N, S,
                           H, causal, plan, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N, S,
                           H, causal, plan, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N, S,
                           H, causal, plan, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N,
                            S, H, causal, plan, stream);
    case 192:
      return launch<T, 192>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N,
                            S, H, causal, plan, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N,
                            S, H, causal, plan, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, out, dout, dq, dk, dv: (N, S, H*dh), contiguous, 16-byte
// aligned.  lse2, delta: float32 (N, H, S) scratch.  dtype: 0 = float32,
// 1 = bfloat16.  dh in {8, 16, 32, 64, 128, 192, 256}.  N * H runs on grid
// x (up to 2^31 - 1, times the cluster size), the row tiles on grid y.
// rows, tile, split, stages, cluster: the wrapper's
// launch plan, which must be a geometry built for this dtype and head dim.
// Launches pass 1 then pass 2 on `stream`; returns the cudaError_t of the
// launches.
int qaig_flash_attention_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* dout, void* dq,
                             void* dk, void* dv, void* lse2, void* delta,
                             int N, int S, int H, int dh, int causal,
                             int dtype, int rows, int tile, int split,
                             int stages, int cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse2);
  float* d = static_cast<float*>(delta);
  const Plan plan{rows, tile, split, stages, cluster};
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, out, dout, dq, dk, dv, l, d, N, S, H,
                              dh, causal, plan, st);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, out, dout, dq, dk, dv, l, d,
                                      N, S, H, dh, causal, plan, st);
  return (int)cudaErrorInvalidValue;
}

const char* qaig_flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
