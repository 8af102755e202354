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
// at the training path's dh 8 that is ~S / 2 operations per byte, so the
// bytes bound it on paper (5 us at N 8, H 64, S 256 in bf16).  In practice
// the instructions per pair bound it: with float32 FMAs one key read from
// shared memory serves 32 pairs of a warp, and every product is only dh
// deep.
//
// What the design does about it.  FlashAttention-2's split into two
// launches, so no (S, S) tensor reaches device memory and nothing needs an
// atomic (deterministic):
//   pass 1, over query tiles: a block owns up to 128 query rows of one
//     (n, h), each row's dh in registers across dh / 8 lanes (8 elements a
//     lane; past dh 128, 32 lanes of dh / 32).  K and V stream through shared memory as float32 tiles; per
//     key one sweep recomputes s, keeps the row's running max and sum
//     (online softmax, base 2) and accumulates dq, rescaling it when the
//     max moves.  It writes dq, and the row's log2-sum-exp and delta as
//     float32 (N, H, S) scratch;
//   pass 2, over key tiles: a block owns up to 128 keys of one (n, h),
//     held the same way with their dk and dv accumulators; Q, dout, lse
//     and delta stream through shared memory (causal: only the queries at
//     or after the block's first key) and each (query, key) pair's p and
//     ds are recomputed.
// In this form every product is a float32 FMA, for float32 inputs and for
// bf16 at dh >= 16 (no TF32, no tensor cores): the error against the plain
// version is the summation order and, in bf16, the final rounding.  A warp's loop over a
// tile stops at its own last live pair, so causal warps skip the masked
// half; keys and queries are read from shared memory as broadcasts.  Head
// dims 8, 16, 32, 64, 128, 192 and 256, as the forward.
//
// bf16 at dh 8 (the training path's 64 heads of 8) takes a tensor-core
// form of the same two passes, ~3x faster at the training shape:
// mma.sync m16n8k8 (bf16 in, float32 accumulate) computes a warp's 16 x 8 tile of scores and of dout v^T at
// once, exactly (a bf16 x bf16 product is exact in float32), and the three
// products that take p or ds (dv, dq, dk) round that float32 operand to
// bf16 (relative error 2^-9), reusing the score tile's accumulator layout
// as the next product's A operand.  A warp owns 16 rows; a block of 8
// warps takes row groups 4b..4b+3 from the front of the sequence and
// their mirror images from the back, so causal blocks carry equal work
// and each scheduler pairs a short group with a long one.

#include "common.cuh"

#include <type_traits>

namespace {

using qaig::fast_exp2;
using qaig::mma_16x8x8;
using qaig::pack_bf16;
using qaig::unpack_bf16;

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// head-dim elements a lane holds: 8 (one 16-byte bf16 load) up to dh 128,
// then dh / 32 so that a row's lanes stay within one warp
template <int DH>
__host__ __device__ constexpr int lane_dims() {
  return DH <= 128 ? 8 : DH / 32;
}

// keys (pass 1) or queries (pass 2) per shared-memory tile: two float32
// tiles of at most 16 KB each
template <int DH>
__host__ __device__ constexpr int tile_rows() {
  return 4096 / DH < 128 ? 4096 / DH : 128;
}

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
__device__ __forceinline__ void load_e(const __nv_bfloat16* p, float (&x)[E]) {
  if constexpr (E % 8 == 0) {
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        x[8 * i + 2 * j] = f.x;
        x[8 * i + 2 * j + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const float2 f = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(p)[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
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
__device__ __forceinline__ void store_e(__nv_bfloat16* p,
                                        const float (&x)[E]) {
  if constexpr (E % 8 == 0) {
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = __floats2bfloat162_rn(x[8 * i + 2 * j], x[8 * i + 2 * j + 1]);
      reinterpret_cast<uint4*>(p)[i] = u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E / 2; ++i)
      reinterpret_cast<__nv_bfloat162*>(p)[i] =
          __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  }
}

template <typename T, int E>
__device__ __forceinline__ void load_e_or_zero(const T* p, bool live,
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
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      size_t base, int D, int r0, int rows) {
  constexpr int E = lane_dims<DH>();
  constexpr int G = DH / E;
  for (int i = threadIdx.x; i < rows * G; i += kThreads) {
    const int r = i / G, c = (i % G) * E;
    float x[E];
    load_e(src + base + (size_t)(r0 + r) * D + c, x);
    store_e(dst + r * DH + c, x);
  }
}

// Pass 1: dq, and the rows' log2-sum-exp and delta.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const T* __restrict__ dout,
    T* __restrict__ dq, float* __restrict__ lse2, float* __restrict__ delta,
    int S, int H, int causal, float scale, float scale_log2) {
  constexpr int E = lane_dims<DH>();
  constexpr int G = DH / E;  // lanes per query row
  constexpr int kRows = kThreads / G;
  constexpr int kTile = tile_rows<DH>();
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
    stage<T, DH>(ks, k, base, D, k0, nk);
    stage<T, DH>(vs, v, base, D, k0, nk);
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
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse2,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, int H, int causal, float scale, float scale_log2) {
  constexpr int E = lane_dims<DH>();
  constexpr int G = DH / E;  // lanes per key row
  constexpr int kRows = kThreads / G;
  constexpr int kTile = tile_rows<DH>();
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
    stage<T, DH>(qs, q, base, D, i0, nq);
    stage<T, DH>(dos, dout, base, D, i0, nq);
    for (int i = tid; i < nq; i += kThreads)
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

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, void* dq, void* dk,
                   void* dv, float* lse2, float* delta, int N, int S, int H,
                   int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && DH == 8) {
    return launch_tc(q, k, v, out, dout, dq, dk, dv, lse2, delta, N, S, H,
                     causal, stream);
  } else {
    constexpr int kRows = kThreads / (DH / lane_dims<DH>());
    const dim3 grid(N * H, (S + kRows - 1) / kRows);
    const float scale = 1.0f / sqrtf((float)DH);
    const float scale_log2 = scale * kLog2e;
    flash_bwd_dq_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(out),
        static_cast<const T*>(dout), static_cast<T*>(dq), lse2, delta, S, H,
        causal, scale, scale_log2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse2, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), S, H, causal, scale,
        scale_log2);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, void* dq, void* dk,
                        void* dv, float* lse2, float* delta, int N, int S,
                        int H, int dh, int causal, cudaStream_t stream) {
  switch (dh) {
    case 8:
      return launch<T, 8>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N, S,
                          H, causal, stream);
    case 16:
      return launch<T, 16>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N, S,
                           H, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N, S,
                           H, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N, S,
                           H, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N,
                            S, H, causal, stream);
    case 192:
      return launch<T, 192>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N,
                            S, H, causal, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, dout, dq, dk, dv, lse2, delta, N,
                            S, H, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, out, dout, dq, dk, dv: (N, S, H*dh), contiguous, 16-byte
// aligned.  lse2, delta: float32 (N, H, S) scratch.  dtype: 0 = float32,
// 1 = bfloat16.  dh in {8, 16, 32, 64, 128, 192, 256}.  N * H runs on grid
// x (up to 2^31 - 1), the row tiles on grid y (S up to 65535 * 4 at dh 192
// and 256).
// Launches pass 1 then pass 2 on `stream`; returns the cudaError_t of the
// launches.
int qaig_flash_attention_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* dout, void* dq,
                             void* dk, void* dv, void* lse2, void* delta,
                             int N, int S, int H, int dh, int causal,
                             int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse2);
  float* d = static_cast<float*>(delta);
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, out, dout, dq, dk, dv, l, d, N, S, H,
                              dh, causal, st);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, out, dout, dq, dk, dv, l, d,
                                      N, S, H, dh, causal, st);
  return (int)cudaErrorInvalidValue;
}

const char* qaig_flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
