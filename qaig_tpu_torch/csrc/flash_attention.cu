// Full-sequence self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel of qaig_tpu/ops/flash_attention.py:
// flash_attention -> _flash_fwd_core -> _attn_kernel, which holds a whole
// (S, S) score matrix of one (batch, head) in VMEM.
//
// Function.  q, k, v, out are (N, S, H*dh) with the heads side by side in
// the feature axis (the layout the projections produce); for each (n, h)
// out = softmax(q k^T / sqrt(dh), masked causally when asked) v, with the
// softmax in float32.  The kernels read and write that layout directly, so
// no head transpose and no padding of S is needed: ragged S and the causal
// mask are handled in the kernels.  Head dims 8, 16, 32, 64, 128, 192 and
// 256: every multiple of 64 the TPU kernel takes up to 256 (past it a
// warp's 16 rows of O would not fit in its registers), and the powers of
// two below 64.
//
// What bounds it on the H100.  It does 4 * N * H * S_eff * dh flops (S_eff
// the live (query, key) pairs: S^2, or S(S+1)/2 causal) on 4 * N * S * H*dh
// elements moved, i.e. about S / 2 operations per byte in bf16: at the
// paths' S <= 256 that is under the ~295 of the tensor-core roofline, so
// the bound is the bytes.  In float32 (no tensor cores, no TF32: 67 TFLOP/s)
// the operations bound it.  At these sizes a block's work is short, so the
// latency of its chain of loads and products sets the time as much as
// either bound.
//
// What the design does about it.  A block owns 64 query rows of one (n, h)
// and streams K/V through shared memory in 64-key tiles with an online
// softmax (base 2, scale * log2(e) folded into the exponent), so no score
// row reaches device memory and each K/V element is read once per query
// tile.  The tiles go through a ring of shared-memory slots filled by
// 16-byte cp.async copies (zero-filled past S): four slots up to dh 128 in
// bf16, so at S <= 256 every tile is in flight before the first is used (a
// tile's products take less than a load's latency), and two for float32 at
// dh 32-128, where a tile's FMAs outlast the next load; fewer past dh 128,
// where more would not fit.  Causal blocks stop at their diagonal tile,
// only tiles that cross the diagonal or the end of the sequence are
// masked, and the blocks of the last query tiles (the longest rows) start
// first.  (n, h) runs on grid x, so N * H may exceed 65535; the query tiles
// on grid y (S up to 65535 * 64).
//   bf16: FlashAttention-2 on mma.sync.  4 warps, each owning 16 query rows
//     whose Q fragments are loaded once (ldmatrix; re-read per tile past dh
//     128).  S = Q K^T runs as m16n8k16 (m16n8k8 at dh 8: no padding) with
//     K's B fragments from ldmatrix and float32 accumulators in registers;
//     a lane holds two rows, whose max and sum take two quad shuffles.  The
//     score accumulators, rounded to bf16 pairs, are the A fragments of O
//     += P V (V's B fragments from ldmatrix.trans), so P never touches
//     shared memory and O stays in registers, rescaled per row.  The
//     denominator sums the bf16-rounded probabilities that the PV product
//     uses.  In the diagonal tile a warp skips the key columns past its
//     last row.
//   float32: exact FMAs, register-blocked.  256 threads as 16 x 16: a thread
//     owns 4 rows x 4 keys (keys tx + 16c, conflict-free float4 rows of K)
//     of the score tile, the row statistics of its rows (16-lane shuffles),
//     and a 4 x dh/16 tile of O (dh >= 32, probabilities through a per-row
//     strip of shared memory read as float4 by the same 16 lanes) or, at dh
//     <= 16, a 4 x dh partial O over its own 4 keys (probabilities stay in
//     registers; the 16 partials are summed by a halving exchange of
//     shuffles at the end).
// wgmma and TMA are later work.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using qaig::cp_async16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile

// Copy rows [r0, r0 + 64) of one head of an (N, S, H*DH) tensor into dst
// (pitch LD elements) with 16-byte cp.async; rows at or past S are zeroed.
template <typename T, int DH, int LD, int kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          size_t base, int D, int r0, int S) {
  constexpr int kChunks = DH * sizeof(T) / 16;
  constexpr int kPer = 16 / sizeof(T);
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const bool live = r0 + r < S;
    cp_async16(dst + r * LD + c,
               src + base + (size_t)(live ? r0 + r : 0) * D + c, live);
  }
}

// ---- bf16: mma.sync -------------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps of 16 query rows

template <int DH>
struct TcLayout {
  // bf16 pitch: 8 rows of an ldmatrix land in distinct 16-byte bank groups
  static constexpr int LD = DH == 8 ? 8 : DH + 8;
  // K/V tile slots: all of S <= 256 in flight at once up to dh 128; two
  // past it, where four would not fit in shared memory
  static constexpr int kStages = DH <= 128 ? 4 : 2;
  // up to dh 128 a warp's Q fragments stay in registers for the whole
  // block; past it O alone takes dh / 2 registers a lane, so each tile
  // re-reads Q from shared memory
  static constexpr bool kQInRegs = DH <= 128;
  static constexpr size_t bytes =
      (size_t)(kBQ + 2 * kStages * kBK) * LD * 2;
};

template <int DH>
__global__ void __launch_bounds__(kTcThreads)
    flash_attention_fwd_tc_kernel(const bf16* __restrict__ q,
                                  const bf16* __restrict__ k,
                                  const bf16* __restrict__ v,
                                  bf16* __restrict__ out, int S, int H,
                                  int causal, float scale_log2) {
  using L = TcLayout<DH>;
  constexpr int LD = L::LD;
  constexpr int kStages = L::kStages;
  constexpr int kSteps = DH == 8 ? 1 : DH / 16;  // depth steps of Q K^T
  constexpr int kDt = DH / 8;                    // 8-wide dh tiles of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // later the output tile
  bf16* ks = qs + kBQ * LD;                      // kStages K tiles
  bf16* vs = ks + kStages * kBK * LD;            // kStages V tiles

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;  // rows 16w..
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kBQ;
  const int r0w = q0 + w * 16;  // this warp's first row
  const int D = H * DH;
  const size_t base = (size_t)(bh / H) * S * D + (size_t)(bh % H) * DH;
  const int ntiles = causal ? qt + 1 : (S + kBK - 1) / kBK;

  // K/V tile j goes to slot j % kStages as one copy group (the first also
  // holds Q), empty past the last tile
  auto load_kv = [&](int j) {
    if (j < ntiles) {
      const int slot = (j % kStages) * kBK * LD;
      load_tile<bf16, DH, LD, kTcThreads>(ks + slot, k, base, D, j * kBK, S);
      load_tile<bf16, DH, LD, kTcThreads>(vs + slot, v, base, D, j * kBK, S);
    }
    qaig::cp_async_commit();
  };
  load_tile<bf16, DH, LD, kTcThreads>(qs, q, base, D, q0, S);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_kv(j);

  // A fragments of this warp's Q at depth 16s..16s+15
  auto load_q = [&](uint32_t (&a)[4], int s) {
    qaig::ldmatrix_x4(a, qs + (w * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  LD +
                             s * 16 + (lane >> 4) * 8);
  };
  uint32_t qa[L::kQInRegs ? kSteps : 1][4];
  float o[kDt][4];
#pragma unroll
  for (int d = 0; d < kDt; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  // running max (of the scaled base-2 scores) and this lane's share of the
  // denominator, rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    load_kv(j + kStages - 1);  // into the slot that tile j - 1 freed
    qaig::cp_async_wait<kStages - 1>();
    __syncthreads();
    if (j == 0) {
      if constexpr (DH == 8) {
        uint32_t a[2];
        qaig::ldmatrix_x2(a, qs + (w * 16 + (lane & 15)) * LD);
        qa[0][0] = a[0];
        qa[0][1] = a[1];
      } else if constexpr (L::kQInRegs) {
#pragma unroll
        for (int s = 0; s < kSteps; ++s) load_q(qa[s], s);
      }
    }
    const int k0 = j * kBK;
    const bf16* kt = ks + (j % kStages) * kBK * LD;
    const bf16* vt = vs + (j % kStages) * kBK * LD;

    // 8-key column tiles [0, jlive) hold a live key for some row of this
    // warp; the rest are skipped (and masked)
    int jlive = min(8, (S - k0 + 7) / 8);
    if (causal) jlive = min(jlive, (r0w + 15 - k0) / 8 + 1);
    const bool need_mask = k0 + kBK > S || (causal && k0 + kBK - 1 > r0w);

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sc[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      sc[c][0] = sc[c][1] = sc[c][2] = sc[c][3] = 0.f;
    if constexpr (DH == 8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (4 * h >= jlive) break;
        uint32_t b[4];  // B fragments of column tiles 4h..4h+3
        qaig::ldmatrix_x4(b, kt + (32 * h + lane) * LD);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          qaig::mma_16x8x8(sc[4 * h + u], qa[0][0], qa[0][1], b[u]);
      }
    } else {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        uint32_t a[4];
        if constexpr (L::kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qa[s][e];
        } else {
          load_q(a, s);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (2 * p >= jlive) break;
          uint32_t b[4];  // column tiles 2p, 2p+1 at depth 16s..16s+15
          qaig::ldmatrix_x4(
              b, kt + (16 * p + (lane >> 4) * 8 + (lane & 7)) * LD + s * 16 +
                     ((lane >> 3) & 1) * 8);
          qaig::mma_16x8x16(sc[2 * p], a, b[0], b[1]);
          qaig::mma_16x8x16(sc[2 * p + 1], a, b[2], b[3]);
        }
      }
    }

    // online softmax of rows g and g + 8 (elements 0-1 and 2-3); the max is
    // taken on the raw scores (the scale is positive) and the scale folds
    // into the exponent's FMA
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
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
      alpha[r] = qaig::fast_exp2(m[r] - mu[r]);
      m[r] = m_new;
    }
    uint32_t pa[4][4];  // A fragments of P, one per 16-key slice
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t lo = qaig::pack_bf16(
          qaig::fast_exp2(fmaf(sc[c][0], scale_log2, -mu[0])),
          qaig::fast_exp2(fmaf(sc[c][1], scale_log2, -mu[0])));
      const uint32_t hi = qaig::pack_bf16(
          qaig::fast_exp2(fmaf(sc[c][2], scale_log2, -mu[1])),
          qaig::fast_exp2(fmaf(sc[c][3], scale_log2, -mu[1])));
      const float2 fl = qaig::unpack_bf16(lo), fh = qaig::unpack_bf16(hi);
      ls[0] += fl.x + fl.y;
      ls[1] += fh.x + fh.y;
      pa[c >> 1][(c & 1) * 2] = lo;
      pa[c >> 1][(c & 1) * 2 + 1] = hi;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
    for (int d = 0; d < kDt; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }

    // O += P V
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (2 * s >= jlive) break;
      if constexpr (DH == 8) {
        uint32_t b[2];
        qaig::ldmatrix_x2_trans(b, vt + (16 * s + (lane & 15)) * LD);
        qaig::mma_16x8x16(o[0], pa[s], b[0], b[1]);
      } else {
#pragma unroll
        for (int dp = 0; dp < kDt / 2; ++dp) {
          uint32_t b[4];  // dh tiles 2dp, 2dp+1 over keys 16s..16s+15
          qaig::ldmatrix_x4_trans(
              b, vt + (16 * s + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     dp * 16 + (lane >> 4) * 8);
          qaig::mma_16x8x16(o[2 * dp], pa[s], b[0], b[1]);
          qaig::mma_16x8x16(o[2 * dp + 1], pa[s], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this slot's reads are done before it is refilled
  }

  // every row keeps key 0, so l > 0
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  // the warp's own 16 rows of qs (only it read them, before the last
  // barrier) stage the output for 16-byte stores
  bf16* os = qs + w * 16 * LD;
#pragma unroll
  for (int d = 0; d < kDt; ++d) {
    *reinterpret_cast<uint32_t*>(os + g * LD + 8 * d + 2 * t) =
        qaig::pack_bf16(o[d][0] * inv[0], o[d][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + 8 * d + 2 * t) =
        qaig::pack_bf16(o[d][2] * inv[1], o[d][3] * inv[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kDt; i += 32) {
    const int r = i / kDt, c = (i % kDt) * 8;
    if (r0w + r < S)
      *reinterpret_cast<uint4*>(out + base + (size_t)(r0w + r) * D + c) =
          *reinterpret_cast<const uint4*>(os + r * LD + c);
  }
}

// ---- float32: register-blocked FMAs --------------------------------------

constexpr int kF32Threads = 256;  // 16 x 16
constexpr int kLdP = kBK + 4;     // float pitch of the probability strips

template <int DH>
struct F32Layout {
  static constexpr int LD = DH + 4;  // float pitch: rows tx + 16c conflict-free
  static constexpr bool kSplitKeys = DH <= 16;  // P stays in registers
  // K/V tiles in flight: at dh >= 32 a tile's FMAs outlast the next load;
  // past dh 128 one slot, as two would not fit in shared memory
  static constexpr int kStages = kSplitKeys ? 4 : DH <= 128 ? 2 : 1;
  static constexpr size_t bytes = ((size_t)(kBQ + 2 * kStages * kBK) * LD +
                                   (kSplitKeys ? 0 : kBQ * kLdP)) * 4;
};

// Halving step of a sum over the lanes of a row: the lanes with `upper`
// keep the top half of x, the others the bottom half, each plus the other
// lane's (offset apart) copy of that half.
template <int N>
__device__ __forceinline__ void halve(const float (&x)[N], float (&y)[N / 2],
                                      int offset, bool upper) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float send = upper ? x[j] : x[j + N / 2];
    const float keep = upper ? x[j + N / 2] : x[j];
    y[j] = keep + __shfl_xor_sync(0xffffffffu, send, offset);
  }
}

template <int DH>
__global__ void __launch_bounds__(kF32Threads) flash_attention_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int S, int H,
    int causal, float scale_log2) {
  using L = F32Layout<DH>;
  constexpr int LD = L::LD;
  constexpr int kStages = L::kStages;
  constexpr int OC = L::kSplitKeys ? DH : DH / 16;  // O columns a thread owns
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * LD;            // kStages K tiles
  float* vs = ks + kStages * kBK * LD;  // kStages V tiles
  float* ps = vs + kStages * kBK * LD;  // probabilities (dh >= 32)

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kBQ;
  const int row0 = q0 + 4 * ty;  // rows row0 .. row0 + 3
  const int D = H * DH;
  const size_t base = (size_t)(bh / H) * S * D + (size_t)(bh % H) * DH;
  const int ntiles = causal ? qt + 1 : (S + kBK - 1) / kBK;

  auto load_kv = [&](int j) {  // as in the bf16 kernel
    if (j < ntiles) {
      const int slot = (j % kStages) * kBK * LD;
      load_tile<float, DH, LD, kF32Threads>(ks + slot, k, base, D, j * kBK,
                                            S);
      load_tile<float, DH, LD, kF32Threads>(vs + slot, v, base, D, j * kBK,
                                            S);
    }
    qaig::cp_async_commit();
  };
  load_tile<float, DH, LD, kF32Threads>(qs, q, base, D, q0, S);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_kv(j);

  float o[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) o[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBK;
    load_kv(it + kStages - 1);  // into the slot that tile it - 1 freed
    qaig::cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* kt = ks + (it % kStages) * kBK * LD;
    const float* vt = vs + (it % kStages) * kBK * LD;

    // scores of rows row0 + i and keys k0 + tx + 16c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * LD + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(kt + (tx + 16 * c) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qv[i].x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv[c].w, s[i][c]);
        }
    }

    const bool need_mask = k0 + kBK > S || (causal && k0 + kBK - 1 > row0);
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[i][c] * scale_log2;
        if (need_mask) {
          const int key = k0 + tx + 16 * c;
          if (key >= S || (causal && key > row0 + i)) x = -INFINITY;
        }
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 lanes of a row are one half of the warp
#pragma unroll
      for (int offset = 8; offset > 0; offset >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, offset));
      const float m_new = fmaxf(m[i], mx);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = qaig::fast_exp2(m[i] - mu);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = qaig::fast_exp2(s[i][c] - mu);  // now a probability
        sum += s[i][c];
      }
      l[i] = l[i] * alpha[i] + sum;  // this thread's 4 keys; summed at the end
#pragma unroll
      for (int c = 0; c < OC; ++c) o[i][c] *= alpha[i];
    }

    if constexpr (L::kSplitKeys) {
      // O (4 x DH, partial) += P (this thread's 4 keys) V
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float* vr = vt + (tx + 16 * c) * LD;
#pragma unroll
        for (int d = 0; d < DH; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[i][d] = fmaf(s[i][c], vv.x, o[i][d]);
            o[i][d + 1] = fmaf(s[i][c], vv.y, o[i][d + 1]);
            o[i][d + 2] = fmaf(s[i][c], vv.z, o[i][d + 2]);
            o[i][d + 3] = fmaf(s[i][c], vv.w, o[i][d + 3]);
          }
        }
      }
    } else {
      // this half-warp's 4 rows of P, then O (4 x DH/16) += P V over all
      // 64 keys; only these 16 lanes touch these rows
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ps[(4 * ty + i) * kLdP + tx + 16 * c] = s[i][c];
      __syncwarp();
#pragma unroll 2
      for (int j = 0; j < kBK; j += 4) {
        float4 pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pv[i] =
              *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kLdP + j);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* vr = vt + (j + u) * LD;
          float vv[OC];
          if constexpr (OC == 2) {
            const float2 x = *reinterpret_cast<const float2*>(vr + 2 * tx);
            vv[0] = x.x;
            vv[1] = x.y;
          } else {
#pragma unroll
            for (int h = 0; h < OC / 4; ++h) {
              const float4 x =
                  *reinterpret_cast<const float4*>(vr + 64 * h + 4 * tx);
              vv[4 * h] = x.x;
              vv[4 * h + 1] = x.y;
              vv[4 * h + 2] = x.z;
              vv[4 * h + 3] = x.w;
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int c = 0; c < OC; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
          }
        }
      }
      __syncwarp();
    }
    __syncthreads();  // this slot's reads are done before it is refilled
  }

  // every row keeps key 0, so l > 0
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int offset = 8; offset > 0; offset >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], offset);

  if constexpr (L::kSplitKeys) {
    // sum the 16 lanes' partial O (4 x DH) by halving: lane tx ends with
    // row tx / 4, columns (tx % 4) * DH / 4 .. + DH / 4 - 1
    float a[4 * DH], b[2 * DH], c[DH], e[DH / 2], f[DH / 4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int d = 0; d < DH; ++d) a[i * DH + d] = o[i][d];
    halve(a, b, 8, tx & 8);
    halve(b, c, 4, tx & 4);
    halve(c, e, 2, tx & 2);
    halve(e, f, 1, tx & 1);
    const int i = tx >> 2;
    const float li = i == 0 ? l[0] : i == 1 ? l[1] : i == 2 ? l[2] : l[3];
    const float inv = 1.f / li;
    float* dst = out + base + (size_t)(row0 + i) * D + (tx & 3) * (DH / 4);
    if (row0 + i < S) {
      if constexpr (DH == 16)
        *reinterpret_cast<float4*>(dst) =
            make_float4(f[0] * inv, f[1] * inv, f[2] * inv, f[3] * inv);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(f[0] * inv, f[1] * inv);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (row0 + i >= S) continue;
      const float f = 1.f / l[i];
      float* dst = out + base + (size_t)(row0 + i) * D;
      if constexpr (OC == 2) {
        *reinterpret_cast<float2*>(dst + 2 * tx) =
            make_float2(o[i][0] * f, o[i][1] * f);
      } else {
#pragma unroll
        for (int h = 0; h < OC / 4; ++h)
          *reinterpret_cast<float4*>(dst + 64 * h + 4 * tx) =
              make_float4(o[i][4 * h] * f, o[i][4 * h + 1] * f,
                          o[i][4 * h + 2] * f, o[i][4 * h + 3] * f);
      }
    }
  }
}

template <typename T>
cudaError_t launch(void (*kernel)(const T*, const T*, const T*, T*, int, int,
                                  int, float),
                   size_t smem, int threads, const void* q, const void* k,
                   const void* v, void* out, int N, int S, int H, int dh,
                   int causal, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(N * H, (S + kBQ - 1) / kBQ);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, causal,
      kLog2e / sqrtf((float)dh));
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* out,
                      int N, int S, int H, int causal, int dtype,
                      cudaStream_t stream) {
  if (dtype == 0)
    return launch(flash_attention_fwd_f32_kernel<DH>, F32Layout<DH>::bytes,
                  kF32Threads, q, k, v, out, N, S, H, DH, causal, stream);
  return launch(flash_attention_fwd_tc_kernel<DH>, TcLayout<DH>::bytes,
                kTcThreads, q, k, v, out, N, S, H, DH, causal, stream);
}

}  // namespace

extern "C" {

// q, k, v, out: (N, S, H*dh), contiguous, 16-byte aligned.  dtype: 0 =
// float32, 1 = bfloat16.  dh in {8, 16, 32, 64, 128, 192, 256}; N * H up
// to 2^31 - 1, S up to 65535 * 64.  Returns the cudaError_t of the launch.
int qaig_flash_attention_fwd(const void* q, const void* k, const void* v,
                             void* out, int N, int S, int H, int dh,
                             int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 8:
      return launch_dh<8>(q, k, v, out, N, S, H, causal, dtype, st);
    case 16:
      return launch_dh<16>(q, k, v, out, N, S, H, causal, dtype, st);
    case 32:
      return launch_dh<32>(q, k, v, out, N, S, H, causal, dtype, st);
    case 64:
      return launch_dh<64>(q, k, v, out, N, S, H, causal, dtype, st);
    case 128:
      return launch_dh<128>(q, k, v, out, N, S, H, causal, dtype, st);
    case 192:
      return launch_dh<192>(q, k, v, out, N, S, H, causal, dtype, st);
    case 256:
      return launch_dh<256>(q, k, v, out, N, S, H, causal, dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* qaig_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
