// Full-sequence self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel of qaig_tpu/ops/flash_attention.py:
// flash_attention -> _flash_fwd_core -> _attn_kernel, which holds a whole
// (S, S) score matrix of one (batch, head) in VMEM.
//
// Function.  q, k, v, out are (N, S, H*dh) with the heads side by side in
// the feature axis (the layout the projections produce); for each (n, h)
// out = softmax(q k^T / sqrt(dh), masked causally when asked) v, with the
// softmax in float32.  The kernel reads and writes that layout directly, so
// no head transpose and no padding of S is needed: ragged S and the causal
// mask are handled in the kernel.
//
// What bounds it on the H100.  It does 4 * N * H * S_eff * dh flops (S_eff
// the live (query, key) pairs: S^2, or S(S+1)/2 causal) on 4 * N * S * H*dh
// elements moved, i.e. about S / 2 operations per byte in bf16: at the
// path's S <= 256 that is under the ~295 of the tensor-core roofline, so
// the bound is the bytes, and the achievable time is set by how well the
// arithmetic hides behind them.
//
// What the design does about it.  Flash-style tiling: a block takes a tile
// of query rows of one (n, h), streams K/V through shared memory in 64-key
// tiles and keeps an online softmax, so no score row goes to device memory
// and each K/V element is read once per query tile.  Causal blocks stop at
// their last query's key.  bf16 inputs run the two products on the tensor
// cores (WMMA 16x16x16, float32 accumulate; one warp owns 16 query rows,
// so the softmax needs no block-wide barrier); float32 inputs keep exact
// float32 FMAs from shared memory.  WMMA's reduction depth is 16, so a
// head dim of 8 runs in tiles padded to 16 columns with zeros (a zero
// column adds nothing to a score and its output column is never stored).
// Head dims 8, 16, 32, 64 and 128.  wgmma, TMA and pipelining are later
// work.

#include "common.cuh"

#include <mma.h>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;  // query rows per block
constexpr int kBK = 64;  // keys per shared-memory tile

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, int H, int causal,
    float scale) {
  constexpr int kPitchK = DH + 1;  // padded rows: conflict-free key reads
  extern __shared__ float smem[];
  float* qs = smem;                 // kBQ * DH, pre-scaled queries
  float* os = qs + kBQ * DH;        // kBQ * DH, output accumulator
  float* ks = os + kBQ * DH;        // kBK * kPitchK
  float* vs = ks + kBK * kPitchK;   // kBK * DH
  float* sc = vs + kBK * DH;        // kBQ * kBK, scores then probabilities
  float* m = sc + kBQ * kBK;        // kBQ
  float* l = m + kBQ;               // kBQ
  float* alpha = l + kBQ;           // kBQ

  const int tid = threadIdx.x;
  const int n = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBQ;
  const int D = H * DH;
  const size_t base = (size_t)n * S * D + (size_t)h * DH;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    qs[i] = q0 + r < S
                ? qaig::to_float(q[base + (size_t)(q0 + r) * D + d]) * scale
                : 0.f;
    os[i] = 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  __syncthreads();

  const int kend = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    const int nk = min(kBK, kend - k0);
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int j = i / DH, d = i % DH;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const size_t off = base + (size_t)(k0 + j) * D + d;
        kv = qaig::to_float(k[off]);
        vv = qaig::to_float(v[off]);
      }
      ks[j * kPitchK + d] = kv;
      vs[j * DH + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, j = i % kBK;
      float s = -INFINITY;
      if (j < nk && (!causal || k0 + j <= q0 + r)) {
        const float* qr = qs + r * DH;
        const float* kj = ks + j * kPitchK;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) dot += qr[d] * kj[d];
        s = dot;
      }
      sc[i] = s;
    }
    __syncthreads();
    qaig::softmax_update(sc, kBK, nk, kBQ, m, l, alpha, nullptr);
    __syncthreads();
    for (int i = tid; i < kBQ * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      const float* pr = sc + r * kBK;
      float sum = 0.f;
      for (int j = 0; j < nk; ++j) sum += pr[j] * vs[j * DH + d];
      os[i] = os[i] * alpha[r] + sum;
    }
    __syncthreads();
  }

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    if (q0 + r < S)
      out[base + (size_t)(q0 + r) * D + d] =
          qaig::from_float<T>(os[i] / l[r]);
  }
}

template <int DH>
constexpr size_t smem_bytes() {
  return (2 * kBQ * DH + kBK * (DH + 1) + kBK * DH + kBQ * kBK + 3 * kBQ) *
         sizeof(float);
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int N, int S, int H, int causal, cudaStream_t stream) {
  auto kernel = flash_attention_fwd_kernel<T, DH>;
  constexpr size_t smem = smem_bytes<DH>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, N * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, causal,
      1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

// ---- bf16: tensor-core products -------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcBQ = 16 * kTcWarps;  // query rows per block, 16 per warp
constexpr int kTcBK = 64;             // keys per tile: two per lane

// DH is the head dim; tiles hold DHP = max(DH, 16) columns, the WMMA depth
template <int DH>
struct TcLayout {
  static constexpr int DHP = DH < 16 ? 16 : DH;
  static constexpr int LDB = DHP + 8;    // bf16 pitch of the Q/K/V tiles
  static constexpr int LDP = kTcBK + 8;  // bf16 pitch of the probabilities
  static constexpr int LDS = kTcBK + 4;  // float pitch of the scores
  static constexpr int LDO = DHP + 4;    // float pitch of O and the PV tile
  static constexpr size_t kBf16 = (size_t)(kTcBQ + 2 * kTcBK) * LDB +
                                  (size_t)kTcBQ * LDP;
  static constexpr size_t kFloats = (size_t)kTcBQ * LDS +
                                    2 * (size_t)kTcBQ * LDO + 3 * kTcBQ;
  static constexpr size_t bytes = kBf16 * 2 + kFloats * 4;
};

// 16-byte copy of 8 bf16 values, zeros past the sequence
__device__ __forceinline__ void copy8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, bool live) {
  *reinterpret_cast<uint4*>(dst) =
      live ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
}

template <int DH>
__global__ void __launch_bounds__(kTcWarps * 32) flash_attention_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int S, int H, int causal, float scale) {
  namespace wmma = nvcuda::wmma;
  using L = TcLayout<DH>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kTcBQ * L::LDB;
  __nv_bfloat16* vs = ks + kTcBK * L::LDB;
  __nv_bfloat16* ps = vs + kTcBK * L::LDB;
  float* sc = reinterpret_cast<float*>(ps + kTcBQ * L::LDP);
  float* os = sc + kTcBQ * L::LDS;
  float* pv = os + kTcBQ * L::LDO;
  float* m = pv + kTcBQ * L::LDO;
  float* l = m + kTcBQ;
  float* alpha = l + kTcBQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16;  // this warp's query rows
  const int n = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * kTcBQ;
  const int D = H * DH;
  const size_t base = (size_t)n * S * D + (size_t)h * DH;
  constexpr int kChunks = DH / 8;

  for (int i = tid; i < kTcBQ * kChunks; i += kTcWarps * 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    copy8(qs + r * L::LDB + c, q + base + (size_t)(q0 + r) * D + c,
          q0 + r < S);
  }
  if constexpr (L::DHP > DH) {
    // padding columns [DH, DHP) stay zero: tile loads never write them
    constexpr int kPad = L::DHP - DH;
    for (int i = tid; i < (kTcBQ + 2 * kTcBK) * kPad; i += kTcWarps * 32) {
      const int r = i / kPad, c = DH + i % kPad;
      qs[r * L::LDB + c] = __float2bfloat16(0.f);  // qs, ks, vs adjacent
    }
  }
  for (int i = tid; i < kTcBQ * DH; i += kTcWarps * 32)
    os[(i / DH) * L::LDO + i % DH] = 0.f;
  for (int r = tid; r < kTcBQ; r += kTcWarps * 32) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  const int kend = causal ? min(S, q0 + kTcBQ) : S;
  for (int k0 = 0; k0 < kend; k0 += kTcBK) {
    const int nk = min(kTcBK, kend - k0);
    __syncthreads();  // previous tile's K/V reads are done
    for (int i = tid; i < kTcBK * kChunks; i += kTcWarps * 32) {
      const int j = i / kChunks, c = (i % kChunks) * 8;
      const size_t off = base + (size_t)(k0 + j) * D + c;
      copy8(ks + j * L::LDB + c, k + off, j < nk);
      copy8(vs + j * L::LDB + c, v + off, j < nk);
    }
    __syncthreads();

    // scores of this warp's 16 rows: Q (16 x DH) . K^T (DH x 64)
    for (int n0 = 0; n0 < kTcBK; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int d0 = 0; d0 < L::DHP; d0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + r0 * L::LDB + d0, L::LDB);
        wmma::load_matrix_sync(b, ks + n0 * L::LDB + d0, L::LDB);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sc + r0 * L::LDS + n0, acc, L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time across the warp (two keys a lane);
    // the denominator sums the bf16-rounded probabilities the PV product
    // uses
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      float s[2];
      float mx = -INFINITY;
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        const bool live = j < nk && (!causal || k0 + j <= q0 + r);
        s[t] = live ? sc[r * L::LDS + j] * scale : -INFINITY;
        mx = fmaxf(mx, s[t]);
      }
      mx = qaig::warp_max(mx);
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int t = 0; t < 2; ++t) {
        const __nv_bfloat16 p = __float2bfloat16(expf(s[t] - m_use));
        ps[r * L::LDP + lane + 32 * t] = p;
        sum += __bfloat162float(p);
      }
      sum = qaig::warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_use);
        alpha[r] = a;
        l[r] = l[r] * a + sum;
        m[r] = m_new;
      }
    }
    __syncwarp();

    // P (16 x 64) . V (64 x DHP) for this warp's rows
    for (int d0 = 0; d0 < L::DHP; d0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int j0 = 0; j0 < kTcBK; j0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(a, ps + r0 * L::LDP + j0, L::LDP);
        wmma::load_matrix_sync(b, vs + j0 * L::LDB + d0, L::LDB);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(pv + r0 * L::LDO + d0, acc, L::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * DH; i += 32) {
      const int r = r0 + i / DH, d = i % DH;
      os[r * L::LDO + d] = os[r * L::LDO + d] * alpha[r] + pv[r * L::LDO + d];
    }
  }
  __syncwarp();

  for (int i = lane; i < 16 * DH; i += 32) {
    const int r = r0 + i / DH, d = i % DH;
    if (q0 + r < S)
      out[base + (size_t)(q0 + r) * D + d] =
          __float2bfloat16(os[r * L::LDO + d] / l[r]);
  }
}

template <int DH>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int N, int S, int H, int causal, cudaStream_t stream) {
  auto kernel = flash_attention_fwd_tc_kernel<DH>;
  constexpr size_t smem = TcLayout<DH>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTcBQ - 1) / kTcBQ, N * H);
  kernel<<<grid, kTcWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), S, H, causal,
      1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        void* out, int N, int S, int H, int dh, int causal,
                        cudaStream_t stream) {
  constexpr bool kTc = std::is_same<T, __nv_bfloat16>::value;
  switch (dh) {
    case 8:
      return kTc ? launch_tc<8>(q, k, v, out, N, S, H, causal, stream)
                 : launch<T, 8>(q, k, v, out, N, S, H, causal, stream);
    case 16:
      return kTc ? launch_tc<16>(q, k, v, out, N, S, H, causal, stream)
                 : launch<T, 16>(q, k, v, out, N, S, H, causal, stream);
    case 32:
      return kTc ? launch_tc<32>(q, k, v, out, N, S, H, causal, stream)
                 : launch<T, 32>(q, k, v, out, N, S, H, causal, stream);
    case 64:
      return kTc ? launch_tc<64>(q, k, v, out, N, S, H, causal, stream)
                 : launch<T, 64>(q, k, v, out, N, S, H, causal, stream);
    case 128:
      return kTc ? launch_tc<128>(q, k, v, out, N, S, H, causal, stream)
                 : launch<T, 128>(q, k, v, out, N, S, H, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, out: (N, S, H*dh), contiguous.  dtype: 0 = float32,
// 1 = bfloat16.  dh in {8, 16, 32, 64, 128}.  Returns the cudaError_t of the
// launch.
int qaig_flash_attention_fwd(const void* q, const void* k, const void* v,
                             void* out, int N, int S, int H, int dh,
                             int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, out, N, S, H, dh, causal, st);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, out, N, S, H, dh, causal, st);
  return (int)cudaErrorInvalidValue;
}

const char* qaig_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
