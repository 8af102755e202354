// Shared-prefix rollout decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernels of qaig_tpu/ops/decode_attention.py:
//   * shared_prefix_attention_fused_t    (bf16 prefix; _kernel_t_bf16, _head_attention)
//   * shared_prefix_attention_fused_int8 (int8 prefix + per-slot bf16 scales;
//                                          _kernel_t_int8)
// One template covers both: the prefix element type P is the query type T
// (kernel B) or int8_t (kernel C).
//
// Function.  For image n, its B rollouts (rows n*B .. n*B+B-1 of q) attend in
// ONE float32 softmax over the image's shared prefix (slots s < index0 of the
// (N, H, dh, S) caches) and over their own segment (slots t <= block_index of
// the (N*B, H, bw, dh) blocks).  For the int8 prefix the per-slot scales fold
// into the scores (K) and the probabilities (V); no dequantized prefix is
// ever written.
//
// What bounds it on the H100.  Per step the kernel moves the live prefix K/V
// (2 * N * H * dh * index0 elements) plus the blocks and q/out, and does
// 4 * N * B * H * dh * (index0 + block_index + 1) flops: about B / 2
// operations per prefix byte in bf16 (16 at B = 32), far below the ~295
// the tensor cores need to be the limit.  It is bound by the bytes of the
// prefix.
//
// What the design does about it.  One block per (image, head) streams that
// head's prefix from device memory exactly once for all B rollouts, in tiles
// of kTile slots, with slot-minor coalesced loads (neighbouring threads on
// neighbouring slots, the layout the caches keep).  Slots >= index0 are never
// read.  Scores, probabilities and the output accumulator stay in shared
// memory (online softmax across tiles), so nothing but the output is
// written.  The arithmetic is plain float32 FMAs: simple and right first;
// tensor-core products and asynchronous copies are later work.

#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // prefix / block slots per shared-memory tile

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) shared_prefix_attention_kernel(
    const T* __restrict__ q,                    // (N*B, H*dh)
    const P* __restrict__ k_shared,             // (N, H, dh, S)
    const P* __restrict__ v_shared,             // (N, H, dh, S)
    const __nv_bfloat16* __restrict__ k_scale,  // (N, H, S), int8 only
    const __nv_bfloat16* __restrict__ v_scale,  // (N, H, S), int8 only
    const T* __restrict__ k_block,              // (N*B, H, bw, dh)
    const T* __restrict__ v_block,              // (N*B, H, bw, dh)
    T* __restrict__ out,                        // (N*B, H*dh)
    int B, int H, int dh, int S, int bw, int index0, int block_index,
    float scale) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int kPitch = kTile + 1;  // padded rows: conflict-free column reads
  extern __shared__ float smem[];
  float* qs = smem;                 // B * dh, pre-scaled queries
  float* acc = qs + B * dh;         // B * dh, output accumulator
  float* sc = acc + B * dh;         // B * kTile, scores then probabilities
  float* ks = sc + B * kTile;       // dh * kPitch, prefix K tile
  float* vs = ks + dh * kPitch;     // dh * kPitch, prefix V tile
  float* m = vs + dh * kPitch;      // B, running max
  float* l = m + B;                 // B, running denominator
  float* alpha = l + B;             // B, rescale factor of this tile
  float* kss = alpha + B;           // kTile, K scales of this tile
  float* vss = kss + kTile;         // kTile, V scales of this tile

  const int tid = threadIdx.x;
  const int n = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int D = H * dh;

  for (int i = tid; i < B * dh; i += kThreads) {
    const int b = i / dh, d = i % dh;
    qs[i] = qaig::to_float(q[(size_t)(n * B + b) * D + h * dh + d]) * scale;
    acc[i] = 0.f;
  }
  for (int b = tid; b < B; b += kThreads) {
    m[b] = -INFINITY;
    l[b] = 0.f;
  }
  __syncthreads();

  // ---- shared prefix: slots [0, index0), streamed once for all rollouts
  const size_t head = (size_t)n * H + h;
  const P* kp = k_shared + head * dh * S;
  const P* vp = v_shared + head * dh * S;
  for (int s0 = 0; s0 < index0; s0 += kTile) {
    const int ns = min(kTile, index0 - s0);
    for (int i = tid; i < dh * kTile; i += kThreads) {
      const int d = i / kTile, s = i % kTile;
      float kv = 0.f, vv = 0.f;
      if (s < ns) {
        kv = qaig::to_float(kp[(size_t)d * S + s0 + s]);
        vv = qaig::to_float(vp[(size_t)d * S + s0 + s]);
      }
      ks[d * kPitch + s] = kv;
      vs[d * kPitch + s] = vv;
    }
    if (kQuant) {
      for (int s = tid; s < kTile; s += kThreads) {
        const bool live = s < ns;
        kss[s] = live ? __bfloat162float(k_scale[head * S + s0 + s]) : 0.f;
        vss[s] = live ? __bfloat162float(v_scale[head * S + s0 + s]) : 0.f;
      }
    }
    __syncthreads();
    for (int i = tid; i < B * kTile; i += kThreads) {
      const int b = i / kTile, s = i % kTile;
      float v = -INFINITY;
      if (s < ns) {
        const float* qb = qs + b * dh;
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot += qb[d] * ks[d * kPitch + s];
        v = kQuant ? dot * kss[s] : dot;
      }
      sc[i] = v;
    }
    __syncthreads();
    qaig::softmax_update(sc, kTile, ns, B, m, l, alpha,
                         kQuant ? vss : nullptr);
    __syncthreads();
    for (int i = tid; i < B * dh; i += kThreads) {
      const int b = i / dh, d = i % dh;
      const float* pb = sc + b * kTile;
      const float* vd = vs + d * kPitch;
      float sum = 0.f;
      for (int s = 0; s < ns; ++s) sum += pb[s] * vd[s];
      acc[i] = acc[i] * alpha[b] + sum;
    }
    __syncthreads();
  }

  // ---- per-rollout segment: slots [0, block_index]
  for (int t0 = 0; t0 <= block_index; t0 += kTile) {
    const int nt = min(kTile, block_index + 1 - t0);
    for (int i = tid; i < B * kTile; i += kThreads) {
      const int b = i / kTile, t = i % kTile;
      float v = -INFINITY;
      if (t < nt) {
        const T* kr =
            k_block + (((size_t)(n * B + b) * H + h) * bw + t0 + t) * dh;
        const float* qb = qs + b * dh;
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot += qb[d] * qaig::to_float(kr[d]);
        v = dot;
      }
      sc[i] = v;
    }
    __syncthreads();
    qaig::softmax_update(sc, kTile, nt, B, m, l, alpha, nullptr);
    __syncthreads();
    for (int i = tid; i < B * dh; i += kThreads) {
      const int b = i / dh, d = i % dh;
      const float* pb = sc + b * kTile;
      const T* vr =
          v_block + (((size_t)(n * B + b) * H + h) * bw + t0) * dh + d;
      float sum = 0.f;
      for (int t = 0; t < nt; ++t)
        sum += pb[t] * qaig::to_float(vr[(size_t)t * dh]);
      acc[i] = acc[i] * alpha[b] + sum;
    }
    __syncthreads();
  }

  for (int i = tid; i < B * dh; i += kThreads) {
    const int b = i / dh, d = i % dh;
    out[(size_t)(n * B + b) * D + h * dh + d] =
        qaig::from_float<T>(acc[i] / l[b]);
  }
}

size_t smem_bytes(int B, int dh) {
  const size_t floats = 2 * (size_t)B * dh + (size_t)B * kTile +
                        2 * (size_t)dh * (kTile + 1) + 3 * (size_t)B +
                        2 * kTile;
  return floats * sizeof(float);
}

template <typename T, typename P>
cudaError_t launch(const void* q, const void* k_shared, const void* v_shared,
                   const void* k_scale, const void* v_scale,
                   const void* k_block, const void* v_block, void* out, int N,
                   int B, int H, int dh, int S, int bw, int index0,
                   int block_index, cudaStream_t stream) {
  auto kernel = shared_prefix_attention_kernel<T, P>;
  const size_t smem = smem_bytes(B, dh);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<N * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_shared),
      static_cast<const P*>(v_shared),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const T*>(k_block), static_cast<const T*>(v_block),
      static_cast<T*>(out), B, H, dh, S, bw, index0, block_index,
      1.0f / sqrtf((float)dh));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one launch needs (the wrapper refuses shapes above the
// card's 227 KB per block).
size_t qaig_shared_prefix_attention_smem(int B, int dh) {
  return smem_bytes(B, dh);
}

// dtype: 0 = float32, 1 = bfloat16 (q, blocks, out; and the prefix unless
// prefix_int8).  Returns the cudaError_t of the launch.
int qaig_shared_prefix_attention(const void* q, const void* k_shared,
                                 const void* v_shared, const void* k_scale,
                                 const void* v_scale, const void* k_block,
                                 const void* v_block, void* out, int N, int B,
                                 int H, int dh, int S, int bw, int index0,
                                 int block_index, int dtype, int prefix_int8,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !prefix_int8)
    return launch<float, float>(q, k_shared, v_shared, k_scale, v_scale,
                                k_block, v_block, out, N, B, H, dh, S, bw,
                                index0, block_index, st);
  if (dtype == 1 && !prefix_int8)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_shared, v_shared, k_scale, v_scale, k_block, v_block, out, N, B,
        H, dh, S, bw, index0, block_index, st);
  if (dtype == 0 && prefix_int8)
    return launch<float, int8_t>(q, k_shared, v_shared, k_scale, v_scale,
                                 k_block, v_block, out, N, B, H, dh, S, bw,
                                 index0, block_index, st);
  if (dtype == 1 && prefix_int8)
    return launch<__nv_bfloat16, int8_t>(
        q, k_shared, v_shared, k_scale, v_scale, k_block, v_block, out, N, B,
        H, dh, S, bw, index0, block_index, st);
  return (int)cudaErrorInvalidValue;
}

const char* qaig_decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
