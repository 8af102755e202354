// Shared-prefix rollout decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernels of qaig_tpu/ops/decode_attention.py:
//   * shared_prefix_attention_fused_t    (bf16 prefix; _kernel_t_bf16,
//                                          _head_attention): kernel B,
//                                          prefix_split_kernel below;
//   * shared_prefix_attention_fused_int8 (int8 prefix + per-slot bf16 scales;
//                                          _kernel_t_int8): kernel C,
//                                          shared_prefix_attention_kernel.
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
// the tensor cores need to be the limit, and under the ~20 of the float32
// FMAs.  It is bound by the bytes of the prefix.
//
// Kernel B: flash-decoding inside one launch, on thread block clusters.
// Each (image, head) prefix is cut into `splits` (1 or 2) contiguous slot
// ranges, chosen by the wrapper (decode_attention.launch_plan) so that the
// card's SMs are filled, and one cluster of `splits` CTAs takes the
// (image, head): CTA rank r streams range r in 64-slot tiles through a ring
// of two shared-memory slots filled by 16-byte cp.async copies (the next
// tile lands while this one is used), and keeps a partial max, sum and
// B x dh accumulator (online softmax, base 2) for every rollout; the
// segment's chunks (whole block rows of every rollout) are dealt to the
// ranks in turn through the same ring.  Scores run as 4-rollout register blocks (one K slot pair a
// lane, a float4 of 4 rollouts' q a read), with the head dim split across
// warps when B is small so that all 8 warps work; P V reads each V row as
// 16-byte vectors for up to 8 rollouts.  After a cluster barrier the CTAs
// combine the partials through distributed shared memory in fixed rank
// order, each rank writing a disjoint slice of the B x dh outputs: the
// result is deterministic, and needs no global scratch and no second
// launch.  The arithmetic is exact float32 FMAs (exp2f for the softmax).
//
// Kernel C keeps the first port's design: one block per (image, head)
// streams the prefix in 32-slot tiles with slot-minor coalesced element
// loads, scores and probabilities in shared memory (its redesign is later
// work).

#include "common.cuh"

#include <cooperative_groups.h>
#include <type_traits>

namespace cg = cooperative_groups;

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


// ---- kernel B: the prefix split across a cluster ---------------------------

constexpr int kSlots = 64;  // prefix slots per ring tile (and segment chunk)
// CTAs a cluster: on the H100 clusters of 4 and 8 ran slower than pairs at
// every timed shape
constexpr int kMaxSplits = 2;
// ring slots: two were as fast as three or four, or faster, at every shape
// swept on the H100, and leave room for two CTAs an SM
constexpr int kMaxStages = 2;

// dims parts of the score products: with g4 = ceil(B / 4) groups of 4
// rollouts, the head dim is split in `parts` so that g4 * parts units fill
// the 8 warps (at most 8 parts)
__host__ __device__ inline int score_parts(int B) {
  const int g4 = (B + 3) / 4;
  int parts = 1;
  while (parts < 8 && 2 * parts * g4 <= 8) parts *= 2;
  return parts;
}

// floats before the ring: q (dh x B4, transposed), the accumulator (B x
// dh), the score strips (parts x B4 x kSlots) and m, l, alpha (B4 each),
// rounded up to 16 bytes
__host__ __device__ inline size_t split_floats(int B, int dh) {
  const size_t b4 = (B + 3) & ~3;
  const size_t f = (size_t)dh * b4 + (size_t)B * dh +
                   (size_t)score_parts(B) * b4 * kSlots + 3 * b4;
  return (f + 3) & ~(size_t)3;
}

// A ring slot holds a K and a V part of `slot_elems` elements each: a
// prefix tile (dh rows of kSlots slots, pitch kSlots + one 16-byte chunk,
// so 8 rows of 16-byte reads hit distinct bank groups) or a segment chunk
// (rows (b, t) of dh elements, pitch dh + one 16-byte chunk), rounded up
// to 16 bytes.
__host__ __device__ inline size_t slot_elems(int B, int dh, int elem) {
  const int vec = 16 / elem;
  const size_t prefix = (size_t)dh * (kSlots + vec);
  const size_t seg = (size_t)B * (dh + vec);
  return ((prefix > seg ? prefix : seg) + vec - 1) / vec * vec;
}

// segment slots a chunk holds for all B rollouts (at least 1)
__host__ __device__ inline int seg_chunk(int B, int dh, int elem) {
  const size_t t = slot_elems(B, dh, elem) / ((size_t)B * (dh + 16 / elem));
  return t < kSlots ? (int)t : kSlots;
}

__host__ __device__ inline size_t split_smem(int B, int dh, int elem,
                                             int stages) {
  return split_floats(B, dh) * 4 +
         (size_t)stages * 2 * slot_elems(B, dh, elem) * elem;
}

// 16-byte cp.async of which the first `bytes` are read and the rest zeroed
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   qaig::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 16 bytes of V slots as floats
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const float2 a = qaig::unpack_bf16(u.x), b = qaig::unpack_bf16(u.y);
  const float2 c = qaig::unpack_bf16(u.z), d = qaig::unpack_bf16(u.w);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  x[4] = c.x; x[5] = c.y; x[6] = d.x; x[7] = d.y;
}

// Scores of one prefix tile, base 2: unit u of (4-rollout group, dims
// part) per warp, lane l on slots 2l and 2l + 1; part p's partial sums go
// to strip p.  Rollouts past B have q = 0.
template <typename T>
__device__ __forceinline__ void prefix_scores(const T* kt, const float* qsT,
                                              float* sc, int b4, int dh,
                                              int parts, int ns) {
  constexpr int kPitch = kSlots + 16 / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (dh + parts - 1) / parts;
  for (int u = warp; u < (b4 / 4) * parts; u += kThreads / 32) {
    const int g = u / parts, part = u % parts;
    const int d1 = min(dh, (part + 1) * per);
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
    if (2 * lane < ns) {
#pragma unroll 4
      for (int d = part * per; d < d1; ++d) {
        const float2 kk = load_pair(kt + d * kPitch + 2 * lane);
        const float4 qq =
            *reinterpret_cast<const float4*>(qsT + d * b4 + 4 * g);
        s0[0] = fmaf(qq.x, kk.x, s0[0]); s1[0] = fmaf(qq.x, kk.y, s1[0]);
        s0[1] = fmaf(qq.y, kk.x, s0[1]); s1[1] = fmaf(qq.y, kk.y, s1[1]);
        s0[2] = fmaf(qq.z, kk.x, s0[2]); s1[2] = fmaf(qq.z, kk.y, s1[2]);
        s0[3] = fmaf(qq.w, kk.x, s0[3]); s1[3] = fmaf(qq.w, kk.y, s1[3]);
      }
    }
    float* dst = sc + (size_t)(part * b4 + 4 * g) * kSlots + 2 * lane;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(dst + j * kSlots) = make_float2(s0[j], s1[j]);
  }
}

// Online-softmax step of rows b < B over columns [0, ncols) of the score
// strips (the sum of `parts` partials, added in part order): one warp per
// row, two columns a lane; the probabilities replace strip 0's row.
__device__ __forceinline__ void softmax_rows(float* sc, int parts, int b4,
                                             int B, int ncols, float* m,
                                             float* l, float* alpha) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < B; b += kThreads / 32) {
    float x[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 2 * lane + j;
      float v = 0.f;
      for (int p = 0; p < parts; ++p) v += sc[(size_t)(p * b4 + b) * kSlots + c];
      x[j] = c < ncols ? v : -INFINITY;
    }
    const float mx = qaig::warp_max(fmaxf(x[0], x[1]));
    const float m_old = m[b];
    const float m_new = fmaxf(m_old, mx);
    const float mu = m_new == -INFINITY ? 0.f : m_new;
    const float p0 = exp2f(x[0] - mu), p1 = exp2f(x[1] - mu);
    *reinterpret_cast<float2*>(sc + (size_t)b * kSlots + 2 * lane) =
        make_float2(p0, p1);
    const float sum = qaig::warp_sum(p0 + p1);
    if (lane == 0) {
      const float a = exp2f(m_old - mu);
      alpha[b] = a;
      l[b] = l[b] * a + sum;
      m[b] = m_new;
    }
  }
}

// acc (B x dh) = acc * alpha + P V over one prefix tile: item (d, group of
// R rollouts), V row d read as 16-byte vectors once for the group
template <typename T, int R>
__device__ __forceinline__ void prefix_pv(const T* vt, const float* sc,
                                          float* acc, const float* alpha,
                                          int B, int dh, int ns) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPitch = kSlots + kVec;
  const int groups = (B + R - 1) / R;
  for (int i = threadIdx.x; i < dh * groups; i += kThreads) {
    const int d = i % dh, b0 = (i / dh) * R;
    float sum[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sum[r] = 0.f;
    const T* vr = vt + d * kPitch;
    for (int s = 0; s < ns; s += kVec) {
      float vv[kVec];
      load_vec(vr + s, vv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (b0 + r < B) {
          const float* pr = sc + (size_t)(b0 + r) * kSlots + s;
#pragma unroll
          for (int e = 0; e < kVec; e += 4) {
            const float4 p = *reinterpret_cast<const float4*>(pr + e);
            sum[r] = fmaf(p.x, vv[e], sum[r]);
            sum[r] = fmaf(p.y, vv[e + 1], sum[r]);
            sum[r] = fmaf(p.z, vv[e + 2], sum[r]);
            sum[r] = fmaf(p.w, vv[e + 3], sum[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (b0 + r < B) {
        float* a = acc + (size_t)(b0 + r) * dh + d;
        *a = *a * alpha[b0 + r] + sum[r];
      }
    }
  }
}

// rollouts per P V item: the most (up to 8) that still give every thread
// an item
__device__ __forceinline__ int pv_group(int B, int dh) {
  int r = 1;
  while (r < 8 && B * dh / (2 * r) >= kThreads) r *= 2;
  return r;
}

// Scores and P V of one segment chunk (slots [t0, t0 + nt) of every
// rollout, row b * nt + t of the K and V parts): four lanes a row for the
// scores, one thread a (rollout, dim) for P V.
template <typename T>
__device__ __forceinline__ void segment_chunk(const T* kt, const T* vt,
                                              const float* qsT, float* sc,
                                              float* acc, float* m, float* l,
                                              float* alpha, int B, int b4,
                                              int dh, int nt) {
  const int sp = dh + 16 / (int)sizeof(T);
  const int rows = B * nt;
  for (int base = 0; base < rows * 4; base += kThreads) {
    const int idx = base + threadIdx.x, row = idx >> 2, part = idx & 3;
    const bool live = row < rows;
    const int b = live ? row / nt : 0, t = live ? row % nt : 0;
    float dot = 0.f;
    if (live) {
      const T* kr = kt + (size_t)row * sp;
      for (int d = part; d < dh; d += 4)
        dot = fmaf(qsT[d * b4 + b], qaig::to_float(kr[d]), dot);
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    if (live && part == 0) sc[(size_t)b * kSlots + t] = dot;
  }
  __syncthreads();
  softmax_rows(sc, 1, b4, B, nt, m, l, alpha);
  __syncthreads();
  for (int i = threadIdx.x; i < B * dh; i += kThreads) {
    const int b = i / dh, d = i % dh;
    const T* vr = vt + (size_t)b * nt * sp + d;
    const float* pb = sc + (size_t)b * kSlots;
    float sum = 0.f;
    for (int t = 0; t < nt; ++t)
      sum = fmaf(pb[t], qaig::to_float(vr[(size_t)t * sp]), sum);
    acc[i] = acc[i] * alpha[b] + sum;
  }
}

// At most 128 registers a thread, so that the registers leave room for two
// CTAs an SM (decode_attention.launch_plan counts the CTAs a wave holds).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) prefix_split_kernel(
    const T* __restrict__ q,        // (N*B, H*dh)
    const T* __restrict__ k_shared, // (N, H, dh, S)
    const T* __restrict__ v_shared, // (N, H, dh, S)
    const T* __restrict__ k_block,  // (N*B, H, bw, dh)
    const T* __restrict__ v_block,  // (N*B, H, bw, dh)
    T* __restrict__ out,            // (N*B, H*dh)
    int B, int H, int dh, int S, int bw, int index0, int block_index,
    int chunk, int stages, int vec, float scale_log2) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPitch = kSlots + kVec;
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int nh = blockIdx.x / splits;
  const int n = nh / H, h = nh % H;
  const int D = H * dh;
  const int tid = threadIdx.x;
  const int b4 = (B + 3) & ~3;
  const int parts = score_parts(B);
  extern __shared__ float4 smem4[];
  float* qsT = reinterpret_cast<float*>(smem4);  // dh x b4, pre-scaled
  float* acc = qsT + dh * b4;                     // B x dh
  float* sc = acc + B * dh;                       // parts x b4 x kSlots
  float* m = sc + parts * b4 * kSlots;
  float* l = m + b4;
  float* alpha = l + b4;
  const size_t slot = slot_elems(B, dh, sizeof(T));
  T* ring = reinterpret_cast<T*>(reinterpret_cast<float*>(smem4) +
                                 split_floats(B, dh));

  // this rank's tiles: prefix slots [lo, hi) in tiles of kSlots, then
  // segment chunks rank, rank + splits, ... of the segment's slots
  // [0, block_index] cut in chunks of tc
  const int lo = min(index0, rank * chunk);
  const int hi = min(index0, lo + chunk);
  const int ptiles = (hi - lo + kSlots - 1) / kSlots;
  const int nseg = block_index + 1;
  const int tc = seg_chunk(B, dh, sizeof(T));
  const int nchunks = (nseg + tc - 1) / tc;
  const int ntiles = ptiles + max(0, (nchunks - rank + splits - 1) / splits);
  const size_t head = (size_t)n * H + h;
  const T* kp = k_shared + head * dh * S;
  const T* vp = v_shared + head * dh * S;
  auto load = [&](int it) {
    if (it < ntiles) {
      T* kt = ring + (size_t)(it % stages) * 2 * slot;
      T* vt = kt + slot;
      if (it < ptiles) {
        const int s0 = lo + it * kSlots;
        const int ns = min(kSlots, hi - s0);
        if (vec & 1) {  // prefix rows 16-byte aligned: chunks of kVec slots
          for (int i = tid; i < dh * (kSlots / kVec); i += kThreads) {
            const int d = i / (kSlots / kVec);
            const int c = (i % (kSlots / kVec)) * kVec;
            const int live = max(0, min(kVec, ns - c));
            const size_t at = (size_t)d * S + s0 + (live ? c : 0);
            cp_async_n(kt + d * kPitch + c, kp + at, live * (int)sizeof(T));
            cp_async_n(vt + d * kPitch + c, vp + at, live * (int)sizeof(T));
          }
        } else {
          for (int i = tid; i < dh * kSlots; i += kThreads) {
            const int d = i / kSlots, c = i % kSlots;
            const bool live = c < ns;
            const size_t at = (size_t)d * S + s0 + c;
            kt[d * kPitch + c] = live ? kp[at] : qaig::from_float<T>(0.f);
            vt[d * kPitch + c] = live ? vp[at] : qaig::from_float<T>(0.f);
          }
        }
      } else {
        const int t0 = (rank + (it - ptiles) * splits) * tc;
        const int nt = min(tc, nseg - t0);
        const int sp = dh + kVec;
        const size_t row0 = ((size_t)n * B * H + h) * bw + t0;
        if (vec & 2) {  // whole block rows as 16-byte chunks
          const int per = dh / kVec;
          for (int i = tid; i < B * nt * per; i += kThreads) {
            const int row = i / per, c = (i % per) * kVec;
            const int b = row / nt, t = row % nt;
            const size_t at = (row0 + (size_t)b * H * bw + t) * dh + c;
            cp_async_n(kt + row * sp + c, k_block + at, 16);
            cp_async_n(vt + row * sp + c, v_block + at, 16);
          }
        } else {
          for (int i = tid; i < B * nt * dh; i += kThreads) {
            const int row = i / dh, c = i % dh;
            const int b = row / nt, t = row % nt;
            const size_t at = (row0 + (size_t)b * H * bw + t) * dh + c;
            kt[row * sp + c] = k_block[at];
            vt[row * sp + c] = v_block[at];
          }
        }
      }
    }
    qaig::cp_async_commit();
  };
  // every copy of the first `stages` tiles is in flight before q is read
  for (int j = 0; j < stages; ++j) load(j);

#pragma unroll 8
  for (int i = tid; i < b4 * dh; i += kThreads) {
    const int b = i / dh, d = i % dh;
    qsT[d * b4 + b] =
        b < B ? qaig::to_float(q[(size_t)(n * B + b) * D + h * dh + d]) *
                    scale_log2
              : 0.f;
  }
  for (int i = tid; i < B * dh; i += kThreads) acc[i] = 0.f;
  for (int b = tid; b < b4; b += kThreads) {
    m[b] = -INFINITY;
    l[b] = 0.f;
  }

  const int rv = pv_group(B, dh);
  for (int it = 0; it < ntiles; ++it) {
    // tile it has landed (with two slots, tile it + 1 may stay in flight)
    if (stages > 1)
      qaig::cp_async_wait<1>();
    else
      qaig::cp_async_wait<0>();
    __syncthreads();
    const T* kt = ring + (size_t)(it % stages) * 2 * slot;
    const T* vt = kt + slot;
    if (it < ptiles) {
      const int ns = min(kSlots, hi - (lo + it * kSlots));
      prefix_scores(kt, qsT, sc, b4, dh, parts, ns);
      __syncthreads();
      softmax_rows(sc, parts, b4, B, ns, m, l, alpha);
      __syncthreads();
      switch (rv) {
        case 1: prefix_pv<T, 1>(vt, sc, acc, alpha, B, dh, ns); break;
        case 2: prefix_pv<T, 2>(vt, sc, acc, alpha, B, dh, ns); break;
        case 4: prefix_pv<T, 4>(vt, sc, acc, alpha, B, dh, ns); break;
        default: prefix_pv<T, 8>(vt, sc, acc, alpha, B, dh, ns); break;
      }
    } else {
      const int t0 = (rank + (it - ptiles) * splits) * tc;
      segment_chunk(kt, vt, qsT, sc, acc, m, l, alpha, B, b4, dh,
                    min(tc, nseg - t0));
    }
    __syncthreads();  // this slot's reads are done before it is refilled
    load(it + stages);
  }
  qaig::cp_async_wait<0>();
  __syncthreads();

  // ---- combine the ranks' partials in rank order through distributed
  // shared memory; rank r writes outputs [r * per, (r + 1) * per)
  cluster.sync();
  const int E = B * dh;
  const int per = (E + splits - 1) / splits;
  const int e1 = min(E, (rank + 1) * per);
  for (int e = rank * per + tid; e < e1; e += kThreads) {
    const int b = e / dh, d = e % dh;
    // every rank's reads in flight at once
    float mr[kMaxSplits], lr[kMaxSplits], ar[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) {
        mr[r] = cluster.map_shared_rank(m, r)[b];
        lr[r] = cluster.map_shared_rank(l, r)[b];
        ar[r] = cluster.map_shared_rank(acc, r)[e];
      }
    }
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits) M = fmaxf(M, mr[r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) {
        const float w = mr[r] == -INFINITY ? 0.f : exp2f(mr[r] - M);
        L = fmaf(lr[r], w, L);
        O = fmaf(ar[r], w, O);
      }
    }
    out[(size_t)(n * B + b) * D + h * dh + d] = qaig::from_float<T>(O / L);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

template <typename T>
cudaError_t split_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                         int N, int B, int H, int dh, int splits, int stages,
                         cudaStream_t stream) {
  auto kernel = prefix_split_kernel<T>;
  const size_t smem = split_smem(B, dh, sizeof(T), stages);
  static bool attributes_set = false;  // once per type: a block's maximum
  if (!attributes_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    attributes_set = true;
  }
  cfg = {};
  cfg.gridDim = dim3((unsigned)N * H * splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_split(const void* q, const void* k_shared,
                         const void* v_shared, const void* k_block,
                         const void* v_block, void* out, int N, int B, int H,
                         int dh, int S, int bw, int index0, int block_index,
                         int splits, int chunk, int stages, int vec,
                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      split_config<T>(cfg, attr, N, B, H, dh, splits, stages, stream);
  if (err != cudaSuccess) return err;
  const float kLog2e = 1.4426950408889634f;
  err = cudaLaunchKernelEx(
      &cfg, prefix_split_kernel<T>, static_cast<const T*>(q),
      static_cast<const T*>(k_shared), static_cast<const T*>(v_shared),
      static_cast<const T*>(k_block), static_cast<const T*>(v_block),
      static_cast<T*>(out), B, H, dh, S, bw, index0, block_index, chunk,
      stages, vec, kLog2e / sqrtf((float)dh));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel C.  Shared memory one launch needs (the wrapper refuses shapes
// above the card's 227 KB per block).
size_t qaig_shared_prefix_attention_smem(int B, int dh) {
  return smem_bytes(B, dh);
}

// Kernel C: int8 prefix with per-slot scales.  dtype: 0 = float32, 1 =
// bfloat16 (q, blocks, out).  Returns the cudaError_t of the launch.
int qaig_shared_prefix_attention_int8(const void* q, const void* k_shared,
                                      const void* v_shared,
                                      const void* k_scale,
                                      const void* v_scale,
                                      const void* k_block,
                                      const void* v_block, void* out, int N,
                                      int B, int H, int dh, int S, int bw,
                                      int index0, int block_index, int dtype,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, int8_t>(q, k_shared, v_shared, k_scale, v_scale,
                                 k_block, v_block, out, N, B, H, dh, S, bw,
                                 index0, block_index, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t>(
        q, k_shared, v_shared, k_scale, v_scale, k_block, v_block, out, N, B,
        H, dh, S, bw, index0, block_index, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel B.  Shared memory of one CTA: elem = 4 (float32) or 2 (bf16).
size_t qaig_prefix_split_smem(int B, int dh, int elem, int stages) {
  return split_smem(B, dh, elem, stages);
}

// Kernel B: clusters of `splits` CTAs the card holds at once for this
// shape (cudaOccupancyMaxActiveClusters), or -1 on an error.
int qaig_prefix_split_max_clusters(int B, int dh, int dtype, int splits,
                                   int stages) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int clusters = 0;
  cudaError_t err;
  if (dtype == 0) {
    err = split_config<float>(cfg, attr, 1, B, 1, dh, splits, stages, 0);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          &clusters, (const void*)prefix_split_kernel<float>, &cfg);
  } else if (dtype == 1) {
    err = split_config<__nv_bfloat16>(cfg, attr, 1, B, 1, dh, splits, stages,
                                      0);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          &clusters, (const void*)prefix_split_kernel<__nv_bfloat16>, &cfg);
  } else {
    return -1;
  }
  return err == cudaSuccess ? clusters : -1;
}

// Kernel B: the working-dtype prefix, split in `splits` ranges of `chunk`
// slots (one cluster of `splits` CTAs per (image, head)), `stages` ring
// slots; vec bit 0 when every prefix row is 16-byte aligned, bit 1 when
// every block row is.  dtype: 0 =
// float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
int qaig_prefix_split_attention(const void* q, const void* k_shared,
                                const void* v_shared, const void* k_block,
                                const void* v_block, void* out, int N, int B,
                                int H, int dh, int S, int bw, int index0,
                                int block_index, int splits, int chunk,
                                int stages, int vec, int dtype,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > kMaxSplits || stages < 1 ||
      stages > kMaxStages || chunk < 1 ||
      (splits - 1) * chunk >= (index0 > 0 ? index0 : 1) ||
      (long long)splits * chunk < index0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_split<float>(q, k_shared, v_shared, k_block, v_block, out,
                               N, B, H, dh, S, bw, index0, block_index,
                               splits, chunk, stages, vec, st);
  if (dtype == 1)
    return launch_split<__nv_bfloat16>(
        q, k_shared, v_shared, k_block, v_block, out, N, B, H, dh, S, bw,
        index0, block_index, splits, chunk, stages, vec, st);
  return (int)cudaErrorInvalidValue;
}

const char* qaig_decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
