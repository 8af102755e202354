// Shared-prefix rollout decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernels of qaig_tpu/ops/decode_attention.py:
//   * shared_prefix_attention_fused_t    (bf16 prefix; _kernel_t_bf16,
//                                          _head_attention): kernel B;
//   * shared_prefix_attention_fused_int8 (int8 prefix + per-slot bf16 scales;
//                                          _kernel_t_int8): kernel C.
// Both are prefix_split_kernel below, templated on the prefix element type
// P: the working type T (B) or int8_t (C).
//
// Function.  For image n, its B rollouts (rows n*B .. n*B+B-1 of q) attend in
// ONE float32 softmax over the image's shared prefix (slots s < index0 of the
// (N, H, dh, S) caches) and over their own segment (slots t <= block_index of
// the (N*B, H, bw, dh) blocks).  For the int8 prefix the per-slot scales fold
// into the scores (K) and the probabilities (V), and the denominator sums
// the unscaled probabilities; no dequantized prefix is ever written.
//
// What bounds it on the H100.  Per step the kernel moves the live prefix K/V
// (2 * N * H * dh * index0 elements, plus 2 * N * H * index0 bf16 scales for
// int8) plus the blocks and q/out, and does 4 * N * B * H * dh * (index0 +
// block_index + 1) flops: about B / 2 operations per prefix byte in bf16
// (B per byte in int8), far below the ~295 the tensor cores need to be the
// limit, and under the ~20 of the float32 FMAs.  It is bound by the bytes
// of the prefix.
//
// Flash-decoding inside one launch, on thread block clusters.  Each (image,
// head) prefix is cut into `splits` (1 or 2) contiguous slot ranges, chosen
// by the wrapper (decode_attention.launch_plan) so that the card's SMs are
// filled, and one cluster of `splits` CTAs takes the (image, head): CTA
// rank r streams range r in 64-slot tiles (from the range's start rounded
// down to a 16-byte chunk, the slots before it masked) through a ring of two
// shared-memory slots filled by 16-byte cp.async copies (the next tile
// lands while this one is used; an int8 tile carries its 64 K or V scales
// in the same slot), and keeps a partial max, sum and B x dh accumulator
// (online softmax, base 2) for every rollout; the segment's chunks (whole
// block rows of every rollout) are dealt to the ranks in turn through the
// same ring.  A ring slot is counted in bytes, so that an int8 prefix tile
// and a segment chunk of T share it.  Scores run as 4-rollout register
// blocks (one K slot pair a lane, a float4 of 4 rollouts' q a read), with
// the head dim split across warps when B is small so that all 8 warps work;
// P V reads each V row as 16-byte vectors (8 bf16, 4 float32 or 16 int8
// slots) for up to 8 rollouts.  After a cluster barrier the CTAs combine the
// partials through distributed shared memory in fixed rank order, each rank
// writing a disjoint slice of the B x dh outputs: the result is
// deterministic, and needs no global scratch and no second launch.  The
// arithmetic is exact float32 FMAs (exp2f for the softmax).

#include "common.cuh"

#include <cooperative_groups.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
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

// A ring slot holds a K and a V part of `part_bytes` bytes each: a prefix
// tile (dh rows of kSlots slots of `pelem` bytes, pitch kSlots + one 16-byte
// chunk, so 8 rows of 16-byte reads hit distinct bank groups; with an int8
// prefix the tile's kSlots bf16 scales follow) or a segment chunk (rows
// (b, t) of dh elements of `elem` bytes, pitch dh + one 16-byte chunk),
// rounded up to 16 bytes.
__host__ __device__ inline size_t part_bytes(int B, int dh, int elem,
                                             int pelem) {
  const size_t prefix = (size_t)dh * (kSlots * pelem + 16) +
                        (pelem == 1 ? 2 * kSlots : 0);
  const size_t seg = (size_t)B * (dh * elem + 16);
  return ((prefix > seg ? prefix : seg) + 15) / 16 * 16;
}

// segment slots a chunk holds for all B rollouts (at least 1)
__host__ __device__ inline int seg_chunk(int B, int dh, int elem, int pelem) {
  const size_t t =
      part_bytes(B, dh, elem, pelem) / ((size_t)B * (dh * elem + 16));
  return t < kSlots ? (int)t : kSlots;
}

__host__ __device__ inline size_t split_smem(int B, int dh, int elem,
                                             int pelem, int stages) {
  return split_floats(B, dh) * 4 +
         (size_t)stages * 2 * part_bytes(B, dh, elem, pelem);
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
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
__device__ __forceinline__ void load_vec(const int8_t* p, float (&x)[16]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)  // byte j, sign-extended
      x[4 * i + j] =
          static_cast<float>(static_cast<int32_t>(w[i] << (24 - 8 * j)) >> 24);
}

// Scores of one prefix tile, base 2: unit u of (4-rollout group, dims
// part) per warp, lane l on slots 2l and 2l + 1; part p's partial sums go
// to strip p.  Rollouts past B have q = 0.
template <typename P>
__device__ __forceinline__ void prefix_scores(const P* kt, const float* qsT,
                                              float* sc, int b4, int dh,
                                              int parts, int ns) {
  constexpr int kPitch = kSlots + 16 / sizeof(P);
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

// Online-softmax step of rows b < B over columns [c_lo, ncols) of the score
// strips (the sum of `parts` partials, added in part order): one warp per
// row, two columns a lane; the probabilities replace strip 0's row.  With
// kQuant, the summed score is multiplied by its slot's K scale, and the
// stored probability by its V scale (the denominator sums the unscaled
// ones).
template <bool kQuant>
__device__ __forceinline__ void softmax_rows(float* sc, int parts, int b4,
                                             int B, int c_lo, int ncols,
                                             float* m,
                                             float* l, float* alpha,
                                             const __nv_bfloat16* kss,
                                             const __nv_bfloat16* vss) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < B; b += kThreads / 32) {
    float x[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 2 * lane + j;
      float v = 0.f;
      for (int p = 0; p < parts; ++p)
        v += sc[(size_t)(p * b4 + b) * kSlots + c];
      if (kQuant) v *= __bfloat162float(kss[c]);
      x[j] = c >= c_lo && c < ncols ? v : -INFINITY;
    }
    const float mx = qaig::warp_max(fmaxf(x[0], x[1]));
    const float m_old = m[b];
    const float m_new = fmaxf(m_old, mx);
    const float mu = m_new == -INFINITY ? 0.f : m_new;
    const float p0 = exp2f(x[0] - mu), p1 = exp2f(x[1] - mu);
    float2 pv = make_float2(p0, p1);
    if (kQuant) {
      pv.x *= __bfloat162float(vss[2 * lane]);
      pv.y *= __bfloat162float(vss[2 * lane + 1]);
    }
    *reinterpret_cast<float2*>(sc + (size_t)b * kSlots + 2 * lane) = pv;
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
template <typename P, int R>
__device__ __forceinline__ void prefix_pv(const P* vt, const float* sc,
                                          float* acc, const float* alpha,
                                          int B, int dh, int ns) {
  constexpr int kVec = 16 / sizeof(P);
  constexpr int kPitch = kSlots + kVec;
  const int groups = (B + R - 1) / R;
  for (int i = threadIdx.x; i < dh * groups; i += kThreads) {
    const int d = i % dh, b0 = (i / dh) * R;
    float sum[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sum[r] = 0.f;
    const P* vr = vt + d * kPitch;
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
  softmax_rows<false>(sc, 1, b4, B, 0, nt, m, l, alpha, nullptr, nullptr);
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
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads, 2) prefix_split_kernel(
    const T* __restrict__ q,                    // (N*B, H*dh)
    const P* __restrict__ k_shared,             // (N, H, dh, S)
    const P* __restrict__ v_shared,             // (N, H, dh, S)
    const __nv_bfloat16* __restrict__ k_scale,  // (N, H, S), int8 only
    const __nv_bfloat16* __restrict__ v_scale,  // (N, H, S), int8 only
    const T* __restrict__ k_block,              // (N*B, H, bw, dh)
    const T* __restrict__ v_block,              // (N*B, H, bw, dh)
    T* __restrict__ out,                        // (N*B, H*dh)
    int B, int H, int dh, int S, int bw, int index0, int block_index,
    int chunk, int stages, int vec, float scale_log2) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPVec = 16 / sizeof(P);
  constexpr int kPitch = kSlots + kPVec;
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
  const size_t part = part_bytes(B, dh, sizeof(T), sizeof(P));
  char* ring = reinterpret_cast<char*>(smem4) + split_floats(B, dh) * 4;
  // an int8 tile's scales follow its dh rows
  const size_t scale_at = (size_t)dh * kPitch * sizeof(P);

  // this rank's tiles: prefix slots [lo, hi) in tiles of kSlots from lo
  // rounded down to a 16-byte chunk (the slots before lo masked), then
  // segment chunks rank, rank + splits, ... of the segment's slots
  // [0, block_index] cut in chunks of tc
  const int lo = min(index0, rank * chunk);
  const int hi = min(index0, lo + chunk);
  const int lo_a = lo / kPVec * kPVec;
  const int ptiles = hi > lo ? (hi - lo_a + kSlots - 1) / kSlots : 0;
  const int nseg = block_index + 1;
  const int tc = seg_chunk(B, dh, sizeof(T), sizeof(P));
  const int nchunks = (nseg + tc - 1) / tc;
  const int ntiles = ptiles + max(0, (nchunks - rank + splits - 1) / splits);
  const size_t head = (size_t)n * H + h;
  const P* kp = k_shared + head * dh * S;
  const P* vp = v_shared + head * dh * S;
  auto load = [&](int it) {
    if (it < ntiles) {
      char* kbytes = ring + (size_t)(it % stages) * 2 * part;
      char* vbytes = kbytes + part;
      if (it < ptiles) {
        P* kt = reinterpret_cast<P*>(kbytes);
        P* vt = reinterpret_cast<P*>(vbytes);
        auto* kss = reinterpret_cast<__nv_bfloat16*>(kbytes + scale_at);
        auto* vss = reinterpret_cast<__nv_bfloat16*>(vbytes + scale_at);
        const int s0 = lo_a + it * kSlots;
        const int ns = min(kSlots, hi - s0);  // columns to copy
        if (vec & 1) {  // prefix rows 16-byte aligned: chunks of kPVec slots
          for (int i = tid; i < dh * (kSlots / kPVec); i += kThreads) {
            const int d = i / (kSlots / kPVec);
            const int c = (i % (kSlots / kPVec)) * kPVec;
            const int live = max(0, min(kPVec, ns - c));
            const size_t at = (size_t)d * S + s0 + (live ? c : 0);
            qaig::cp_async_n(kt + d * kPitch + c, kp + at,
                             live * (int)sizeof(P));
            qaig::cp_async_n(vt + d * kPitch + c, vp + at,
                             live * (int)sizeof(P));
          }
          if (kQuant && tid < kSlots / 8) {  // 8 bf16 scales a chunk
            const int c = tid * 8;
            const int live = max(0, min(8, ns - c));
            const size_t at = head * S + s0 + (live ? c : 0);
            qaig::cp_async_n(kss + c, k_scale + at, live * 2);
            qaig::cp_async_n(vss + c, v_scale + at, live * 2);
          }
        } else {
          for (int i = tid; i < dh * kSlots; i += kThreads) {
            const int d = i / kSlots, c = i % kSlots;
            const bool live = c < ns;
            const size_t at = (size_t)d * S + s0 + c;
            kt[d * kPitch + c] = live ? kp[at] : qaig::zero_of<P>();
            vt[d * kPitch + c] = live ? vp[at] : qaig::zero_of<P>();
          }
          if (kQuant) {
            for (int c = tid; c < kSlots; c += kThreads) {
              const bool live = c < ns;
              const size_t at = head * S + s0 + c;
              kss[c] = live ? k_scale[at] : __float2bfloat16(0.f);
              vss[c] = live ? v_scale[at] : __float2bfloat16(0.f);
            }
          }
        }
      } else {
        T* kt = reinterpret_cast<T*>(kbytes);
        T* vt = reinterpret_cast<T*>(vbytes);
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
            qaig::cp_async_n(kt + row * sp + c, k_block + at, 16);
            qaig::cp_async_n(vt + row * sp + c, v_block + at, 16);
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
    const char* kbytes = ring + (size_t)(it % stages) * 2 * part;
    const char* vbytes = kbytes + part;
    if (it < ptiles) {
      const P* kt = reinterpret_cast<const P*>(kbytes);
      const P* vt = reinterpret_cast<const P*>(vbytes);
      // live columns [c_lo, ns) of this tile
      const int s0 = lo_a + it * kSlots;
      const int c_lo = max(0, lo - s0), ns = min(kSlots, hi - s0);
      prefix_scores(kt, qsT, sc, b4, dh, parts, ns);
      __syncthreads();
      softmax_rows<kQuant>(
          sc, parts, b4, B, c_lo, ns, m, l, alpha,
          reinterpret_cast<const __nv_bfloat16*>(kbytes + scale_at),
          reinterpret_cast<const __nv_bfloat16*>(vbytes + scale_at));
      __syncthreads();
      switch (rv) {
        case 1: prefix_pv<P, 1>(vt, sc, acc, alpha, B, dh, ns); break;
        case 2: prefix_pv<P, 2>(vt, sc, acc, alpha, B, dh, ns); break;
        case 4: prefix_pv<P, 4>(vt, sc, acc, alpha, B, dh, ns); break;
        default: prefix_pv<P, 8>(vt, sc, acc, alpha, B, dh, ns); break;
      }
    } else {
      const int t0 = (rank + (it - ptiles) * splits) * tc;
      segment_chunk(reinterpret_cast<const T*>(kbytes),
                    reinterpret_cast<const T*>(vbytes), qsT, sc, acc, m, l,
                    alpha, B, b4, dh, min(tc, nseg - t0));
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

template <typename T, typename P>
cudaError_t split_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                         int N, int B, int H, int dh, int splits, int stages,
                         cudaStream_t stream) {
  auto kernel = prefix_split_kernel<T, P>;
  const size_t smem = split_smem(B, dh, sizeof(T), sizeof(P), stages);
  static bool attributes_set[qaig::kMaxDevices] = {};  // per instantiation
  const cudaError_t set = qaig::once_per_device(attributes_set, [&] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  });
  if (set != cudaSuccess) return set;
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

template <typename T, typename P>
int max_clusters(int B, int dh, int splits, int stages) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int clusters = 0;
  cudaError_t err =
      split_config<T, P>(cfg, attr, 1, B, 1, dh, splits, stages, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(
        &clusters, (const void*)prefix_split_kernel<T, P>, &cfg);
  return err == cudaSuccess ? clusters : -1;
}

template <typename T, typename P>
cudaError_t launch_split(const void* q, const void* k_shared,
                         const void* v_shared, const void* k_scale,
                         const void* v_scale, const void* k_block,
                         const void* v_block, void* out, int N, int B, int H,
                         int dh, int S, int bw, int index0, int block_index,
                         int splits, int chunk, int stages, int vec,
                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      split_config<T, P>(cfg, attr, N, B, H, dh, splits, stages, stream);
  if (err != cudaSuccess) return err;
  const float kLog2e = 1.4426950408889634f;
  err = cudaLaunchKernelEx(
      &cfg, prefix_split_kernel<T, P>, static_cast<const T*>(q),
      static_cast<const P*>(k_shared), static_cast<const P*>(v_shared),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const T*>(k_block), static_cast<const T*>(v_block),
      static_cast<T*>(out), B, H, dh, S, bw, index0, block_index, chunk,
      stages, vec, kLog2e / sqrtf((float)dh));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one CTA: elem = 4 (float32) or 2 (bf16) for q, the
// blocks and out; prefix_elem = elem, or 1 for an int8 prefix.
size_t qaig_prefix_split_smem(int B, int dh, int elem, int prefix_elem,
                              int stages) {
  return split_smem(B, dh, elem, prefix_elem, stages);
}

// Clusters of `splits` CTAs the card holds at once for this shape
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
int qaig_prefix_split_max_clusters(int B, int dh, int dtype, int prefix_int8,
                                   int splits, int stages) {
  if (dtype == 0 && !prefix_int8)
    return max_clusters<float, float>(B, dh, splits, stages);
  if (dtype == 1 && !prefix_int8)
    return max_clusters<__nv_bfloat16, __nv_bfloat16>(B, dh, splits, stages);
  if (dtype == 0 && prefix_int8)
    return max_clusters<float, int8_t>(B, dh, splits, stages);
  if (dtype == 1 && prefix_int8)
    return max_clusters<__nv_bfloat16, int8_t>(B, dh, splits, stages);
  return -1;
}

// Kernels B (prefix_int8 0: the prefix in the working dtype, k_scale and
// v_scale unused) and C (prefix_int8 1: int8 prefix, per-slot bf16 scales
// (N, H, S)): the prefix split in `splits` ranges of `chunk` slots (one
// cluster of `splits` CTAs per (image, head)), `stages` ring slots; vec bit
// 0 when every prefix row (and scale row) is 16-byte aligned, bit 1 when
// every block row is.  dtype: 0 = float32, 1 = bfloat16 (q, blocks, out).
// Returns the cudaError_t of the launch.
int qaig_prefix_split_attention(const void* q, const void* k_shared,
                                const void* v_shared, const void* k_scale,
                                const void* v_scale, const void* k_block,
                                const void* v_block, void* out, int N, int B,
                                int H, int dh, int S, int bw, int index0,
                                int block_index, int splits, int chunk,
                                int stages, int vec, int dtype,
                                int prefix_int8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > kMaxSplits || stages < 1 ||
      stages > kMaxStages || chunk < 1 ||
      (splits - 1) * chunk >= (index0 > 0 ? index0 : 1) ||
      (long long)splits * chunk < index0)
    return (int)cudaErrorInvalidValue;
#define QAIG_SPLIT(T, P)                                                     \
  launch_split<T, P>(q, k_shared, v_shared, k_scale, v_scale, k_block,      \
                     v_block, out, N, B, H, dh, S, bw, index0, block_index, \
                     splits, chunk, stages, vec, st)
  if (dtype == 0 && !prefix_int8) return QAIG_SPLIT(float, float);
  if (dtype == 1 && !prefix_int8)
    return QAIG_SPLIT(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 0 && prefix_int8) return QAIG_SPLIT(float, int8_t);
  if (dtype == 1 && prefix_int8) return QAIG_SPLIT(__nv_bfloat16, int8_t);
#undef QAIG_SPLIT
  return (int)cudaErrorInvalidValue;
}

const char* qaig_decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
