// Shared-prefix rollout decode attention over INTERLEAVED prefix caches, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel qaig_tpu/ops/decode_attention.py::
// shared_prefix_attention_fused_flat (_kernel_flat, bf16 and int8 variants):
// the same function as decode_attention.cu (kernels B and C), over prefix
// caches stored (N, dh, S*H) with column c = slot*H + head, and per-column
// bf16 scales (N, S*H) for an int8 prefix.  One template covers both: the
// prefix element type P is the query type T or int8_t.
//
// Function.  For image n, its B rollouts attend in ONE float32 softmax over
// the shared prefix (slots s < index0) and their own segment (slots
// t <= block_index of the (N*B, H, bw, dh) blocks).  The arithmetic rounds
// where the TPU kernel does: q is pre-scaled by 1/sqrt(dh) and rounded to
// T; K scales multiply the float32 scores, V scales the probabilities; each
// probability is rounded to T before its P.V product; the float32 sum is
// divided by the float32 denominator (unscaled probabilities).
//
// What bounds it on the H100.  Per step it moves the live prefix K/V
// (2 * N * dh * index0 * H elements, plus 2 * N * index0 * H bf16 scales
// for int8), the blocks and q/out, and does 4 * N * B * H * dh *
// (index0 + block_index + 1) flops: about B / 2 operations per prefix byte
// in bf16, far below the ~295 the tensor cores need.  It is bound by the
// bytes of the prefix, and at decode sizes (a few MB) by the latency of
// getting them in flight.
//
// What the design does about it (kernel B's, decode_attention.cu).  One
// launch: each image's prefix slots [0, index0) are cut into `splits` (at
// most 8) contiguous ranges (ops/decode_attention.py::flat_launch_plan),
// one CTA each and one thread block cluster of them per image, and a CTA
// covers all H heads of its image, so that each d-row of a tile of `tile`
// slots is ONE contiguous run of tile*H columns.  The CTA streams its range
// through a ring of two shared-memory slots filled by 16-byte cp.async
// copies (the next tile lands while this one is used; an int8 tile carries
// its column scales in the same slot; every copy of the first two tiles is
// issued before q is read), then takes every `splits`-th chunk of the
// segment (whole block rows of every (rollout, head)) through the same
// ring.  Scores run as register blocks: a lane takes two columns of one
// head (c and c + tile*H/2) and 4 rollouts, so one K element read from
// shared memory serves 4 FMAs, a float4 of q (laid out so that the heads of
// a warp's lanes fall in distinct banks) 8; a warp's lanes read consecutive
// columns, and the head dim is split across warps where the columns alone
// do not fill the 16 warps.  The softmax keeps a running max, sum and
// (rows x dh) accumulator per CTA; P V reads each V element once for 4
// rollouts.  After a cluster barrier the CTAs combine their partial states
// through distributed shared memory in fixed rank order, each writing a
// disjoint slice of the outputs: deterministic, with no global scratch and
// no second launch (faster on the H100, at all but one timed shape, than a
// plain grid whose last CTA per image combines the partials from an
// L2-resident scratch).  Float32 FMAs only: at ~2 operations per byte
// tensor cores buy nothing.

#include "common.cuh"

#include <cooperative_groups.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// 16 warps: one CTA an SM (128 registers a thread), twice the warps of 256
// threads to hide the copies' latency (measured faster at every timed
// shape on the H100)
constexpr int kThreads = 512;
constexpr int kMaxTile = 64;    // slots of a ring tile
constexpr int kMaxSplits = 8;   // CTAs a cluster (the portable size)
constexpr int kMaxStages = 2;

// dims parts of the score products: colwarps x ceil(B / 4) units of 32
// lanes, the head dim split in `parts` (at most 8) so that they fill the
// warps
__host__ __device__ inline int flat_parts(int B, int H, int dh, int tile) {
  const int colwarps = (tile * H / 2 + 31) / 32;
  const int units = colwarps * ((B + 3) / 4);
  int parts = 1;
  while (parts < 8 && units * parts < kThreads / 32 && 2 * parts <= dh)
    parts *= 2;
  return parts;
}

// floats before the ring: q and the accumulator (dh rows of H*B4, pitch
// H*B4 + 4 so that neighbouring dims fall in other banks), the
// score strips (parts x tile x (H*B4 + 4)), m, l, alpha (H*B4 each) and the
// combine's weights (kMaxSplits + 1 rows of H*B4), rounded up to 16 bytes
__host__ __device__ inline size_t flat_floats(int B, int H, int dh,
                                              int tile) {
  const size_t hb4 = (size_t)H * ((B + 3) & ~3);
  const size_t f = 2 * (size_t)dh * (hb4 + 4) +
                   (size_t)flat_parts(B, H, dh, tile) * tile * (hb4 + 4) +
                   (3 + kMaxSplits + 1) * hb4;
  return (f + 3) & ~(size_t)3;
}

// A ring slot holds a K and a V part of this many bytes each: a prefix tile
// (dh rows of tile*H columns of `pelem` bytes, pitch one 16-byte chunk
// more, so that neighbouring rows start in other bank groups; an int8
// tile's tile*H bf16 column scales follow) or a segment chunk (rows
// (b, h, t) of dh elements of `elem` bytes, pitch dh + one 16-byte chunk),
// the larger, rounded up to 16 bytes.
__host__ __device__ inline size_t flat_part_bytes(int B, int H, int dh,
                                                  int tile, int elem,
                                                  int pelem) {
  const size_t cw = (size_t)tile * H;
  const size_t prefix =
      (size_t)dh * (cw * pelem + 16) + (pelem == 1 ? 2 * cw : 0);
  const size_t seg = (size_t)B * H * (dh * elem + 16);
  return ((prefix > seg ? prefix : seg) + 15) / 16 * 16;
}

// segment slots of every (rollout, head) one ring part holds (1 .. tile)
__host__ __device__ inline int flat_seg_chunk(int B, int H, int dh, int tile,
                                              int elem, int pelem) {
  const size_t t = flat_part_bytes(B, H, dh, tile, elem, pelem) /
                   ((size_t)B * H * (dh * elem + 16));
  return t < (size_t)tile ? (int)t : tile;
}

__host__ __device__ inline size_t flat_smem(int B, int H, int dh, int tile,
                                            int elem, int pelem,
                                            int stages) {
  return flat_floats(B, H, dh, tile) * 4 +
         (size_t)stages * 2 * flat_part_bytes(B, H, dh, tile, elem, pelem);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return qaig::to_float(qaig::from_float<T>(x));
}

// Online-softmax step over slots [0, ncols) of the score strips (the sum of
// `parts` partials, in part order; slot s of row ri at s * pitch + ri).
// Four rows a warp, eight lanes a row (slots sub, sub + 8, ...), so that a
// warp's reads fall in distinct banks.  With kQuant the summed score is
// multiplied by its column's K scale and the probability by its V scale;
// the denominator sums the unscaled probabilities.  The probabilities,
// rounded to T, replace strip 0.
template <typename T, bool kQuant>
__device__ __forceinline__ void flat_softmax(float* sc, int parts,
                                             size_t strip, int pitch, int B,
                                             int H, int ncols, float* m,
                                             float* l, float* alpha,
                                             const __nv_bfloat16* kss,
                                             const __nv_bfloat16* vss) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hb4 = pitch - 4;
  const int sub = lane >> 2;
  for (int r0 = 0; r0 < hb4; r0 += 4 * (kThreads / 32)) {
    const int ri = r0 + warp * 4 + (lane & 3);
    const bool row = ri < hb4;
    const int h = row ? (ri >> 2) % H : 0;
    float x[kMaxTile / 8];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxTile / 8; ++k) {
      const int s = sub + 8 * k;
      float v = -INFINITY;
      if (row && s < ncols) {
        v = 0.f;
        for (int p = 0; p < parts; ++p) v += sc[p * strip + s * pitch + ri];
        if (kQuant) v *= __bfloat162float(kss[s * H + h]);
      }
      x[k] = v;
      mx = fmaxf(mx, v);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_old = row ? m[ri] : -INFINITY;
    const float m_new = fmaxf(m_old, mx);
    // a row with no live key so far keeps p = 0 instead of exp(-inf + inf)
    const float mu = m_new == -INFINITY ? 0.f : m_new;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxTile / 8; ++k) {
      const int s = sub + 8 * k;
      if (row && s < ncols) {
        const float p = expf(x[k] - mu);
        sum += p;
        sc[s * pitch + ri] =
            round_to<T>(kQuant ? p * __bfloat162float(vss[s * H + h]) : p);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
    if (row && sub == 0) {
      const float a = expf(m_old - mu);
      alpha[ri] = a;
      l[ri] = l[ri] * a + sum;
      m[ri] = m_new;
    }
  }
}

// Row ri of (head h, rollout b): rollouts in groups of 4, the heads of a
// group side by side, so that a warp's lanes on consecutive heads read
// consecutive float4s.
__device__ __forceinline__ int row_of(int h, int b, int H) {
  return (b >> 2) * H * 4 + h * 4 + (b & 3);
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads, 1) flat_split_kernel(
    const T* __restrict__ q,                    // (N*B, H*dh)
    const P* __restrict__ k_il,                 // (N, dh, S*H)
    const P* __restrict__ v_il,                 // (N, dh, S*H)
    const __nv_bfloat16* __restrict__ k_scale,  // (N, S*H), int8 only
    const __nv_bfloat16* __restrict__ v_scale,  // (N, S*H), int8 only
    const T* __restrict__ k_block,              // (N*B, H, bw, dh)
    const T* __restrict__ v_block,              // (N*B, H, bw, dh)
    T* __restrict__ out,                        // (N*B, H*dh)
    int B, int bc, int H, int dh, int S, int bw, int index0, int block_index,
    int splits, int chunk, int tile, int tc, int stages, int vec,
    float sqrt_dh) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPVec = 16 / sizeof(P);
  const int n = blockIdx.x / splits, rank = blockIdx.x % splits;
  // rollouts [b0, b0 + Bl) of the image (grid y: groups of bc rollouts)
  const int b0 = blockIdx.y * bc, Bl = min(bc, B - b0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b4 = (bc + 3) & ~3, G = b4 / 4, hb4 = H * b4;
  const int CW = tile * H;
  const int kp = CW + kPVec;  // prefix tile pitch, elements of P
  const int SH = S * H;
  const int D = H * dh;
  const int parts = flat_parts(bc, H, dh, tile);
  const int pitch = hb4 + 4;
  const size_t strip = (size_t)tile * pitch;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // dh x pitch, pre-scaled
  float* acc = qs + (size_t)dh * pitch;         // dh x pitch
  float* sc = acc + (size_t)dh * pitch;         // parts x tile x pitch
  float* m = sc + parts * strip;
  float* l = m + hb4;
  float* alpha = l + hb4;
  float* wts = alpha + hb4;  // (kMaxSplits + 1) x hb4
  const size_t part =
      flat_part_bytes(bc, H, dh, tile, sizeof(T), sizeof(P));
  char* ring =
      reinterpret_cast<char*>(smem4) + flat_floats(bc, H, dh, tile) * 4;
  const size_t scale_at = (size_t)dh * kp * sizeof(P);

  // this rank's tiles: prefix slots [lo, hi) in tiles of `tile`, then
  // segment chunks rank, rank + splits, ... of the segment's slots
  // [0, block_index] cut in chunks of tc
  const int lo = min(index0, rank * chunk);
  const int hi = min(index0, lo + chunk);
  const int ptiles = (hi - lo + tile - 1) / tile;
  const int nseg = block_index + 1;
  const int nchunks = (nseg + tc - 1) / tc;
  const int ntiles = ptiles + max(0, (nchunks - rank + splits - 1) / splits);
  const P* kpn = k_il + (size_t)n * dh * SH;
  const P* vpn = v_il + (size_t)n * dh * SH;
  auto load = [&](int it) {
    if (it < ntiles) {
      char* kbytes = ring + (size_t)(it % stages) * 2 * part;
      char* vbytes = kbytes + part;
      if (it < ptiles) {
        P* kt = reinterpret_cast<P*>(kbytes);
        P* vt = reinterpret_cast<P*>(vbytes);
        __nv_bfloat16* kss =
            reinterpret_cast<__nv_bfloat16*>(kbytes + scale_at);
        __nv_bfloat16* vss =
            reinterpret_cast<__nv_bfloat16*>(vbytes + scale_at);
        const int s0 = lo + it * tile;
        const int nc = min(tile, hi - s0) * H;  // live columns
        const size_t c0 = (size_t)s0 * H;
        if (vec & 1) {  // rows 16-byte aligned: chunks of kPVec columns
          const int cpr = CW / kPVec;
          for (int i = tid; i < dh * cpr; i += kThreads) {
            const int d = i / cpr, c = (i % cpr) * kPVec;
            const int live = max(0, min(kPVec, nc - c));
            const size_t at = (size_t)d * SH + c0 + (live ? c : 0);
            qaig::cp_async_n(kt + d * kp + c, kpn + at,
                             live * (int)sizeof(P));
            qaig::cp_async_n(vt + d * kp + c, vpn + at,
                             live * (int)sizeof(P));
          }
          if (kQuant) {  // 8 bf16 scales a chunk
            for (int c = tid * 8; c < CW; c += kThreads * 8) {
              const int live = max(0, min(8, nc - c));
              const size_t at = (size_t)n * SH + c0 + (live ? c : 0);
              qaig::cp_async_n(kss + c, k_scale + at, live * 2);
              qaig::cp_async_n(vss + c, v_scale + at, live * 2);
            }
          }
        } else {
          for (int i = tid; i < dh * CW; i += kThreads) {
            const int d = i / CW, c = i % CW;
            const bool live = c < nc;
            const size_t at = (size_t)d * SH + c0 + c;
            kt[d * kp + c] = live ? kpn[at] : qaig::zero_of<P>();
            vt[d * kp + c] = live ? vpn[at] : qaig::zero_of<P>();
          }
          if (kQuant) {
            for (int c = tid; c < CW; c += kThreads) {
              const bool live = c < nc;
              const size_t at = (size_t)n * SH + c0 + c;
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
        // row (b * H + h) * nt + t: slot t0 + t of (rollout b, head h)
        const size_t bh0 = ((size_t)n * B + b0) * H;
        if (vec & 2) {  // whole block rows as 16-byte chunks
          const int per = dh / kVec;
          for (int i = tid; i < Bl * H * nt * per; i += kThreads) {
            const int row = i / per, c = (i % per) * kVec;
            const size_t at =
                ((bh0 + row / nt) * bw + t0 + row % nt) * dh + c;
            qaig::cp_async_n(kt + row * sp + c, k_block + at, 16);
            qaig::cp_async_n(vt + row * sp + c, v_block + at, 16);
          }
        } else {
          for (int i = tid; i < Bl * H * nt * dh; i += kThreads) {
            const int row = i / dh, c = i % dh;
            const size_t at =
                ((bh0 + row / nt) * bw + t0 + row % nt) * dh + c;
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

  // q's loads in flight together
#pragma unroll 4
  for (int i = tid; i < hb4 * dh; i += kThreads) {
    const int r = i / dh, d = i % dh;  // r = h * b4 + b
    const int h = r / b4, b = r % b4;
    const size_t at = (size_t)(n * B + b0 + b) * D + h * dh + d;
    qs[d * pitch + row_of(h, b, H)] =
        b < Bl ? round_to<T>(qaig::to_float(q[at]) / sqrt_dh) : 0.f;
  }
  for (int i = tid; i < pitch * dh; i += kThreads) acc[i] = 0.f;
  for (int r = tid; r < hb4; r += kThreads) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

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
      const int ns = min(tile, hi - (lo + it * tile));
      // scores of the live slots: unit (column warp, rollout group, dims
      // part) a warp; the lane on columns c and c + CWh (slots s and
      // s + half, head h)
      const int half = (ns + 1) / 2, CWh = half * H;
      const int colwarps = (CWh + 31) / 32;
      const int per = (dh + parts - 1) / parts;
      for (int u = warp; u < colwarps * G * parts; u += kThreads / 32) {
        const int cwp = u / (G * parts), g = (u / parts) % G, p = u % parts;
        const int c = cwp * 32 + lane;
        if (c < CWh) {
          const int h = c % H, s = c / H;
          const float* qg = qs + g * H * 4 + h * 4;
          float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
          const int d1 = min(dh, (p + 1) * per);
#pragma unroll 4
          for (int d = p * per; d < d1; ++d) {
            const float k0 = qaig::to_float(kt[d * kp + c]);
            const float k1 = qaig::to_float(kt[d * kp + c + CWh]);
            const float4 qq =
                *reinterpret_cast<const float4*>(qg + d * pitch);
            s0[0] = fmaf(qq.x, k0, s0[0]); s1[0] = fmaf(qq.x, k1, s1[0]);
            s0[1] = fmaf(qq.y, k0, s0[1]); s1[1] = fmaf(qq.y, k1, s1[1]);
            s0[2] = fmaf(qq.z, k0, s0[2]); s1[2] = fmaf(qq.z, k1, s1[2]);
            s0[3] = fmaf(qq.w, k0, s0[3]); s1[3] = fmaf(qq.w, k1, s1[3]);
          }
          float* dst = sc + p * strip + g * H * 4 + h * 4;
          *reinterpret_cast<float4*>(dst + (size_t)s * pitch) =
              make_float4(s0[0], s0[1], s0[2], s0[3]);
          *reinterpret_cast<float4*>(dst + (size_t)(s + half) * pitch) =
              make_float4(s1[0], s1[1], s1[2], s1[3]);
        }
      }
      __syncthreads();
      flat_softmax<T, kQuant>(
          sc, parts, strip, pitch, B, H, ns, m, l, alpha,
          reinterpret_cast<const __nv_bfloat16*>(kbytes + scale_at),
          reinterpret_cast<const __nv_bfloat16*>(vbytes + scale_at));
      __syncthreads();
      // P V: item (head h, dim d, rollout group g); V[d][s * H + h] read
      // once for 4 rollouts
      for (int i = tid; i < H * dh * G; i += kThreads) {
        const int h = i % H, d = (i / H) % dh, g = i / (H * dh);
        const int r0 = g * H * 4 + h * 4;
        const P* vr = vt + d * kp + h;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
        for (int s = 0; s < ns; ++s) {
          const float v = qaig::to_float(vr[s * H]);
          const float4 p =
              *reinterpret_cast<const float4*>(sc + s * pitch + r0);
          a0 = fmaf(p.x, v, a0);
          a1 = fmaf(p.y, v, a1);
          a2 = fmaf(p.z, v, a2);
          a3 = fmaf(p.w, v, a3);
        }
        float4* a = reinterpret_cast<float4*>(acc + (size_t)d * pitch + r0);
        const float4 al = *reinterpret_cast<const float4*>(alpha + r0);
        float4 o = *a;
        o.x = fmaf(o.x, al.x, a0);
        o.y = fmaf(o.y, al.y, a1);
        o.z = fmaf(o.z, al.z, a2);
        o.w = fmaf(o.w, al.w, a3);
        *a = o;
      }
    } else {
      const T* kt = reinterpret_cast<const T*>(kbytes);
      const T* vt = reinterpret_cast<const T*>(vbytes);
      const int t0 = (rank + (it - ptiles) * splits) * tc;
      const int nt = min(tc, nseg - t0);
      const int sp = dh + kVec;
      const int rows = Bl * H * nt;
      // scores: four lanes a row (b * H + h) * nt + t
      for (int base = 0; base < rows * 4; base += kThreads) {
        const int idx = base + tid, row = idx >> 2, quarter = idx & 3;
        const bool live = row < rows;
        const int bh = live ? row / nt : 0, t = live ? row % nt : 0;
        const int ri = row_of(bh % H, bh / H, H);
        float dot = 0.f;
        if (live) {
          const T* kr = kt + (size_t)row * sp;
          for (int d = quarter; d < dh; d += 4)
            dot = fmaf(qs[d * pitch + ri], qaig::to_float(kr[d]), dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (live && quarter == 0) sc[t * pitch + ri] = dot;
      }
      __syncthreads();
      flat_softmax<T, false>(sc, 1, strip, pitch, B, H, nt, m, l, alpha,
                             nullptr, nullptr);
      __syncthreads();
      // P V: one thread a (row, dim), dims across lanes: a V row read
      // as one run, its probability broadcast
      for (int i = tid; i < Bl * H * dh; i += kThreads) {
        const int bh = i / dh, d = i % dh;
        const int ri = row_of(bh % H, bh / H, H);
        const T* vr = vt + (size_t)bh * nt * sp + d;
        float sum = 0.f;
        for (int t = 0; t < nt; ++t)
          sum = fmaf(sc[t * pitch + ri], qaig::to_float(vr[(size_t)t * sp]),
                     sum);
        float* a = acc + (size_t)d * pitch + ri;
        *a = *a * alpha[ri] + sum;
      }
    }
    __syncthreads();  // this slot's reads are done before it is refilled
    load(it + stages);
  }
  qaig::cp_async_wait<0>();
  __syncthreads();

  // ---- combine the ranks' partials in rank order through distributed
  // shared memory: first each row's weights e^(m_r - M) and denominator
  // L (every rank computes all rows), then rank r writes
  // outputs e = (b, h, d) in [r * per, (r + 1) * per)
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int ri = tid; ri < hb4; ri += kThreads) {
    float mr[kMaxSplits], lr[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) {
        mr[r] = cluster.map_shared_rank(m, r)[ri];
        lr[r] = cluster.map_shared_rank(l, r)[ri];
      }
    }
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits) M = fmaxf(M, mr[r]);
    float L = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) {
        const float w = mr[r] == -INFINITY ? 0.f : expf(mr[r] - M);
        wts[r * hb4 + ri] = w;
        L = fmaf(lr[r], w, L);
      }
    }
    wts[kMaxSplits * hb4 + ri] = L;
  }
  __syncthreads();
  const int E = Bl * H * dh;
  T* outg = out + ((size_t)n * B + b0) * D;
  const int per = (E + splits - 1) / splits;
  const int e1 = min(E, (rank + 1) * per);
#pragma unroll 2
  for (int e = rank * per + tid; e < e1; e += kThreads) {
    const int d = e % dh, ri = row_of((e / dh) % H, e / D, H);
    float ar[kMaxSplits];  // every rank's read in flight at once
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits)
        ar[r] = cluster.map_shared_rank(acc, r)[(size_t)d * pitch + ri];
    float O = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits) O = fmaf(ar[r], wts[r * hb4 + ri], O);
    outg[e] = qaig::from_float<T>(O / wts[kMaxSplits * hb4 + ri]);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

template <typename T, typename P>
cudaError_t flat_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                        int N, int B, int bc, int H, int dh, int tile,
                        int splits, int stages, cudaStream_t stream) {
  auto kernel = flat_split_kernel<T, P>;
  static bool attributes_set[qaig::kMaxDevices] = {};  // per instantiation
  const cudaError_t set = qaig::once_per_device(attributes_set, [&] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  });
  if (set != cudaSuccess) return set;
  cfg = {};
  cfg.gridDim = dim3((unsigned)N * splits, (unsigned)((B + bc - 1) / bc));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = flat_smem(bc, H, dh, tile, sizeof(T), sizeof(P),
                                   stages);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// clusters of `splits` CTAs the card holds at once, or -1 on an error
template <typename T, typename P>
int max_clusters(int bc, int H, int dh, int tile, int splits, int stages) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = flat_config<T, P>(cfg, attr, 1, bc, bc, H, dh, tile,
                                      splits, stages, 0);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(
        &clusters, (const void*)flat_split_kernel<T, P>, &cfg);
  return err == cudaSuccess ? clusters : -1;
}

template <typename T, typename P>
cudaError_t launch(const void* q, const void* k_il, const void* v_il,
                   const void* k_scale, const void* v_scale,
                   const void* k_block, const void* v_block, void* out, int N,
                   int B, int bc, int H, int dh, int S, int bw, int index0,
                   int block_index, int splits, int chunk, int tile,
                   int stages, int vec, float sqrt_dh, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = flat_config<T, P>(cfg, attr, N, B, bc, H, dh, tile,
                                      splits, stages, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &cfg, flat_split_kernel<T, P>, static_cast<const T*>(q),
      static_cast<const P*>(k_il), static_cast<const P*>(v_il),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const T*>(k_block), static_cast<const T*>(v_block),
      static_cast<T*>(out), B, bc, H, dh, S, bw, index0, block_index, splits,
      chunk, tile, flat_seg_chunk(bc, H, dh, tile, sizeof(T), sizeof(P)),
      stages, vec, sqrt_dh);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one CTA of `bc` rollouts: elem = 4 (float32) or 2 (bf16)
// for q, the blocks and out; prefix_elem = elem, or 1 for an int8 prefix.
size_t qaig_flat_attention_smem(int bc, int H, int dh, int tile, int elem,
                                int prefix_elem, int stages) {
  return flat_smem(bc, H, dh, tile, elem, prefix_elem, stages);
}

// Clusters of `splits` CTAs the card holds at once
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
int qaig_flat_attention_max_clusters(int bc, int H, int dh, int tile,
                                     int dtype, int prefix_int8, int splits,
                                     int stages) {
  if (dtype == 0 && !prefix_int8)
    return max_clusters<float, float>(bc, H, dh, tile, splits, stages);
  if (dtype == 1 && !prefix_int8)
    return max_clusters<__nv_bfloat16, __nv_bfloat16>(bc, H, dh, tile,
                                                      splits, stages);
  if (dtype == 0 && prefix_int8)
    return max_clusters<float, int8_t>(bc, H, dh, tile, splits, stages);
  if (dtype == 1 && prefix_int8)
    return max_clusters<__nv_bfloat16, int8_t>(bc, H, dh, tile, splits,
                                               stages);
  return -1;
}

// dtype: 0 = float32, 1 = bfloat16 (q, blocks, out; and the prefix unless
// prefix_int8).  S is the number of slots of the interleaved caches (their
// last dim is S*H).  The prefix is cut into `splits` ranges of `chunk`
// slots, one CTA each and one cluster of them per image, streamed in tiles
// of `tile` slots through `stages` ring slots; vec bit 0 when every prefix
// row (and scale row) is 16-byte aligned, bit 1 when every block row is.  A
// CTA takes `bc` of the B rollouts (grid y: ceil(B / bc) groups; bc < B
// only where one CTA's shared memory cannot hold them all).  Returns the
// cudaError_t of the launch.
int qaig_flat_attention(const void* q, const void* k_il, const void* v_il,
                        const void* k_scale, const void* v_scale,
                        const void* k_block, const void* v_block, void* out,
                        int N, int B, int bc, int H, int dh, int S, int bw,
                        int index0, int block_index, int splits, int chunk,
                        int tile, int stages, int vec, int dtype,
                        int prefix_int8, float sqrt_dh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > kMaxSplits || bc < 1 || bc > B || stages < 1 ||
      stages > kMaxStages || tile < 2 || tile % 2 || tile > kMaxTile ||
      chunk < 1 || (splits - 1) * chunk >= (index0 > 0 ? index0 : 1) ||
      (long long)splits * chunk < index0)
    return (int)cudaErrorInvalidValue;
#define QAIG_FLAT(T, P)                                                       \
  launch<T, P>(q, k_il, v_il, k_scale, v_scale, k_block, v_block, out, N, B,  \
               bc, H, dh, S, bw, index0, block_index, splits, chunk, tile,    \
               stages, vec, sqrt_dh, st)
  if (dtype == 0 && !prefix_int8) return QAIG_FLAT(float, float);
  if (dtype == 1 && !prefix_int8)
    return QAIG_FLAT(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 0 && prefix_int8) return QAIG_FLAT(float, int8_t);
  if (dtype == 1 && prefix_int8) return QAIG_FLAT(__nv_bfloat16, int8_t);
#undef QAIG_FLAT
  return (int)cudaErrorInvalidValue;
}

const char* qaig_decode_attention_flat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
