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
// t <= block_index of the (N*B, H, bw, dh) blocks).  Rows are r = head*B + b,
// as in the TPU kernel, and the arithmetic rounds where it does: q is
// pre-scaled by 1/sqrt(dh) and rounded to T; K scales multiply the float32
// scores, V scales the probabilities; each probability is rounded to T
// before its P.V product; the float32 sum is divided by the float32
// denominator (unscaled probabilities).
//
// What bounds it on the H100.  Per step it moves the live prefix K/V
// (2 * N * dh * index0 * H elements, plus 2 * N * index0 * H bf16 scales
// for int8), the blocks and q/out, and does 4 * N * B * H * dh *
// (index0 + block_index + 1) flops: about B / 2 operations per prefix byte
// in bf16, far below the ~295 the tensor cores need.  It is bound by the
// bytes of the prefix.
//
// What the design does about it.  A block covers all H heads of one image,
// so each d-row of a tile of `tile` slots is ONE contiguous run of tile*H
// columns in device memory (a block per (image, head) would read every H-th
// element).  The prefix is read exactly once, slots >= index0 never.  The
// TPU kernel computes all (H*B) x (S*H) cross-head scores and masks away all
// but 1/H of them (one MXU product was cheaper there); here each row
// computes only its own head's columns.  Scores, probabilities and the
// output accumulator stay in shared memory (online softmax across tiles,
// common.cuh's softmax_update).
//
// One block per image gave 8-16 blocks on 132 SMs (0.165 ms at N16
// index0 256, slower than kernel B), so the prefix slots are split into
// `splits` chunks, one block each, and one more block per image takes the
// per-rollout segment (grid N x (splits + 1)).  Each block leaves its
// running max, denominator and unnormalised output per row in a float32
// scratch; a second kernel merges the splits of each row (rescaling by
// exp(m_p - max)) and divides.  The wrapper picks the split count (about two
// blocks per SM) and the tile width (shared memory).  Float32 FMAs only:
// tensor-core products are later work.

#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kCombineThreads = 256;

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return qaig::to_float(qaig::from_float<T>(x));
}

// Block (n, p): prefix slots [p * chunk, min((p + 1) * chunk, index0)) for
// p < splits, the per-rollout segment for p == splits.  Writes, per row r,
// partial[((n * (splits + 1) + p) * HB + r) * (dh + 2) + ...] = m, l, acc.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) flat_partial_kernel(
    const T* __restrict__ q,                    // (N*B, H*dh)
    const P* __restrict__ k_il,                 // (N, dh, S*H)
    const P* __restrict__ v_il,                 // (N, dh, S*H)
    const __nv_bfloat16* __restrict__ k_scale,  // (N, S*H), int8 only
    const __nv_bfloat16* __restrict__ v_scale,  // (N, S*H), int8 only
    const T* __restrict__ k_block,              // (N*B, H, bw, dh)
    const T* __restrict__ v_block,              // (N*B, H, bw, dh)
    float* __restrict__ partial,                // (N, splits+1, HB, dh+2)
    int B, int H, int dh, int S, int bw, int index0, int block_index,
    int tile, int splits, int chunk, float sqrt_dh) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  const int HB = H * B;
  const int QP = dh + 1;      // padded rows: conflict-free reads across rows
  const int TP = tile + 1;
  const int CW = tile * H;    // columns of one slot tile
  const int KP = CW + 1;
  const int SH = S * H;
  extern __shared__ float smem[];
  float* qs = smem;              // HB * QP, pre-scaled queries
  float* acc = qs + HB * QP;     // HB * QP, output accumulator
  float* sc = acc + HB * QP;     // HB * TP, scores then probabilities
  float* m = sc + HB * TP;       // HB, running max
  float* l = m + HB;             // HB, running denominator
  float* alpha = l + HB;         // HB, rescale factor of this tile
  float* kss = alpha + HB;       // CW, K scales of this tile
  float* vss = kss + CW;         // CW, V scales of this tile
  P* ks = reinterpret_cast<P*>(vss + CW);  // dh * KP, prefix K tile
  P* vs = ks + (size_t)dh * KP;            // dh * KP, prefix V tile

  const int tid = threadIdx.x;
  const int n = blockIdx.x;
  const int split = blockIdx.y;
  const bool segment = split == splits;
  const int s_begin = segment ? 0 : min(split * chunk, index0);
  const int s_end = segment ? 0 : min(s_begin + chunk, index0);
  const int D = H * dh;

  for (int i = tid; i < HB * dh; i += kThreads) {
    const int r = i / dh, d = i % dh;
    const int h = r / B, b = r % B;
    qs[r * QP + d] = round_to<T>(
        qaig::to_float(q[(size_t)(n * B + b) * D + h * dh + d]) / sqrt_dh);
    acc[r * QP + d] = 0.f;
  }
  for (int r = tid; r < HB; r += kThreads) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  __syncthreads();

  // ---- this split's prefix slots [s_begin, s_end), each d-row one
  // contiguous run
  const P* kp = k_il + (size_t)n * dh * SH;
  const P* vp = v_il + (size_t)n * dh * SH;
  for (int s0 = s_begin; s0 < s_end; s0 += tile) {
    const int ns = min(tile, s_end - s0);
    const int nc = ns * H;
    const size_t c0 = (size_t)s0 * H;
    for (int i = tid; i < dh * nc; i += kThreads) {
      const int d = i / nc, c = i % nc;
      ks[d * KP + c] = kp[(size_t)d * SH + c0 + c];
      vs[d * KP + c] = vp[(size_t)d * SH + c0 + c];
    }
    if (kQuant) {
      for (int c = tid; c < nc; c += kThreads) {
        kss[c] = __bfloat162float(k_scale[(size_t)n * SH + c0 + c]);
        vss[c] = __bfloat162float(v_scale[(size_t)n * SH + c0 + c]);
      }
    }
    __syncthreads();
    // each row's own head only: lanes run over heads, then rollouts
    for (int i = tid; i < HB * ns; i += kThreads) {
      const int h = i % H, rest = i / H;
      const int b = rest % B, t = rest / B;
      const int r = h * B + b, c = t * H + h;
      const float* qr = qs + r * QP;
      float dot = 0.f;
      for (int d = 0; d < dh; ++d)
        dot += qr[d] * qaig::to_float(ks[d * KP + c]);
      sc[r * TP + t] = kQuant ? dot * kss[c] : dot;
    }
    __syncthreads();
    qaig::softmax_update(sc, TP, ns, HB, m, l, alpha, nullptr);
    __syncthreads();
    for (int i = tid; i < HB * dh; i += kThreads) {
      const int r = i / dh, d = i % dh;
      const int h = r / B;
      const float* pr = sc + r * TP;
      const P* vd = vs + d * KP + h;
      float sum = 0.f;
      for (int t = 0; t < ns; ++t) {
        const float p = kQuant ? pr[t] * vss[t * H + h] : pr[t];
        sum += round_to<T>(p) * qaig::to_float(vd[t * H]);
      }
      acc[r * QP + d] = acc[r * QP + d] * alpha[r] + sum;
    }
    __syncthreads();
  }

  // ---- per-rollout segment: slots [0, block_index]
  for (int t0 = 0; segment && t0 <= block_index; t0 += tile) {
    const int nt = min(tile, block_index + 1 - t0);
    for (int i = tid; i < HB * nt; i += kThreads) {
      const int r = i / nt, t = i % nt;
      const int h = r / B, b = r % B;
      const T* kr =
          k_block + (((size_t)(n * B + b) * H + h) * bw + t0 + t) * dh;
      const float* qr = qs + r * QP;
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot += qr[d] * qaig::to_float(kr[d]);
      sc[r * TP + t] = dot;
    }
    __syncthreads();
    qaig::softmax_update(sc, TP, nt, HB, m, l, alpha, nullptr);
    __syncthreads();
    for (int i = tid; i < HB * dh; i += kThreads) {
      const int r = i / dh, d = i % dh;
      const int h = r / B, b = r % B;
      const float* pr = sc + r * TP;
      const T* vr =
          v_block + (((size_t)(n * B + b) * H + h) * bw + t0) * dh + d;
      float sum = 0.f;
      for (int t = 0; t < nt; ++t)
        sum += round_to<T>(pr[t]) * qaig::to_float(vr[(size_t)t * dh]);
      acc[r * QP + d] = acc[r * QP + d] * alpha[r] + sum;
    }
    __syncthreads();
  }

  float* part = partial + ((size_t)n * (splits + 1) + split) * HB * (dh + 2);
  for (int i = tid; i < HB * dh; i += kThreads) {
    const int r = i / dh, d = i % dh;
    part[(size_t)r * (dh + 2) + 2 + d] = acc[r * QP + d];
  }
  for (int r = tid; r < HB; r += kThreads) {
    part[(size_t)r * (dh + 2)] = m[r];
    part[(size_t)r * (dh + 2) + 1] = l[r];
  }
}

// Merge the splits of each row: out = sum_p e_p acc_p / sum_p e_p l_p with
// e_p = exp(m_p - max_p m_p).  The segment's split always holds slot 0 of
// the block, so the max is finite; an empty chunk (m = -inf) adds nothing.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads) flat_combine_kernel(
    const float* __restrict__ partial, T* __restrict__ out, int B, int H,
    int dh, int splits) {
  const int HB = H * B;
  const int n = blockIdx.x;
  const float* base = partial + (size_t)n * (splits + 1) * HB * (dh + 2);
  for (int i = threadIdx.x; i < HB * dh; i += kCombineThreads) {
    const int r = i / dh, d = i % dh;
    float mx = -INFINITY;
    for (int p = 0; p <= splits; ++p)
      mx = fmaxf(mx, base[((size_t)p * HB + r) * (dh + 2)]);
    float num = 0.f, den = 0.f;
    for (int p = 0; p <= splits; ++p) {
      const float* row = base + ((size_t)p * HB + r) * (dh + 2);
      const float e = expf(row[0] - mx);
      num += e * row[2 + d];
      den += e * row[1];
    }
    const int h = r / B, b = r % B;
    out[(size_t)(n * B + b) * H * dh + h * dh + d] =
        qaig::from_float<T>(num / den);
  }
}

size_t smem_bytes(int H, int B, int dh, int tile, int prefix_elem_bytes) {
  const size_t hb = (size_t)H * B;
  const size_t floats = 2 * hb * (dh + 1) + hb * (tile + 1) + 3 * hb +
                        2 * (size_t)tile * H;
  return floats * sizeof(float) +
         2 * (size_t)dh * ((size_t)tile * H + 1) * prefix_elem_bytes;
}

template <typename T, typename P>
cudaError_t launch(const void* q, const void* k_il, const void* v_il,
                   const void* k_scale, const void* v_scale,
                   const void* k_block, const void* v_block, void* out,
                   void* partial, int N, int B, int H, int dh, int S, int bw,
                   int index0, int block_index, int tile, int splits,
                   int chunk, float sqrt_dh, cudaStream_t stream) {
  auto kernel = flat_partial_kernel<T, P>;
  const size_t smem = smem_bytes(H, B, dh, tile, sizeof(P));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(N, splits + 1), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_il),
      static_cast<const P*>(v_il),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const T*>(k_block), static_cast<const T*>(v_block),
      static_cast<float*>(partial), B, H, dh, S, bw, index0, block_index,
      tile, splits, chunk, sqrt_dh);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flat_combine_kernel<T><<<N, kCombineThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(out), B, H, dh,
      splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one launch needs at this tile width (the wrapper picks the
// widest tile that fits the card's 227 KB per block).
size_t qaig_flat_attention_smem(int H, int B, int dh, int tile,
                                int prefix_elem_bytes) {
  return smem_bytes(H, B, dh, tile, prefix_elem_bytes);
}

// dtype: 0 = float32, 1 = bfloat16 (q, blocks, out; and the prefix unless
// prefix_int8).  S is the number of slots of the interleaved caches (their
// last dim is S*H).  partial: float32 scratch of N * (splits + 1) * H * B *
// (dh + 2) values; the prefix is cut into `splits` chunks of `chunk` slots.
// Returns the cudaError_t of the two launches.
int qaig_flat_attention(const void* q, const void* k_il, const void* v_il,
                        const void* k_scale, const void* v_scale,
                        const void* k_block, const void* v_block, void* out,
                        void* partial, int N, int B, int H, int dh, int S,
                        int bw, int index0, int block_index, int tile,
                        int splits, int chunk, int dtype, int prefix_int8,
                        float sqrt_dh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !prefix_int8)
    return launch<float, float>(q, k_il, v_il, k_scale, v_scale, k_block,
                                v_block, out, partial, N, B, H, dh, S, bw,
                                index0, block_index, tile, splits, chunk,
                                sqrt_dh, st);
  if (dtype == 1 && !prefix_int8)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_il, v_il, k_scale, v_scale, k_block, v_block, out, partial, N,
        B, H, dh, S, bw, index0, block_index, tile, splits, chunk, sqrt_dh,
        st);
  if (dtype == 0 && prefix_int8)
    return launch<float, int8_t>(q, k_il, v_il, k_scale, v_scale, k_block,
                                 v_block, out, partial, N, B, H, dh, S, bw,
                                 index0, block_index, tile, splits, chunk,
                                 sqrt_dh, st);
  if (dtype == 1 && prefix_int8)
    return launch<__nv_bfloat16, int8_t>(
        q, k_il, v_il, k_scale, v_scale, k_block, v_block, out, partial, N,
        B, H, dh, S, bw, index0, block_index, tile, splits, chunk, sqrt_dh,
        st);
  return (int)cudaErrorInvalidValue;
}

const char* qaig_decode_attention_flat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
