// Helpers shared by the port's attention kernels: element conversions,
// warp reductions, and the tensor-core and asynchronous-copy primitives.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace qaig {

// A kernel's attributes (its dynamic shared memory cap above 48 KB) live in
// each device's own context, so "set once" means once per device: a launch
// on a second card of the process needs a call of its own there.  `done`
// holds one flag per device index; a device past the table sets the
// attribute at every launch.
constexpr int kMaxDevices = 64;

template <typename Set>
inline cudaError_t once_per_device(bool (&done)[kMaxDevices], Set set) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool tracked = device >= 0 && device < kMaxDevices;
  if (tracked && done[device]) return cudaSuccess;
  err = set();
  if (err == cudaSuccess && tracked) done[device] = true;
  return err;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// a zero of an element type (T, or the int8 of a quantized prefix)
template <typename P>
__device__ __forceinline__ P zero_of() {
  return from_float<P>(0.f);
}
template <>
__device__ __forceinline__ int8_t zero_of<int8_t>() {
  return 0;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int offset = 16; offset > 0; offset >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, offset));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int offset = 16; offset > 0; offset >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

// 2^x in one instruction (relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// mma.sync fragments (PTX ISA, "Matrix fragments for mma.m16n8k16"): with
// g = lane / 4 and t = lane % 4, a 16 x 8 float accumulator d holds
// (row g, cols 2t, 2t+1) in d[0..1] and (row g+8, the same cols) in d[2..3];
// A (16 x 16, row-major) holds those rows at cols 2t.. and 2t+8..; B (16 x 8,
// "col") holds rows 2t, 2t+1 and 2t+8, 2t+9 of col g.

// d += a (16 x 8, row) . b (8 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_16x8x8(float (&d)[4], uint32_t a0,
                                           uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_16x8x16(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: lane i names row i % 8 of 8x8 matrix i / 8 (16 bytes each) and
// receives (row lane / 4, cols 2 (lane % 4), +1) of every matrix, or with
// .trans (rows 2 (lane % 4), +1, col lane / 4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// .x2 reads the addresses of lanes 0-15 only
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// 16-byte asynchronous copy global -> shared; with live false the 16 bytes
// are zero-filled (src is not read, but must be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

// 16-byte asynchronous copy of which the first `bytes` (0-16) are read and
// the rest zeroed (src must be a valid, 16-byte aligned address)
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `n` of this thread's newest copy groups are pending
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

}  // namespace qaig
