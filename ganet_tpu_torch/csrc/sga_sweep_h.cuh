// The step of an SGA forward sweep along H, shared by K1 (sga_fwd.cu) and
// K5 (sga_fwd_seeded.cu): a column's carry in f32 registers over G lanes of
// a warp, B bins a lane, the max over d by shuffles, the `cp.async`
// helpers that stage a warp's steps into its own ring of shared memory,
// and the plan of a launch.  See sga_fwd.cu's header for the design.
//
// `_build._lib_path` hashes this header into the name of every library
// whose source includes it, so an edit here rebuilds K1 and K5 both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCopy = 16;     // bytes of one copy along H, at most

// Bytes of one copy along H: 16, or a whole row of the 32/G columns a warp
// owns where that is less (8 bytes in bf16 at G = 8; 8 in f32 and 4 in
// bf16 at G = 16, the least `cp.async` takes).
template <typename T, int G>
__host__ __device__ constexpr int copy_bytes_h() {
  return (32 / G) * (int)sizeof(T) < kCopy ? (32 / G) * (int)sizeof(T) : kCopy;
}

// One copy's bytes as a type, for the stores of a copy's width.
template <int CB>
using CopyVec = std::conditional_t<CB == 16, uint4, std::conditional_t<CB == 8, uint2, uint32_t>>;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// An asynchronous copy of BYTES (16, 8 or 4) from global to shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async_h(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The max of v over the warp: one redux.sync on the floats' order-preserving
// integer image (negative floats have their magnitude bits flipped).
__device__ __forceinline__ float warp_max(float v) {
  int i = __float_as_int(v);
  i ^= (i >> 31) & 0x7fffffff;
  i = __reduce_max_sync(kFull, i);
  i ^= (i >> 31) & 0x7fffffff;
  return __int_as_float(i);
}

// One step of a column's recurrence for this lane's bins d = dlo + i: a
// holds A[l-1] (0 at bins >= D) and becomes A[l]; xat(i) is x at bin i.
// The first step copies x.  Every lane of the warp calls it together.
template <int G, int B, typename XAt>
__device__ __forceinline__ void recur(float (&a)[B], XAt xat, const float (&wv)[5], int g, int dlo,
                                      int D, bool first) {
  if (first) {
#pragma unroll
    for (int i = 0; i < B; ++i) a[i] = dlo + i < D ? xat(i) : 0.f;
    return;
  }
  float m = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < B; ++i)
    if (dlo + i < D) m = fmaxf(m, a[i]);
  float left = 0.f, right = 0.f;  // A[l-1] at dlo - 1 and dlo + B
  if (G > 1) {
    if (G == 32) {
      m = warp_max(m);
    } else {
#pragma unroll
      for (int off = 1; off < G; off *= 2) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    }
    left = __shfl_up_sync(kFull, a[B - 1], 1);
    right = __shfl_down_sync(kFull, a[0], 1);
    if (g == 0) left = 0.f;
    if (g == G - 1) right = 0.f;
  }
  float prev = left;  // the old value at d - 1
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const float cur = a[i];
    const float next = i + 1 < B ? a[i + 1] : right;
    const float v = wv[0] * xat(i) + wv[1] * cur + wv[2] * prev + wv[3] * next + wv[4] * m;
    a[i] = dlo + i < D ? v : 0.f;
    prev = cur;
  }
}

// What one launch runs: kernel geometry and staging path.
struct Plan {
  int vec, G, B, steps, stages, warps_per_block, blocks;
  size_t smem;
};

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace
