// Seeded SGA sweep along H, forward (K5), for Hopper.
//
// Replaces the TPU kernel `_make_fwd_kernel_seeded` launched by
// `_sweep_fwd_canonical_seeded` in ganet_tpu/ops/sga_pallas.py.
//
// The H-sharded wavefront (ganet_tpu_torch/parallel/sharded_sga.py) runs a
// vertical sweep of a shard's (N, D, Hl, W) block chunk by chunk of
// columns.  One launch sweeps the columns [col0, col0 + cols) along H with
// K1's recurrence (sga_fwd.cu)
//
//   A[l] = w0*x[l] + w1*A[l-1] + w2*A[l-1](d-1) + w3*A[l-1](d+1)
//        + w4*max_d A[l-1]
//
// except that, when `valid`, the carry entering the first step is `seed`
// (N, D, cols), the boundary row of the upstream shard, and the first step
// is a full recurrence step; without `valid` the first step copies x, as
// K1's does (the pipeline's head shard).  x and out are read and written
// in place in the window at row pitch W, so the caller slices no chunk
// copy.  The last step's A is also written, in the output dtype, to the
// contiguous (N, D, cols) `boundary`, ready to send downstream.  Weights
// are this direction's (N, 5, Hl, W) planes at a caller-given per-n stride.
// I/O is float32 or bfloat16; the carry is float32.
//
// Bound on this card: bytes (x and A once each, 5 weight planes, about
// 10 flops an element).  The geometry is K1's H sweep: one block owns one
// n, 32 lanes on the contiguous W axis (each d row of a step one coalesced
// access) and all D bins over 8 rows of threads, walks l, holds the
// previous step's (D, 32) column in shared memory, reduces max_d through
// warp shuffles and one partial per warp, and loads the next step's x and
// weights into registers before the current step's arithmetic: two
// barriers a step.  A chunk of 128 columns gives 4 blocks per n, so the
// grid is small at the wavefront's shapes; that is left for a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kRows = kThreads / kLanes;  // rows of d
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Thread (tx, ty) owns the bins d = ty + q * kRows, q < DPT.  prev (D, 32)
// holds A at the previous step, red (kWarps, 32) one partial max a warp.

// Make nv the previous step of the next one (between barriers).
template <int DPT>
__device__ __forceinline__ void publish(const float (&nv)[DPT], float* prev, float* red, int D,
                                        int tx, int ty) {
  float pm = -CUDART_INF_F;
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    const int d = ty + q * kRows;
    if (d < D) {
      prev[d * kLanes + tx] = nv[q];
      pm = fmaxf(pm, nv[q]);
    }
  }
  red[ty * kLanes + tx] = pm;  // a warp is one row of 32 lanes
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
sga_fwd_seeded_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ seed, T* __restrict__ out, T* __restrict__ boundary,
                      int D, int H, int W, int col0, int cols, long long w_nstride, int reverse,
                      int valid) {
  extern __shared__ float smem[];
  float* prev = smem;
  float* red = smem + D * kLanes;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int mc = blockIdx.x * kLanes + tx;  // column within the window
  const bool active = mc < cols;
  const int m = col0 + (active ? mc : 0);
  const long long plane = (long long)H * W;
  const long long base = (long long)blockIdx.y * D * plane + m;
  const T* xn = x + base;
  T* on = out + base;
  const T* wn = w + blockIdx.y * w_nstride + m;
  const long long rbase = (long long)blockIdx.y * D * cols + mc;  // (N, D, cols) rows

  float xc[DPT], wc[5], xnx[DPT], wnx[5];
  auto load = [&](int l, float (&xv)[DPT], float (&wv)[5]) {
    const long long off = (long long)l * W;
#pragma unroll
    for (int q = 0; q < DPT; ++q) {
      const int d = ty + q * kRows;
      xv[q] = active && d < D ? to_f32(xn[d * plane + off]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) wv[k] = active ? to_f32(wn[k * plane + off]) : 0.f;
  };

  if (valid) {  // the seed is the step before the first
    float sv[DPT];
#pragma unroll
    for (int q = 0; q < DPT; ++q) {
      const int d = ty + q * kRows;
      sv[q] = active && d < D ? to_f32(seed[rbase + (long long)d * cols]) : 0.f;
    }
    publish<DPT>(sv, prev, red, D, tx, ty);
  }
  load(reverse ? H - 1 : 0, xc, wc);
  __syncthreads();
  for (int s = 0; s < H; ++s) {
    const int l = reverse ? H - 1 - s : s;
    if (s + 1 < H) load(reverse ? l - 1 : l + 1, xnx, wnx);
    float nv[DPT];
    if (s == 0 && !valid) {
#pragma unroll
      for (int q = 0; q < DPT; ++q) nv[q] = xc[q];
    } else {
      float pmax = red[tx];
#pragma unroll
      for (int r = 1; r < kWarps; ++r) pmax = fmaxf(pmax, red[r * kLanes + tx]);
#pragma unroll
      for (int q = 0; q < DPT; ++q) {
        const int d = ty + q * kRows;
        if (d < D) {
          const float p = prev[d * kLanes + tx];
          const float pdm1 = d > 0 ? prev[(d - 1) * kLanes + tx] : 0.f;
          const float pdp1 = d + 1 < D ? prev[(d + 1) * kLanes + tx] : 0.f;
          nv[q] = wc[0] * xc[q] + wc[1] * p + wc[2] * pdm1 + wc[3] * pdp1 + wc[4] * pmax;
        } else {
          nv[q] = 0.f;
        }
      }
    }
    __syncthreads();  // every read of prev/red for this step is done
    publish<DPT>(nv, prev, red, D, tx, ty);
    const bool last = s + 1 == H;
#pragma unroll
    for (int q = 0; q < DPT; ++q) {
      const int d = ty + q * kRows;
      if (active && d < D) {
        const T v = from_f32<T>(nv[q]);
        on[d * plane + (long long)l * W] = v;
        if (last) boundary[rbase + (long long)d * cols] = v;
      }
    }
    __syncthreads();  // prev/red hold this step for the next one
#pragma unroll
    for (int q = 0; q < DPT; ++q) xc[q] = xnx[q];
#pragma unroll
    for (int k = 0; k < 5; ++k) wc[k] = wnx[k];
  }
}

template <typename T, int DPT>
cudaError_t launch(const T* x, const T* w, const T* seed, T* out, T* boundary, int N, int D,
                   int H, int W, int col0, int cols, int reverse, int valid,
                   long long w_nstride, cudaStream_t stream) {
  const size_t shmem = sizeof(float) * (size_t)(D + kWarps) * kLanes;
  dim3 grid((cols + kLanes - 1) / kLanes, N);
  sga_fwd_seeded_kernel<T, DPT><<<grid, dim3(kLanes, kRows), shmem, stream>>>(
      x, w, seed, out, boundary, D, H, W, col0, cols, w_nstride, reverse, valid);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* xv, const void* wv, const void* sv, void* ov, void* bv, int N,
                     int D, int H, int W, int col0, int cols, int reverse, int valid,
                     long long w_nstride, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const T* seed = static_cast<const T*>(sv);
  T* out = static_cast<T*>(ov);
  T* boundary = static_cast<T*>(bv);
  if (H < 1 || cols < 1 || col0 < 0 || col0 + cols > W || (valid && seed == nullptr))
    return cudaErrorInvalidValue;
#define SGA_SEEDED_ARGS x, w, seed, out, boundary, N, D, H, W, col0, cols, reverse, valid, w_nstride, stream
  const int dpt = (D + kRows - 1) / kRows;
  if (dpt <= 1) return launch<T, 1>(SGA_SEEDED_ARGS);
  if (dpt <= 2) return launch<T, 2>(SGA_SEEDED_ARGS);
  if (dpt <= 4) return launch<T, 4>(SGA_SEEDED_ARGS);
  if (dpt <= 8) return launch<T, 8>(SGA_SEEDED_ARGS);
  if (dpt <= 16) return launch<T, 16>(SGA_SEEDED_ARGS);
#undef SGA_SEEDED_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Largest D one launch takes (rows of d x the largest DPT instantiated).
int sga_sweep_fwd_seeded_max_d() { return kRows * 16; }

// x, out: (N, D, H, W), the window [col0, col0 + cols) of each row; w: this
// direction's (N, 5, H, W) weights with a stride of w_nstride elements
// between consecutive n; seed (read when valid) and boundary: (N, D, cols)
// contiguous.  dtype 0 = float32, 1 = bfloat16.  Returns the CUDA error of
// the launch (0 on success).
int sga_sweep_fwd_seeded(const void* x, const void* w, const void* seed, void* out,
                         void* boundary, int N, int D, int H, int W, int col0, int cols,
                         int reverse, int valid, long long w_nstride, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, w, seed, out, boundary, N, D, H, W, col0, cols, reverse, valid,
                           w_nstride, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, seed, out, boundary, N, D, H, W, col0, cols, reverse,
                                   valid, w_nstride, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
