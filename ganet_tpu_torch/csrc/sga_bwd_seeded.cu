// Seeded SGA sweep along H, backward (K6), for Hopper.
//
// Replaces the TPU kernel `_make_bwd_kernel_seeded` launched by
// `_sweep_bwd_canonical_seeded` in ganet_tpu/ops/sga_pallas.py.
//
// The gradient of one seeded sweep of sga_fwd_seeded.cu (K5) over the
// columns [col0, col0 + cols) of a (N, D, H, W) block.  It walks H in the
// order opposite to the forward with a float32 carry c, as K3 does
// (sga_bwd.cu):
//
//   g     = gbar[l] + c
//   dx[l] = w0 g
//   dw[l] = (sum_d g x, sum_d g A', sum_d g A'(d-1), sum_d g A'(d+1),
//            (sum_d g) max_d A')
//   c     = w1 g + w2 g(d+1) + w3 g(d-1) + w4 (sum_d g) e
//
// with A' the forward's output at the previous position of the sweep and
// e the indicator of argmax_d A' split evenly among ties.  K5's
// differences:
//  * at the sweep's first step A' is the seed when `valid`, and that step
//    is a full one; without `valid` it is K3's copy step (dx = g, dw = 0,
//    carry cut);
//  * the carry starts at `dboundary` (N, D, cols) float32 when given: the
//    cotangent of the boundary row this chunk sent downstream, which adds
//    to gbar at the forward's last row;
//  * the carry left after the first step is written to `dseed`
//    (N, D, cols) float32, the seed's cotangent (0 without `valid`);
//  * dx and dw are added into (the wavefront sums the directions into one
//    dx, and overlapping chunks each add their share into dw).
// x, A, gbar, dx and the weights are read and written in place in the
// window at row pitch W.
//
// Bound on this card: bytes (x, A, gbar once, dx and dw written once,
// about 25 flops an element).  The geometry is K3's H sweep: one block
// owns one n, 32 lanes on the contiguous W axis and all D bins over 8 rows
// of threads; the carry of a thread's bins stays in registers, g and A' go
// through shared memory for the d+-1 neighbours, and the five sums over d
// with the (max, tie count) of A' reduce through warp shuffles and a
// per-warp shared array: two barriers a step.  The next step's inputs are
// loaded into registers before the current step's arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kRows = kThreads / kLanes;  // rows of d
constexpr int kWarps = kThreads / 32;
constexpr int kRed = 7;  // per-warp partials: 5 sums, max of A', tie count
constexpr int kS = kWarps * kLanes;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One backward step for thread (tx, ty)'s bins d = ty + q * kRows.  gs and
// as (D, 32) f32 hold g and A' of the step, red (kRed, kWarps, 32) the
// partials.  `copy`: K3's first step (dx = g, dw = 0, carry cut).  Out:
// dx, the new carry, and for ty < 5 dw[ty] of this lane.
template <int DPT>
__device__ __forceinline__ void step(const float (&xv)[DPT], const float (&av)[DPT],
                                     const float (&bv)[DPT], const float (&wv)[5], bool copy,
                                     float* gs, float* as, float* red, int D, int tx, int ty,
                                     float (&c)[DPT], float (&dxv)[DPT], float& dwv) {
  float g[DPT];
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    const int d = ty + q * kRows;
    g[q] = bv[q] + c[q];
    if (d < D) {
      gs[d * kLanes + tx] = g[q];
      as[d * kLanes + tx] = av[q];
    }
  }
  __syncthreads();  // g and A' of this step are visible

  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, sg = 0.f;
  float mx = -CUDART_INF_F, cnt = 0.f;
  float gup[DPT], gdn[DPT];
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    const int d = ty + q * kRows;
    gup[q] = 0.f;
    gdn[q] = 0.f;
    if (d < D) {
      const float am1 = d > 0 ? as[(d - 1) * kLanes + tx] : 0.f;
      const float ap1 = d + 1 < D ? as[(d + 1) * kLanes + tx] : 0.f;
      gdn[q] = d > 0 ? gs[(d - 1) * kLanes + tx] : 0.f;
      gup[q] = d + 1 < D ? gs[(d + 1) * kLanes + tx] : 0.f;
      s0 += g[q] * xv[q];
      s1 += g[q] * av[q];
      s2 += g[q] * am1;
      s3 += g[q] * ap1;
      sg += g[q];
      if (av[q] > mx) {
        mx = av[q];
        cnt = 1.f;
      } else if (av[q] == mx) {
        cnt += 1.f;
      }
    }
  }
  // A warp is one row of 32 lanes: one partial per warp and lane.
  float* r = red + ty * kLanes + tx;
  r[0 * kS] = s0;
  r[1 * kS] = s1;
  r[2 * kS] = s2;
  r[3 * kS] = s3;
  r[4 * kS] = sg;
  r[5 * kS] = mx;
  r[6 * kS] = cnt;
  __syncthreads();  // the partials are visible

  float SG = 0.f, SK = 0.f, MX = -CUDART_INF_F, CNT = 0.f;
#pragma unroll
  for (int wp = 0; wp < kWarps; ++wp) {
    const float* p = red + wp * kLanes + tx;
    SG += p[4 * kS];
    if (ty < 4) SK += p[ty * kS];
    const float omx = p[5 * kS], ocnt = p[6 * kS];
    const float m = fmaxf(MX, omx);
    CNT = (MX == m ? CNT : 0.f) + (omx == m ? ocnt : 0.f);
    MX = m;
  }
  dwv = 0.f;
  if (!copy && ty < 5) dwv = ty < 4 ? SK : SG * MX;
  const float share = wv[4] * SG / fmaxf(CNT, 1.f);
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    dxv[q] = copy ? g[q] : wv[0] * g[q];
    c[q] = copy ? 0.f
                : wv[1] * g[q] + wv[2] * gup[q] + wv[3] * gdn[q] + (av[q] == MX ? share : 0.f);
  }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
sga_bwd_seeded_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ a,
                      const T* __restrict__ seed, const T* __restrict__ gbar,
                      const float* __restrict__ dboundary, T* __restrict__ dx,
                      T* __restrict__ dw, float* __restrict__ dseed, int D, int H, int W,
                      int col0, int cols, long long w_nstride, int reverse, int valid) {
  extern __shared__ float smem[];
  float* gs = smem;
  float* as = smem + D * kLanes;
  float* red = smem + 2 * D * kLanes;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int mc = blockIdx.x * kLanes + tx;  // column within the window
  const bool active = mc < cols;
  const int m = col0 + (active ? mc : 0);
  const long long plane = (long long)H * W;
  const long long base = (long long)blockIdx.y * D * plane + m;
  const T* xn = x + base;
  const T* an = a + base;
  const T* bn = gbar + base;
  T* dxn = dx + base;
  const T* wn = w + blockIdx.y * w_nstride + m;
  T* dwn = dw + blockIdx.y * w_nstride + m;
  const long long rbase = (long long)blockIdx.y * D * cols + mc;  // (N, D, cols) rows
  const int first_l = reverse ? H - 1 : 0;

  // Registers of one step: x, A', gbar, old dx and the 5 weights; `c` in
  // use, `n` in flight.  A' at the first step is the seed (when valid).
  float xc[DPT], ac[DPT], bc[DPT], oc[DPT], wc[5];
  float xnx[DPT], anx[DPT], bnx[DPT], onx[DPT], wnx[5];
  auto load = [&](int l, float (&xv)[DPT], float (&av)[DPT], float (&bv)[DPT],
                  float (&ov)[DPT], float (&wv)[5]) {
    const long long off = (long long)l * W;
    const bool first = l == first_l;
    const long long aoff = (long long)(reverse ? l + 1 : l - 1) * W;
#pragma unroll
    for (int q = 0; q < DPT; ++q) {
      const int d = ty + q * kRows;
      const bool in = active && d < D;
      xv[q] = in ? to_f32(xn[d * plane + off]) : 0.f;
      av[q] = !in ? 0.f
              : !first ? to_f32(an[d * plane + aoff])
              : valid ? to_f32(seed[rbase + (long long)d * cols])
                      : 0.f;
      bv[q] = in ? to_f32(bn[d * plane + off]) : 0.f;
      ov[q] = in ? to_f32(dxn[d * plane + off]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) wv[k] = active ? to_f32(wn[k * plane + off]) : 0.f;
  };

  float c[DPT];
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    const int d = ty + q * kRows;
    c[q] = dboundary != nullptr && active && d < D ? dboundary[rbase + (long long)d * cols] : 0.f;
  }
  load(reverse ? 0 : H - 1, xc, ac, bc, oc, wc);
  for (int s = 0; s < H; ++s) {
    const int l = reverse ? s : H - 1 - s;
    if (s + 1 < H) load(reverse ? l + 1 : l - 1, xnx, anx, bnx, onx, wnx);
    float dxv[DPT], dwv;
    step<DPT>(xc, ac, bc, wc, l == first_l && !valid, gs, as, red, D, tx, ty, c, dxv, dwv);
    const long long off = (long long)l * W;
#pragma unroll
    for (int q = 0; q < DPT; ++q) {
      const int d = ty + q * kRows;
      if (active && d < D) dxn[d * plane + off] = from_f32<T>(oc[q] + dxv[q]);
    }
    if (active && ty < 5) {
      T* p = dwn + ty * plane + off;
      *p = from_f32<T>(to_f32(*p) + dwv);
    }
#pragma unroll
    for (int q = 0; q < DPT; ++q) {
      xc[q] = xnx[q];
      ac[q] = anx[q];
      bc[q] = bnx[q];
      oc[q] = onx[q];
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) wc[k] = wnx[k];
  }
  // The carry past the sweep's first step is the seed's cotangent.
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    const int d = ty + q * kRows;
    if (active && d < D) dseed[rbase + (long long)d * cols] = c[q];
  }
}

template <typename T, int DPT>
cudaError_t launch(const T* x, const T* w, const T* a, const T* seed, const T* gbar,
                   const float* dboundary, T* dx, T* dw, float* dseed, int N, int D, int H,
                   int W, int col0, int cols, int reverse, int valid, long long w_nstride,
                   cudaStream_t stream) {
  const size_t shmem = sizeof(float) * ((size_t)2 * D * kLanes + (size_t)kRed * kS);
  cudaError_t err = cudaFuncSetAttribute(
      sga_bwd_seeded_kernel<T, DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return err;
  dim3 grid((cols + kLanes - 1) / kLanes, N);
  sga_bwd_seeded_kernel<T, DPT><<<grid, dim3(kLanes, kRows), shmem, stream>>>(
      x, w, a, seed, gbar, dboundary, dx, dw, dseed, D, H, W, col0, cols, w_nstride, reverse,
      valid);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* xv, const void* wv, const void* av, const void* sv,
                     const void* bv, const void* dbv, void* dxv, void* dwv, void* dsv, int N,
                     int D, int H, int W, int col0, int cols, int reverse, int valid,
                     long long w_nstride, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const T* a = static_cast<const T*>(av);
  const T* seed = static_cast<const T*>(sv);
  const T* b = static_cast<const T*>(bv);
  const float* db = static_cast<const float*>(dbv);
  T* dx = static_cast<T*>(dxv);
  T* dw = static_cast<T*>(dwv);
  float* ds = static_cast<float*>(dsv);
  if (H < 1 || cols < 1 || col0 < 0 || col0 + cols > W || (valid && seed == nullptr))
    return cudaErrorInvalidValue;
#define SGA_BWD_SEEDED_ARGS \
  x, w, a, seed, b, db, dx, dw, ds, N, D, H, W, col0, cols, reverse, valid, w_nstride, stream
  const int dpt = (D + kRows - 1) / kRows;
  if (dpt <= 1) return launch<T, 1>(SGA_BWD_SEEDED_ARGS);
  if (dpt <= 2) return launch<T, 2>(SGA_BWD_SEEDED_ARGS);
  if (dpt <= 4) return launch<T, 4>(SGA_BWD_SEEDED_ARGS);
  if (dpt <= 8) return launch<T, 8>(SGA_BWD_SEEDED_ARGS);
  if (dpt <= 16) return launch<T, 16>(SGA_BWD_SEEDED_ARGS);
#undef SGA_BWD_SEEDED_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Largest D one launch takes (rows of d x the largest DPT instantiated).
int sga_sweep_bwd_seeded_max_d() { return kRows * 16; }

// x, a (K5's output), gbar, dx: (N, D, H, W), the window [col0, col0 + cols)
// of each row; w, dw: this direction's (N, 5, H, W) weights and their
// gradient with a stride of w_nstride elements between consecutive n;
// seed (read when valid): (N, D, cols) in the volume's dtype; dboundary
// (may be null) and dseed: (N, D, cols) float32.  dx and dw are added
// into.  dtype 0 = float32, 1 = bfloat16.  reverse: the forward's
// direction.  Returns the CUDA error of the launch (0 on success).
int sga_sweep_bwd_seeded(const void* x, const void* w, const void* a, const void* seed,
                         const void* gbar, const void* dboundary, void* dx, void* dw,
                         void* dseed, int N, int D, int H, int W, int col0, int cols,
                         int reverse, int valid, long long w_nstride, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, w, a, seed, gbar, dboundary, dx, dw, dseed, N, D, H, W, col0,
                           cols, reverse, valid, w_nstride, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, a, seed, gbar, dboundary, dx, dw, dseed, N, D, H, W,
                                   col0, cols, reverse, valid, w_nstride, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
