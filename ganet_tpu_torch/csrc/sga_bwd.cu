// SGA directional sweep, backward (gradient sweep), for Hopper.
//
// Replaces the TPU kernel `_make_bwd_kernel` launched by
// `_sweep_bwd_canonical` in ganet_tpu/ops/sga_pallas.py.
//
// One launch is the gradient of one directional sweep over a (N, D, H, W)
// volume (see sga_fwd.cu for the forward).  It walks the sweep axis in the
// order opposite to the forward, with a float32 carry c (zero at the start):
//
//   g     = gbar[l] + c
//   dx[l] = w0 g                          (g at the sweep's first step)
//   dw[l] = (sum_d g x, sum_d g A', sum_d g A'(d-1), sum_d g A'(d+1),
//            (sum_d g) max_d A')          (0 at the sweep's first step)
//   c     = w1 g + w2 g(d+1) + w3 g(d-1) + w4 (sum_d g) e
//
// where A' is the forward output at the previous position of the sweep,
// read straight from the forward's output (the TPU version materialised a
// shifted copy), and e the indicator of argmax_d A' divided by the number
// of tied maxima (ties split the gradient evenly).  Weights and dw are
// (N, 5, H, W) for this direction, read and written at a caller-given
// per-n stride so that one (N, 4, 5, H, W) tensor serves all four
// directions.  With `accumulate` set, dx is added to the existing dx (the
// sum over directions) instead of stored.
//
// Bound on this card: bytes.  Per sweep it reads x, A, gbar and the 5
// weights once and writes dx and dw once, about 25 flops per element
// against 8-16 bytes moved.  The design is K1's: one block owns one n, a
// tile of lanes and all D bins and loops over l; the carry stays in
// registers (each thread owns its bins), g and A' go through shared memory
// for the d+-1 neighbours, and the sums over d (5 sums, and the max of A'
// with its tie count as one pair) go through warp shuffles and a per-warp
// shared array: two barriers a step.
//  * Lanes contiguous (sweeps along H): 32 lanes x 8 rows of d, each step's
//    32 lanes of a d row one coalesced access; the next step's x, A', gbar,
//    weights and (when accumulating) dx are loaded into registers before
//    the current step's arithmetic.
//  * Lanes strided (sweeps along W): 8 lanes x 32 rows, the volume staged
//    through shared memory in chunks of 8 steps read and written along l,
//    the next chunk's loads in flight during the current chunk's steps
//    (the cure of K1's uncoalesced W sweeps, PERF.md).  Each thread holds
//    the next chunk's x, A' and gbar in registers; 8 lanes (not K1's 16)
//    halve them and the bins a thread owns: 2.35 -> 1.07 ms per bf16 launch
//    at (64, 64, 80, 176) on an H100 80GB HBM3 at 700 W (4 lanes: 1.47 ms;
//    chip_smoke.py phase 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanesH = 32;  // lanes per block, sweeps along H
constexpr int kLanesW = 8;   // lanes per block, sweeps along W
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;    // steps per staged chunk (sweeps along W)
constexpr int kPitch = 10;   // padded step-row pitch of the staged chunks
constexpr int kRed = 7;      // per-warp partials: 5 sums, max of A', tie count
constexpr size_t kMaxShared = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared memory of the step: gs, as (D, LANES) f32 hold g and A' of this
// step; red (kRed, kWarps, LANES) the per-warp partials.
template <int LANES>
struct StepShared {
  float* gs;
  float* as;
  float* red;
};

// One backward step for this thread's bins d = ty + q * rows.  In: x, A',
// gbar and the 5 weights of this step, the carry c.  Out: dx (this step's
// w0 g, or g at the sweep's first step), the new carry, and, for threads
// with ty < 5, dw[ty] of their lane (0 at the first step).
template <int LANES, int DPT>
__device__ __forceinline__ void step(const float (&xv)[DPT], const float (&av)[DPT],
                                     const float (&bv)[DPT], const float (&wv)[5], bool first,
                                     StepShared<LANES> sh, int D, int tx, int ty,
                                     float (&c)[DPT], float (&dxv)[DPT], float& dwv) {
  constexpr int kRowsB = kThreads / LANES;
  float g[DPT];
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    const int d = ty + q * kRowsB;
    g[q] = bv[q] + c[q];
    if (d < D) {
      sh.gs[d * LANES + tx] = g[q];
      sh.as[d * LANES + tx] = av[q];
    }
  }
  __syncthreads();  // g and A' of this step are visible

  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, sg = 0.f;
  float mx = -CUDART_INF_F, cnt = 0.f;
  float gup[DPT], gdn[DPT];
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    const int d = ty + q * kRowsB;
    gup[q] = 0.f;
    gdn[q] = 0.f;
    if (d < D) {
      const float am1 = d > 0 ? sh.as[(d - 1) * LANES + tx] : 0.f;
      const float ap1 = d + 1 < D ? sh.as[(d + 1) * LANES + tx] : 0.f;
      gdn[q] = d > 0 ? sh.gs[(d - 1) * LANES + tx] : 0.f;
      gup[q] = d + 1 < D ? sh.gs[(d + 1) * LANES + tx] : 0.f;
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
  // A warp spans 32 / LANES rows: fold them, then one partial per warp.
#pragma unroll
  for (int off = LANES; off < 32; off *= 2) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    s3 += __shfl_xor_sync(0xffffffffu, s3, off);
    sg += __shfl_xor_sync(0xffffffffu, sg, off);
    const float omx = __shfl_xor_sync(0xffffffffu, mx, off);
    const float ocnt = __shfl_xor_sync(0xffffffffu, cnt, off);
    const float m = fmaxf(mx, omx);
    cnt = (mx == m ? cnt : 0.f) + (omx == m ? ocnt : 0.f);
    mx = m;
  }
  const int lin = ty * LANES + tx;
  if (lin % 32 < LANES) {
    const int wp = lin / 32;
    float* r = sh.red + wp * LANES + tx;
    constexpr int kS = kWarps * LANES;
    r[0 * kS] = s0;
    r[1 * kS] = s1;
    r[2 * kS] = s2;
    r[3 * kS] = s3;
    r[4 * kS] = sg;
    r[5 * kS] = mx;
    r[6 * kS] = cnt;
  }
  __syncthreads();  // the partials are visible

  // Every thread needs sum_d g, the max of A' and its tie count; a thread
  // of row ty < 4 also needs the sum dw[ty] (dw[4] is (sum_d g) max A').
  constexpr int kS = kWarps * LANES;
  float SG = 0.f, SK = 0.f, MX = -CUDART_INF_F, CNT = 0.f;
#pragma unroll
  for (int wp = 0; wp < kWarps; ++wp) {
    const float* r = sh.red + wp * LANES + tx;
    SG += r[4 * kS];
    if (ty < 4) SK += r[ty * kS];
    const float omx = r[5 * kS], ocnt = r[6 * kS];
    const float m = fmaxf(MX, omx);
    CNT = (MX == m ? CNT : 0.f) + (omx == m ? ocnt : 0.f);
    MX = m;
  }
  dwv = 0.f;
  if (!first && ty < 5) dwv = ty < 4 ? SK : SG * MX;
  const float share = wv[4] * SG / fmaxf(CNT, 1.f);
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    dxv[q] = first ? g[q] : wv[0] * g[q];
    c[q] = first ? 0.f
                 : wv[1] * g[q] + wv[2] * gup[q] + wv[3] * gdn[q] + (av[q] == MX ? share : 0.f);
  }
}

// Sweep along H: lanes on the contiguous W axis, l = h.  Shared memory:
// gs, as and red, f32.
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
sga_bwd_h_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ a,
                 const T* __restrict__ gbar, T* __restrict__ dx, T* __restrict__ dw, int D,
                 int H, int W, long long w_nstride, int reverse, int accumulate) {
  constexpr int kRowsB = kThreads / kLanesH;
  extern __shared__ float smem[];
  StepShared<kLanesH> sh{smem, smem + D * kLanesH, smem + 2 * D * kLanesH};
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m = blockIdx.x * kLanesH + tx;
  const bool active = m < W;
  const long long plane = (long long)H * W;
  const long long base = (long long)blockIdx.y * D * plane + (active ? m : 0);
  const T* xn = x + base;
  const T* an = a + base;
  const T* bn = gbar + base;
  T* dxn = dx + base;
  const T* wn = w + blockIdx.y * w_nstride + (active ? m : 0);
  T* dwn = dw + blockIdx.y * w_nstride + (active ? m : 0);
  const int first_l = reverse ? H - 1 : 0;

  // Registers of one step: x, A', gbar, old dx and the 5 weights;
  // `c` in use, `n` in flight.
  float xc[DPT], ac[DPT], bc[DPT], oc[DPT], wc[5];
  float xnx[DPT], anx[DPT], bnx[DPT], onx[DPT], wnx[5];
  auto load = [&](int l, float (&xv)[DPT], float (&av)[DPT], float (&bv)[DPT],
                  float (&ov)[DPT], float (&wv)[5]) {
    const long long off = (long long)l * W;
    const bool has_prev = l != first_l;
    const long long aoff = (long long)(reverse ? l + 1 : l - 1) * W;
#pragma unroll
    for (int q = 0; q < DPT; ++q) {
      const int d = ty + q * kRowsB;
      const bool in = active && d < D;
      xv[q] = in ? to_f32(xn[d * plane + off]) : 0.f;
      av[q] = in && has_prev ? to_f32(an[d * plane + aoff]) : 0.f;
      bv[q] = in ? to_f32(bn[d * plane + off]) : 0.f;
      ov[q] = in && accumulate ? to_f32(dxn[d * plane + off]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) wv[k] = active ? to_f32(wn[k * plane + off]) : 0.f;
  };

  float c[DPT];
#pragma unroll
  for (int q = 0; q < DPT; ++q) c[q] = 0.f;
  // The gradient walks opposite to the forward: l = H-1 .. 0 for a forward
  // sweep, 0 .. H-1 for a reverse one.
  load(reverse ? 0 : H - 1, xc, ac, bc, oc, wc);
  for (int s = 0; s < H; ++s) {
    const int l = reverse ? s : H - 1 - s;
    if (s + 1 < H) load(reverse ? l + 1 : l - 1, xnx, anx, bnx, onx, wnx);
    float dxv[DPT], dwv;
    step<kLanesH, DPT>(xc, ac, bc, wc, l == first_l, sh, D, tx, ty, c, dxv, dwv);
    const long long off = (long long)l * W;
#pragma unroll
    for (int q = 0; q < DPT; ++q) {
      const int d = ty + q * kRowsB;
      if (active && d < D) dxn[d * plane + off] = from_f32<T>(accumulate ? oc[q] + dxv[q] : dxv[q]);
    }
    if (active && ty < 5) dwn[ty * plane + off] = from_f32<T>(dwv);
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
}

// Sweep along W: lanes on H (W elements apart), l = w, through chunks of
// kChunk steps staged in shared memory: x, A' and gbar (D rows each; gbar's
// rows take dx on the way out) and the weights (5 rows; they take dw), each
// row (kChunk, kPitch) of T indexed [row][step][lane]; then gs, as, red f32.
template <typename T> __host__ __device__ size_t staged_bytes(int D) {
  return ((size_t)(3 * D + 5) * kChunk * kPitch * sizeof(T) + 15) / 16 * 16;
}

__host__ __device__ inline size_t step_bytes(int D, int lanes) {
  return sizeof(float) * ((size_t)2 * D * lanes + (size_t)kRed * kWarps * lanes);
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
sga_bwd_w_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ a,
                 const T* __restrict__ gbar, T* __restrict__ dx, T* __restrict__ dw, int D,
                 int H, int W, long long w_nstride, int reverse, int accumulate) {
  constexpr int kRowsB = kThreads / kLanesW;
  constexpr int kTile = kChunk * kLanesW;                   // elements of one row
  constexpr int kPerX = DPT * kRowsB * kTile / kThreads;  // per thread, per D-row array
  constexpr int kPerW = (5 * kTile + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* as_ = xs + (size_t)D * kChunk * kPitch;
  T* bs = as_ + (size_t)D * kChunk * kPitch;
  T* ws = bs + (size_t)D * kChunk * kPitch;
  float* f = reinterpret_cast<float*>(smem_raw + staged_bytes<T>(D));
  StepShared<kLanesW> sh{f, f + D * kLanesW, f + 2 * D * kLanesW};
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kLanesW + tx;
  const int h0 = blockIdx.x * kLanesW;
  const long long plane = (long long)H * W;
  const long long nbase = (long long)blockIdx.y * D * plane;
  const T* xn = x + nbase;
  const T* an = a + nbase;
  const T* bn = gbar + nbase;
  T* dxn = dx + nbase;
  const T* wn = w + blockIdx.y * w_nstride;
  T* dwn = dw + blockIdx.y * w_nstride;
  const int nchunks = (W + kChunk - 1) / kChunk;
  const int first_l = reverse ? W - 1 : 0;
  const int ashift = reverse ? 1 : -1;  // A' sits at l + ashift
  const T zero = from_f32<T>(0.f);
  // The gradient walks opposite to the forward: chunks (and steps within
  // them) in descending l for a forward sweep, ascending for a reverse one.
  auto chunk_l0 = [&](int ci) { return (reverse ? ci : nchunks - 1 - ci) * kChunk; };

  // Element e of a (rows, kChunk, kLanesW) tile -> (row, step j, lane),
  // with j fastest so that neighbouring threads read neighbouring addresses.
  T px[kPerX], pa[kPerX], pb[kPerX], pw[kPerW];
  auto fetch = [&](int ci) {  // chunk ci (in gradient order) into registers
    const int l0 = chunk_l0(ci);
    const int nl = min(kChunk, W - l0);
#pragma unroll
    for (int i = 0; i < kPerX; ++i) {
      const int e = tid + i * kThreads;
      const int j = e % kChunk, lane = (e / kChunk) % kLanesW, d = e / kTile;
      const bool in = d < D && j < nl && h0 + lane < H;
      const long long g = d * plane + (long long)(h0 + lane) * W + l0 + j;
      const int la = l0 + j + ashift;
      px[i] = in ? xn[g] : zero;
      pa[i] = in && la >= 0 && la < W ? an[g + ashift] : zero;
      pb[i] = in ? bn[g] : zero;
    }
#pragma unroll
    for (int i = 0; i < kPerW; ++i) {
      const int e = tid + i * kThreads;
      const int j = e % kChunk, lane = (e / kChunk) % kLanesW, k = e / kTile;
      const bool in = k < 5 && j < nl && h0 + lane < H;
      pw[i] = in ? wn[k * plane + (long long)(h0 + lane) * W + l0 + j] : zero;
    }
  };
  auto stash = [&]() {  // registers into shared memory
#pragma unroll
    for (int i = 0; i < kPerX; ++i) {
      const int e = tid + i * kThreads;
      const int j = e % kChunk, lane = (e / kChunk) % kLanesW, d = e / kTile;
      if (d < D) {
        const int idx = (d * kChunk + j) * kPitch + lane;
        xs[idx] = px[i];
        as_[idx] = pa[i];
        bs[idx] = pb[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kPerW; ++i) {
      const int e = tid + i * kThreads;
      const int j = e % kChunk, lane = (e / kChunk) % kLanesW, k = e / kTile;
      if (k < 5) ws[(k * kChunk + j) * kPitch + lane] = pw[i];
    }
  };

  float c[DPT];
#pragma unroll
  for (int q = 0; q < DPT; ++q) c[q] = 0.f;
  fetch(0);
  stash();
  __syncthreads();
  for (int ci = 0; ci < nchunks; ++ci) {
    const int l0 = chunk_l0(ci);
    const int nl = min(kChunk, W - l0);
    if (ci + 1 < nchunks) fetch(ci + 1);  // in flight during this chunk's steps

    for (int jj = 0; jj < nl; ++jj) {
      const int j = reverse ? jj : nl - 1 - jj;
      float xv[DPT], av[DPT], bv[DPT], wv[5], dxv[DPT], dwv;
#pragma unroll
      for (int q = 0; q < DPT; ++q) {
        const int d = ty + q * kRowsB;
        const int idx = (d * kChunk + j) * kPitch + tx;
        xv[q] = d < D ? to_f32(xs[idx]) : 0.f;
        av[q] = d < D ? to_f32(as_[idx]) : 0.f;
        bv[q] = d < D ? to_f32(bs[idx]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 5; ++k) wv[k] = to_f32(ws[(k * kChunk + j) * kPitch + tx]);
      step<kLanesW, DPT>(xv, av, bv, wv, l0 + j == first_l, sh, D, tx, ty, c, dxv, dwv);
      // After the step's second barrier every thread has read this step's
      // staged values, so dx and dw may take their slots.
#pragma unroll
      for (int q = 0; q < DPT; ++q) {
        const int d = ty + q * kRowsB;
        if (d < D) bs[(d * kChunk + j) * kPitch + tx] = from_f32<T>(dxv[q]);
      }
      if (ty < 5) ws[(ty * kChunk + j) * kPitch + tx] = from_f32<T>(dwv);
    }
    __syncthreads();  // dx and dw of the chunk are staged

    for (int e = tid; e < D * kTile; e += kThreads) {
      const int j = e % kChunk, lane = (e / kChunk) % kLanesW, d = e / kTile;
      if (j < nl && h0 + lane < H) {
        const long long g = d * plane + (long long)(h0 + lane) * W + l0 + j;
        const T v = bs[(d * kChunk + j) * kPitch + lane];
        dxn[g] = accumulate ? from_f32<T>(to_f32(dxn[g]) + to_f32(v)) : v;
      }
    }
    for (int e = tid; e < 5 * kTile; e += kThreads) {
      const int j = e % kChunk, lane = (e / kChunk) % kLanesW, k = e / kTile;
      if (j < nl && h0 + lane < H)
        dwn[k * plane + (long long)(h0 + lane) * W + l0 + j] = ws[(k * kChunk + j) * kPitch + lane];
    }
    __syncthreads();  // the chunk is written back before the next is staged
    if (ci + 1 < nchunks) {
      stash();
      __syncthreads();
    }
  }
}

template <typename T, int DPT>
cudaError_t launch_h(const T* x, const T* w, const T* a, const T* gbar, T* dx, T* dw, int N,
                     int D, int H, int W, int reverse, int accumulate, long long w_nstride,
                     cudaStream_t stream) {
  const size_t shmem = step_bytes(D, kLanesH);
  cudaError_t err = cudaFuncSetAttribute(
      sga_bwd_h_kernel<T, DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return err;
  dim3 grid((W + kLanesH - 1) / kLanesH, N);
  sga_bwd_h_kernel<T, DPT><<<grid, dim3(kLanesH, kThreads / kLanesH), shmem, stream>>>(
      x, w, a, gbar, dx, dw, D, H, W, w_nstride, reverse, accumulate);
  return cudaGetLastError();
}

template <typename T, int DPT>
cudaError_t launch_w(const T* x, const T* w, const T* a, const T* gbar, T* dx, T* dw, int N,
                     int D, int H, int W, int reverse, int accumulate, long long w_nstride,
                     cudaStream_t stream) {
  const size_t shmem = staged_bytes<T>(D) + step_bytes(D, kLanesW);
  if (shmem > kMaxShared) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sga_bwd_w_kernel<T, DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return err;
  dim3 grid((H + kLanesW - 1) / kLanesW, N);
  sga_bwd_w_kernel<T, DPT><<<grid, dim3(kLanesW, kThreads / kLanesW), shmem, stream>>>(
      x, w, a, gbar, dx, dw, D, H, W, w_nstride, reverse, accumulate);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* xv, const void* wv, const void* av, const void* bv, void* dxv,
                     void* dwv, int N, int D, int H, int W, int axis_w, int reverse,
                     int accumulate, long long w_nstride, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const T* a = static_cast<const T*>(av);
  const T* b = static_cast<const T*>(bv);
  T* dx = static_cast<T*>(dxv);
  T* dw = static_cast<T*>(dwv);
#define SGA_BWD_ARGS x, w, a, b, dx, dw, N, D, H, W, reverse, accumulate, w_nstride, stream
  if (axis_w) {  // 32 rows of d: DPT = ceil(D / 32)
    const int dpt = (D + 31) / 32;
    if (dpt <= 1) return launch_w<T, 1>(SGA_BWD_ARGS);
    if (dpt <= 2) return launch_w<T, 2>(SGA_BWD_ARGS);
    if (dpt <= 4) return launch_w<T, 4>(SGA_BWD_ARGS);
    return cudaErrorInvalidValue;
  }
  const int dpt = (D + 7) / 8;  // 8 rows of d
  if (dpt <= 1) return launch_h<T, 1>(SGA_BWD_ARGS);
  if (dpt <= 2) return launch_h<T, 2>(SGA_BWD_ARGS);
  if (dpt <= 4) return launch_h<T, 4>(SGA_BWD_ARGS);
  if (dpt <= 8) return launch_h<T, 8>(SGA_BWD_ARGS);
  if (dpt <= 16) return launch_h<T, 16>(SGA_BWD_ARGS);
#undef SGA_BWD_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Largest D one launch takes (rows of d x the largest DPT instantiated).
int sga_sweep_bwd_max_d() { return 128; }

// x, a (the forward's output), gbar, dx: (N, D, H, W); w, dw: this
// direction's (N, 5, H, W) weights and their gradient with a stride of
// w_nstride elements between consecutive n.  dtype 0 = float32,
// 1 = bfloat16.  axis_w: 0 sweeps along H, 1 along W; reverse: the
// forward's direction.  Returns the CUDA error of the launch (0 on success).
int sga_sweep_bwd(const void* x, const void* w, const void* a, const void* gbar, void* dx,
                  void* dw, int N, int D, int H, int W, int axis_w, int reverse, int accumulate,
                  long long w_nstride, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, w, a, gbar, dx, dw, N, D, H, W, axis_w, reverse, accumulate,
                           w_nstride, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, a, gbar, dx, dw, N, D, H, W, axis_w, reverse,
                                   accumulate, w_nstride, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
