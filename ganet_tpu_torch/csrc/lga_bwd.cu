// LGA stencil, backward (local guided aggregation), for Hopper.
//
// Replaces the TPU kernel `_make_bwd_kernel` launched by `_lga_bwd_once` in
// ganet_tpu/ops/lga_pallas.py.
//
// One launch is the gradient of one LGA pass (see lga_fwd.cu) over a
// (B, D, H, W) volume x with guidance g (B, 3*K*K, H, W), K = 2R+1,
// channels in (k, dy, dx) row-major order, given the cotangent gbar of the
// pass's output.  With offsets o in [-R, R]^2 and zeros outside the image
// and outside [0, D):
//
//   dx(q, e)   = sum_o g0(q-o, o) gbar(q-o, e) + g1(q-o, o) gbar(q-o, e+1)
//                                              + g2(q-o, o) gbar(q-o, e-1)
//   dg_k(p, o) = sum_d gbar(p, d) x(p+o, d+delta_k),   delta = 0, -1, +1
//
// dx is in x's dtype; dg is summed over D in float32 and rounded to the
// guidance dtype once, at the end.
//
// Bound on this card: operations.  Each volume element takes 2 * 75 f32
// FMAs (75 for dx, 75 for dg) off the tensor cores; at (2, 192, 240, 528)
// that is 14.6 GFLOP against 0.15 GB of compulsory traffic in bf16.
// Design: one block per 8 x 32 spatial tile, one thread per pixel, looping
// over all D in order with no atomics, so the result is the same from run
// to run.  dx is K2's stencil run on gbar with the transposed guidance: the
// thread gathers gT_k(q, o') = g_k(q+o', -o') of its pixel once (75
// registers, zero where q+o' leaves the image), and each gbar value of a
// slice s read from shared memory feeds three accumulators: dx(s) by gT0,
// dx(s-1) by gT1, dx(s+1) by gT2.  dg keeps its pixel's 75 sums in f32
// registers for the whole D loop: each x value of slice s feeds
// dg0 += gbar(s) x, dg1 += gbar(s+1) x, dg2 += gbar(s-1) x.  Slices of x
// and gbar with an R-pixel halo are double-buffered through shared memory,
// the next slice loaded into registers during the current one's
// arithmetic; x and gbar are read from HBM once plus their halo.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTW = 32;  // tile width (threads along W)
constexpr int kTH = 8;   // tile height (threads along H)
constexpr int kThreads = kTW * kTH;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1)
lga_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ gbar,
               T* __restrict__ dx, T* __restrict__ dg, int D, int H, int W) {
  constexpr int K = 2 * R + 1;
  constexpr int KK = K * K;
  constexpr int TWP = kTW + 2 * R;
  constexpr int THP = kTH + 2 * R;
  constexpr int kTile = TWP * THP;
  constexpr int kPer = (kTile + kThreads - 1) / kThreads;
  __shared__ float xt[2][kTile];
  __shared__ float bt[2][kTile];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const int h = h0 + ty, w = w0 + tx;
  const bool valid = h < H && w < W;
  const long long plane = (long long)H * W;
  const long long pix = valid ? (long long)h * W + w : 0;
  const T* xb = x + (long long)b * D * plane;
  const T* bb = gbar + (long long)b * D * plane;
  const T* gb = g + (long long)b * 3 * KK * plane;
  T* dxb = dx + (long long)b * D * plane + pix;

  // Transposed guidance of this pixel: slot (k, iy, ix) holds g_k at the
  // source pixel q + o' (o' = (iy - R, ix - R)) for the offset -o'.
  float gt[3][KK];
#pragma unroll
  for (int iy = 0; iy < K; ++iy)
#pragma unroll
    for (int ix = 0; ix < K; ++ix) {
      const int sy = h + iy - R, sx = w + ix - R;
      const bool in = valid && sy >= 0 && sy < H && sx >= 0 && sx < W;
      const long long sp = in ? (long long)sy * W + sx : 0;
      const int o_src = (K - 1 - iy) * K + (K - 1 - ix);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gt[k][iy * K + ix] = in ? to_f32(gb[(k * KK + o_src) * plane + sp]) : 0.f;
    }

  float dgr[3][KK];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int o = 0; o < KK; ++o) dgr[k][o] = 0.f;

  // Slice s of the haloed tiles of x and gbar into registers (zero outside
  // the image), and this pixel's gbar at slice s.
  auto fetch = [&](int s, float (&xv)[kPer], float (&bv)[kPer]) {
    const T* xs = xb + s * plane;
    const T* bs = bb + s * plane;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      const int gy = h0 + e / TWP - R, gx = w0 + e % TWP - R;
      const bool in = e < kTile && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const long long off = in ? (long long)gy * W + gx : 0;
      xv[i] = in ? to_f32(xs[off]) : 0.f;
      bv[i] = in ? to_f32(bs[off]) : 0.f;
    }
  };
  auto stash = [&](int buf, const float (&xv)[kPer], const float (&bv)[kPer]) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < kTile) {
        xt[buf][e] = xv[i];
        bt[buf][e] = bv[i];
      }
    }
  };
  auto own = [&](int s) { return valid && s >= 0 && s < D ? to_f32(bb[s * plane + pix]) : 0.f; };

  float px[kPer], pb[kPer];
  fetch(0, px, pb);
  stash(0, px, pb);
  __syncthreads();

  float gb_prev = 0.f;    // gbar(p, s-1)
  float gb_cur = own(0);  // gbar(p, s)
  float acc_prev = 0.f;   // dx(s-1): still needs gT1 * gbar(s)
  float acc_cur = 0.f;    // dx(s):   needs gT0 * gbar(s), later gT1 * gbar(s+1)
  for (int s = 0; s < D; ++s) {
    if (s + 1 < D) fetch(s + 1, px, pb);
    const float gb_next = own(s + 1);
    const int t0 = ty * TWP + tx;
    const float* xs = xt[s & 1] + t0;
    const float* bs = bt[s & 1] + t0;
    float acc_next = 0.f;  // dx(s+1): gT2 * gbar(s)
#pragma unroll
    for (int iy = 0; iy < K; ++iy)
#pragma unroll
      for (int ix = 0; ix < K; ++ix) {
        const int o = iy * K + ix;
        const float v = bs[iy * TWP + ix];
        acc_cur = fmaf(gt[0][o], v, acc_cur);
        acc_prev = fmaf(gt[1][o], v, acc_prev);
        acc_next = fmaf(gt[2][o], v, acc_next);
        const float u = xs[iy * TWP + ix];
        dgr[0][o] = fmaf(gb_cur, u, dgr[0][o]);
        dgr[1][o] = fmaf(gb_next, u, dgr[1][o]);
        dgr[2][o] = fmaf(gb_prev, u, dgr[2][o]);
      }
    if (s > 0 && valid) dxb[(s - 1) * plane] = from_f32<T>(acc_prev);
    acc_prev = acc_cur;
    acc_cur = acc_next;
    gb_prev = gb_cur;
    gb_cur = gb_next;
    if (s + 1 < D) stash((s + 1) & 1, px, pb);
    __syncthreads();
  }
  if (valid) {
    dxb[(D - 1) * plane] = from_f32<T>(acc_prev);
    T* dgp = dg + (long long)b * 3 * KK * plane + pix;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int o = 0; o < KK; ++o) dgp[(k * KK + o) * plane] = from_f32<T>(dgr[k][o]);
  }
}

template <typename T, int R>
cudaError_t launch(const void* x, const void* g, const void* gbar, void* dx, void* dg, int B,
                   int D, int H, int W, cudaStream_t stream) {
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  dim3 block(kTW, kTH);
  lga_bwd_kernel<T, R><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(gbar),
      static_cast<T*>(dx), static_cast<T*>(dg), D, H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, const void* gbar, void* dx, void* dg, int B,
                     int D, int H, int W, int radius, cudaStream_t stream) {
  if (radius == 1) return launch<T, 1>(x, g, gbar, dx, dg, B, D, H, W, stream);
  if (radius == 2) return launch<T, 2>(x, g, gbar, dx, dg, B, D, H, W, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, gbar, dx: (B, D, H, W); g, dg: (B, 3*(2*radius+1)^2, H, W); all
// contiguous and of one dtype (0 = float32, 1 = bfloat16); radius 1 or 2.
// Returns the CUDA error of the launch (0 on success).
int lga_bwd(const void* x, const void* g, const void* gbar, void* dx, void* dg, int B, int D,
            int H, int W, int radius, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, g, gbar, dx, dg, B, D, H, W, radius, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, g, gbar, dx, dg, B, D, H, W, radius, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
