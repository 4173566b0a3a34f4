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
// that is 14.6 GFLOP against 0.15 GB of compulsory traffic in bf16.  Each
// shared-memory word read feeds 3 FMAs, so shared-memory bandwidth (32
// words a clock an SM against 128 FMAs) and instruction issue bind next.
//
// Design: one block of 512 threads per 8 x 32 spatial tile, two kinds of
// warps over one shared slab, each thread holding about 90 live values
// instead of 150, so twice the warps fit on an SM (16):
//  - dx warps, one thread a pixel: K2's stencil run on gbar with the
//    transposed guidance gT_k(q, o') = g_k(q+o', -o') in 75 registers
//    (zero where q+o' leaves the image).  Each gbar value of slice s feeds
//    three fresh per-slice sums, c0 for dx(s), c1 for dx(s-1), c2 for
//    dx(s+1): 12 independent chains a chunk, none running across chunks;
//    dx(s-1) leaves once slice s is done.
//  - dg warps, one thread a pixel: the pixel's 75 sums in f32 registers for
//    the whole D loop; each x value of slice s feeds dg0 by gbar(p, s), dg1
//    by gbar(p, s+1) and dg2 by gbar(p, s-1), the pixel's own gbar read
//    from the slab.
// The slab holds a chunk of kC = 4 slices of x and kC + 1 of gbar (the
// extra slice is the dg warps' gbar(p, s+1) at the chunk's end) with an
// R-pixel halo, widened to f32, each position's 4 slices side by side, so
// one 16-byte shared load feeds 12 FMAs of four independent slices.  Two
// buffers: thread tid < kSlice loads haloed position tid of the next
// chunk's 9 slices into registers while the current chunk is consumed
// (stepping a pointer a plane a slice), and stores them after it, so there
// is one block barrier a chunk (48 at D = 192, against 192 when a barrier
// ended every slice).  Sums run over D in order with no atomics, so the
// result is the same from run to run.
//
// Layouts timed on an H100 (PERF.md): a cp.async ring of 4-byte
// copies, each thread widening its own words, and staging spread over
// every warp both lost to this register staging; a 4 x 32 tile (two blocks
// an SM) lost too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTW = 32;                 // tile width (pixels along W, one warp)
constexpr int kTH = 8;                  // tile height (pixels along H)
constexpr int kPix = kTW * kTH;         // pixels a tile, threads a role
constexpr int kThreads = 2 * kPix;      // dx threads, then dg threads
static_assert(kPix % 32 == 0, "a warp takes one role: the roles' barriers are warp-uniform");
constexpr int kC = 4;                   // disparity slices a chunk: one float4
static_assert(kC == 4, "a position's chunk is read as one float4");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int R>
struct Tile {
  static constexpr int K = 2 * R + 1;
  static constexpr int KK = K * K;
  static constexpr int TWP = kTW + 2 * R;        // haloed width (the row pitch)
  static constexpr int THP = kTH + 2 * R;        // haloed height
  static constexpr int kSlice = TWP * THP;       // positions of a haloed slice
  static constexpr int kSlices = 2 * kC + 1;     // x slices, then gbar slices, a chunk
  // A buffer: x [kSlice][kC], gbar [kSlice][kC], gbar's extra slice [kSlice].
  static constexpr int kGbar = kC * kSlice;      // offset of gbar in a buffer
  static constexpr int kExtra = 2 * kC * kSlice; // offset of the extra slice
  static constexpr int kBuf = kSlices * kSlice;  // floats a buffer
  static_assert(kSlice % 4 == 0, "buffers and their parts start 16-byte aligned");
  static_assert(kSlice <= kThreads, "one staged position a thread");
};

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1)
lga_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ gbar,
               T* __restrict__ dx, T* __restrict__ dg, int D, int H, int W) {
  using L = Tile<R>;
  constexpr int K = L::K, KK = L::KK, TWP = L::TWP;
  __shared__ __align__(16) float slab[2 * L::kBuf];  // each position's kC slices side by side

  const int tid = threadIdx.x;
  const bool dg_role = tid >= kPix;
  const int pi = dg_role ? tid - kPix : tid;
  const int ty = pi / kTW, tx = pi % kTW;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const int h = h0 + ty, w = w0 + tx;
  const bool valid = h < H && w < W;
  const long long plane = (long long)H * W;
  const long long pix = valid ? (long long)h * W + w : 0;
  const T* xb = x + (long long)b * D * plane;
  const T* bb = gbar + (long long)b * D * plane;

  // Staging: thread tid < kSlice owns haloed position tid of every slice.
  // Its element of slice s of x is px[s * plane] (likewise of gbar), read
  // by stepping a pointer a plane at a time.
  const int gy = h0 + tid / TWP - R, gx = w0 + tid % TWP - R;
  const bool in_img = tid < L::kSlice && gy >= 0 && gy < H && gx >= 0 && gx < W;
  const long long soff = in_img ? (long long)gy * W + gx : 0;
  const T* const px = xb + soff;
  const T* const pb = bb + soff;
  T pre[L::kSlices];
  auto fetch = [&](int c0) {
    const T* q = px + c0 * plane;
#pragma unroll
    for (int j = 0; j < kC; ++j, q += plane) pre[j] = in_img && c0 + j < D ? *q : from_f32<T>(0.f);
    q = pb + c0 * plane;
#pragma unroll
    for (int j = 0; j <= kC; ++j, q += plane)
      pre[kC + j] = in_img && c0 + j < D ? *q : from_f32<T>(0.f);
  };
  auto stash = [&](int buf) {
    if (tid >= L::kSlice) return;
    float* dst = slab + buf * L::kBuf;
    *reinterpret_cast<float4*>(dst + tid * kC) =
        make_float4(to_f32(pre[0]), to_f32(pre[1]), to_f32(pre[2]), to_f32(pre[3]));
    *reinterpret_cast<float4*>(dst + L::kGbar + tid * kC) =
        make_float4(to_f32(pre[4]), to_f32(pre[5]), to_f32(pre[6]), to_f32(pre[7]));
    dst[L::kExtra + tid] = to_f32(pre[8]);
  };

  const int nchunks = (D + kC - 1) / kC;
  fetch(0);
  stash(0);
  __syncthreads();

  // The two roles run in separate branches so that each keeps only its own
  // 75 values live.  Each branch ends every chunk with the same
  // __syncthreads, nchunks times and no other: a change to one role's loop
  // must keep that count, or the block hangs.
  if (!dg_role) {
    // Transposed guidance of this pixel: slot (k, iy, ix) holds g_k at the
    // source pixel q + o' (o' = (iy - R, ix - R)) for the offset -o'.
    const T* gb = g + (long long)b * 3 * KK * plane;
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
    T* dxp = dx + (long long)b * D * plane + pix;
    float part_prev = 0.f;  // dx(s-1) without its gT1 * gbar(s) term
    float part_cur = 0.f;   // dx(s) so far: gT2 * gbar(s-1)
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * kC;
      if (c + 1 < nchunks) fetch(c0 + kC);
      const float* bs = slab + (c & 1) * L::kBuf + L::kGbar + (ty * TWP + tx) * kC;
      float cs[3][kC];  // this chunk's gT0, gT1, gT2 sums, a slice each
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < kC; ++j) cs[k][j] = 0.f;
#pragma unroll
      for (int iy = 0; iy < K; ++iy)
#pragma unroll
        for (int ix = 0; ix < K; ++ix) {
          const int o = iy * K + ix;
          const float4 q = *reinterpret_cast<const float4*>(bs + (iy * TWP + ix) * kC);
          const float v[kC] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int j = 0; j < kC; ++j) {
            cs[0][j] = fmaf(gt[0][o], v[j], cs[0][j]);
            cs[1][j] = fmaf(gt[1][o], v[j], cs[1][j]);
            cs[2][j] = fmaf(gt[2][o], v[j], cs[2][j]);
          }
        }
      T* dq = dxp + (c0 - 1) * plane;  // dx(c0 - 1 + j), stepped a plane a slice
#pragma unroll
      for (int j = 0; j < kC; ++j, dq += plane) {
        const int s = c0 + j;
        if (valid && s >= 1 && s <= D) *dq = from_f32<T>(part_prev + cs[1][j]);
        part_prev = part_cur + cs[0][j];
        part_cur = cs[2][j];
      }
      if (c + 1 < nchunks) stash((c + 1) & 1);
      __syncthreads();
    }
    // dx(D-1) is still open when the last chunk ended on slice D-1.
    if (valid && nchunks * kC == D) dxp[(D - 1) * plane] = from_f32<T>(part_prev);
  } else {
    float dgr[3][KK];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int o = 0; o < KK; ++o) dgr[k][o] = 0.f;
    const int own = (ty + R) * TWP + tx + R;  // this pixel's haloed position
    float gb_prev = 0.f;                      // gbar(p, c0 - 1)
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks) fetch(c * kC + kC);
      const float* buf = slab + (c & 1) * L::kBuf;
      const float* xs = buf + (ty * TWP + tx) * kC;
      // gb[j + 1] = gbar(p, c0 + j), j = -1 .. kC.
      const float4 q = *reinterpret_cast<const float4*>(buf + L::kGbar + own * kC);
      const float gb[kC + 2] = {gb_prev, q.x, q.y, q.z, q.w, buf[L::kExtra + own]};
#pragma unroll
      for (int iy = 0; iy < K; ++iy)
#pragma unroll
        for (int ix = 0; ix < K; ++ix) {
          const int o = iy * K + ix;
          const float4 u4 = *reinterpret_cast<const float4*>(xs + (iy * TWP + ix) * kC);
          const float u[kC] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
          for (int j = 0; j < kC; ++j) {
            dgr[0][o] = fmaf(gb[j + 1], u[j], dgr[0][o]);
            dgr[1][o] = fmaf(gb[j + 2], u[j], dgr[1][o]);
            dgr[2][o] = fmaf(gb[j], u[j], dgr[2][o]);
          }
        }
      gb_prev = gb[kC];
      if (c + 1 < nchunks) stash((c + 1) & 1);
      __syncthreads();
    }
    if (valid) {
      T* dgp = dg + (long long)b * 3 * KK * plane + pix;
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int o = 0; o < KK; ++o) dgp[(k * KK + o) * plane] = from_f32<T>(dgr[k][o]);
    }
  }
}

template <typename T, int R>
cudaError_t launch(const void* x, const void* g, const void* gbar, void* dx, void* dg, int B,
                   int D, int H, int W, cudaStream_t stream) {
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  lga_bwd_kernel<T, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(gbar),
      static_cast<T*>(dx), static_cast<T*>(dg), D, H, W);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t describe(int B, int H, int W, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, lga_bwd_kernel<T, R>);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lga_bwd_kernel<T, R>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int blocks = ((W + kTW - 1) / kTW) * ((H + kTH - 1) / kTH) * B;
  const int v[] = {attr.numRegs, (int)attr.sharedSizeBytes, 0,
                   (int)attr.localSizeBytes, per_sm, kThreads, kTH, kTW, kC, blocks};
  for (int i = 0; i < 10; ++i) info[i] = v[i];
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, const void* gbar, void* dx, void* dg, int B,
                     int D, int H, int W, int radius, cudaStream_t stream) {
  if (radius == 1) return launch<T, 1>(x, g, gbar, dx, dg, B, D, H, W, stream);
  if (radius == 2) return launch<T, 2>(x, g, gbar, dx, dg, B, D, H, W, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_describe(int B, int H, int W, int radius, int* info) {
  if (radius == 1) return describe<T, 1>(B, H, W, info);
  if (radius == 2) return describe<T, 2>(B, H, W, info);
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

// What `lga_bwd` with these arguments launches, without launching (one
// kernel a launch): info[0..9] = registers a thread, static shared memory
// a block (bytes), dynamic shared memory a block (bytes), local memory a
// thread (bytes; spills), blocks an SM (occupancy), threads a block, tile
// height, tile width, disparity slices a chunk, blocks in the grid.
int lga_bwd_describe(int B, int D, int H, int W, int radius, int dtype, int* info) {
  (void)D;
  if (dtype == 0) return dispatch_describe<float>(B, H, W, radius, info);
  if (dtype == 1) return dispatch_describe<__nv_bfloat16>(B, H, W, radius, info);
  return cudaErrorInvalidValue;
}

}  // extern "C"
