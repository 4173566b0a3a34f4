// LGA stencil, forward (local guided aggregation), for Hopper.
//
// Replaces the TPU kernel `_make_fwd_kernel_v2` launched by `_lga_once` in
// ganet_tpu/ops/lga_pallas.py.
//
// One launch is one LGA pass over a (B, D, H, W) volume with guidance
// g (B, 3*K*K, H, W), K = 2R+1, channels in (k, dy, dx) row-major order:
//
//   out(p, d) = sum_{|dy|,|dx| <= R} g0(p) x(p+o, d) + g1(p) x(p+o, d-1)
//                                  + g2(p) x(p+o, d+1)
//
// with zeros outside the image and outside [0, D).  x, g and out are
// contiguous, of one dtype (float32 or bfloat16); sums are f32 and the
// output is rounded once to the input dtype.
//
// Bound on this card: operations.  Each output takes 3*K*K = 75 f32 FMAs
// off the tensor cores; at (1, 192, 576, 960) that is 15.9 GFLOP against
// 0.5 GB of compulsory traffic in bf16, so the 67 TFLOP/s of f32 binds
// before the 3.35 TB/s of HBM.  Each shared-memory word read feeds 3 FMAs,
// so shared-memory bandwidth and instruction issue bind next: the design
// spends as few instructions as it can besides the FMAs.
//
// Design (the dx warps of lga_bwd.cu standing alone): one block of 256
// threads per 8 x 32 pixel tile, one thread a pixel, holding the pixel's
// 75 guidance values in registers for the whole D loop (the guidance is
// read once, the reuse the TPU kernel got by keeping it resident in VMEM).
// The block walks the disparity slices in chunks of kC = 4 through a
// shared slab with an R-pixel halo, in f32, each haloed position's kC
// slices side by side, so one 16-byte shared load feeds 12 FMAs of kC
// independent slices (25 loads for a chunk's 300 FMAs at R = 2).  Each
// slice t of a chunk gets three fresh sums, cs0 (g0, for out(t)), cs1
// (g1, for out(t+1)) and cs2 (g2, for out(t-1)): 12 independent chains,
// none running across chunks.  They are combined in a fixed order,
// out(t) = (cs1(t-1) + cs0(t)) + cs2(t+1), through two carries in
// registers, and out(t-1) leaves once slice t is summed; out(D-1) is
// flushed after the last chunk.  There are no atomics, so the result is
// the same from run to run.
//
// Two buffers and one block barrier a chunk (48 at D = 192, against 192
// when a barrier ended every slice): while the current chunk is summed,
// the next is staged into the other buffer, which every thread left at
// the last barrier.  Each thread owns up to 2 haloed positions, worked out
// once before the loop, and steps a pointer a chunk at a time.  float32 is
// copied straight into the slab by 4-byte cp.async (no registers held);
// bfloat16 is loaded into registers and widened to f32 as it is stored
// after the chunk.  Only the first and the last two chunks test their
// slices against D.  256 threads at no more than 128 registers leave two
// blocks an SM, so one block's barrier does not drain the SM.
//
// Layouts timed on an H100 (PERF.md): one slice at a time through a
// double-buffered tile with a barrier a slice (the first port) lost to
// this one; so did float32 staged through registers (the compiler sank
// the loads to the chunk's end), 8-slice chunks, a bf16 slab for bf16
// inputs (an unpack for each value read), and a 16 x 32 tile of 512
// threads (one block an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTW = 32;              // tile width (pixels along W, one warp)
constexpr int kTH = 8;               // tile height (pixels along H)
constexpr int kThreads = kTW * kTH;  // one thread a pixel
constexpr int kMinBlocks = 2;        // blocks an SM the register budget aims at
constexpr int kC = 4;                // disparity slices a chunk
static_assert(kC % 4 == 0, "a position's chunk is read as float4s");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 4-byte asynchronous copy global -> shared; with src_bytes 0 it writes a
// zero and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int R>
struct Tile {
  static constexpr int K = 2 * R + 1;
  static constexpr int KK = K * K;
  static constexpr int TWP = kTW + 2 * R;                  // haloed width (the row pitch)
  static constexpr int THP = kTH + 2 * R;                  // haloed height
  static constexpr int kSlice = TWP * THP;                 // positions of a haloed slice
  static constexpr int kPer = (kSlice + kThreads - 1) / kThreads;  // staged positions a thread
  static constexpr int kBuf = kC * kSlice;                 // floats a buffer: [position][kC]
  static_assert(kBuf % 4 == 0, "both buffers start 16-byte aligned");
  static_assert(kSlice > (kPer - 1) * kThreads, "a thread's positions but the last lie in the slice");
};

template <bool B> struct Flag { static constexpr bool value = B; };

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lga_fwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ out,
               int D, int H, int W) {
  using L = Tile<R>;
  constexpr int K = L::K, KK = L::KK, TWP = L::TWP;
  __shared__ __align__(16) float slab[2 * L::kBuf];  // each position's kC slices side by side

  const int tid = threadIdx.x;
  const int ty = tid / kTW, tx = tid % kTW;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const int h = h0 + ty, w = w0 + tx;
  const bool valid = h < H && w < W;
  const long long plane = (long long)H * W;
  const long long pix = valid ? (long long)h * W + w : 0;

  // Staging: this thread owns haloed positions tid + i * kThreads of every
  // slice; src[i] points at the next chunk's first slice.  float32 is copied
  // straight into the slab by cp.async (no registers held across the chunk;
  // zeros by a 0-byte source); bfloat16 is loaded into registers and widened
  // as it is stored.  Positions outside the image (or past the slice) are
  // never loaded: their registers keep the zeros they start with.
  constexpr bool kCopy = sizeof(T) == sizeof(float);
  const T* src[L::kPer];
  bool in_img[L::kPer];
  const T* xb = x + (long long)b * D * plane;
#pragma unroll
  for (int i = 0; i < L::kPer; ++i) {
    const int e = tid + i * kThreads;
    const int gy = h0 + e / TWP - R, gx = w0 + e % TWP - R;
    in_img[i] = e < L::kSlice && gy >= 0 && gy < H && gx >= 0 && gx < W;
    src[i] = xb + (in_img[i] ? (long long)gy * W + gx : 0);
  }
  T pre[L::kPer][kC];
#pragma unroll
  for (int i = 0; i < L::kPer; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) pre[i][j] = from_f32<T>(0.f);
  // The next chunk, c0 .. c0 + kC - 1, bound for the buffer at dst; `left`
  // = D - c0 slices remain (a full chunk needs no guard).
  auto fetch = [&](auto full, int left, float* dst) {
#pragma unroll
    for (int i = 0; i < L::kPer; ++i) {
      const int e = tid + i * kThreads;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const bool ok = in_img[i] && (decltype(full)::value || j < left);
        if constexpr (kCopy) {
          if (i + 1 < L::kPer || e < L::kSlice)
            cp_async4(dst + e * kC + j, src[i] + j * plane, ok ? 4 : 0);
        } else if (decltype(full)::value) {
          if (ok) pre[i][j] = src[i][j * plane];
        } else {
          pre[i][j] = ok ? src[i][j * plane] : from_f32<T>(0.f);
        }
      }
      src[i] += kC * plane;
    }
    if constexpr (kCopy) cp_async_commit();
  };
  // The fetched chunk into the buffer at dst (for cp.async: this thread's
  // copies have landed); the block barrier that follows publishes it.
  auto stash = [&](float* dst) {
    if constexpr (kCopy) {
      cp_async_wait_all();
    } else {
#pragma unroll
      for (int i = 0; i < L::kPer; ++i) {
        const int e = tid + i * kThreads;
        if (i + 1 < L::kPer || e < L::kSlice)
#pragma unroll
          for (int j = 0; j < kC; j += 4)
            *reinterpret_cast<float4*>(dst + e * kC + j) =
                make_float4(to_f32(pre[i][j]), to_f32(pre[i][j + 1]), to_f32(pre[i][j + 2]),
                            to_f32(pre[i][j + 3]));
      }
    }
  };

  const int nchunks = (D + kC - 1) / kC;
  fetch(Flag<false>(), D, slab);
  // The guidance after the first chunk's register staging, so that the two
  // do not hold registers at once; the copies run under the guidance loads.
  if constexpr (!kCopy) stash(slab);
  float gr[3][KK];
  {
    const T* gp = g + (long long)b * 3 * KK * plane + pix;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int o = 0; o < KK; ++o) gr[k][o] = valid ? to_f32(gp[(k * KK + o) * plane]) : 0.f;
  }
  if constexpr (kCopy) stash(slab);
  __syncthreads();

  T* oq = out + (long long)b * D * plane + pix - plane;  // out(c0 - 1), stepped a chunk at a time
  float part_prev = 0.f;  // out(t-1) without its g2 * x(t) sum
  float part_cur = 0.f;   // out(t) so far: its g1 * x(t-1) sum
  int cur = 0;            // offset of the buffer being summed (0 or kBuf)
  // One chunk.  An interior chunk (c >= 1, the next chunk full) needs no
  // guard on its slices: only the first and the last two chunks take them.
  auto step = [&](auto interior, int c) {
    const int c0 = c * kC;
    // The other buffer was last read in the chunk before, which every
    // thread has left.
    if (decltype(interior)::value) {
      fetch(Flag<true>(), D - c0 - kC, slab + (cur ^ L::kBuf));
    } else if (c + 1 < nchunks) {
      fetch(Flag<false>(), D - c0 - kC, slab + (cur ^ L::kBuf));
    }
    const float* xs = slab + cur + (ty * TWP + tx) * kC;
    float cs[3][kC];  // this chunk's g0, g1, g2 sums, a slice each
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < kC; ++j) cs[k][j] = 0.f;
#pragma unroll
    for (int iy = 0; iy < K; ++iy)
#pragma unroll
      for (int ix = 0; ix < K; ++ix) {
        const int o = iy * K + ix;
#pragma unroll
        for (int j4 = 0; j4 < kC; j4 += 4) {
          const float4 q = *reinterpret_cast<const float4*>(xs + (iy * TWP + ix) * kC + j4);
          const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            cs[0][j4 + j] = fmaf(gr[0][o], v[j], cs[0][j4 + j]);
            cs[1][j4 + j] = fmaf(gr[1][o], v[j], cs[1][j4 + j]);
            cs[2][j4 + j] = fmaf(gr[2][o], v[j], cs[2][j4 + j]);
          }
        }
      }
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int t = c0 + j;
      const bool store = decltype(interior)::value ? valid : valid && t >= 1 && t <= D;
      if (store) oq[j * plane] = from_f32<T>(part_prev + cs[2][j]);
      part_prev = part_cur + cs[0][j];
      part_cur = cs[1][j];
    }
    oq += kC * plane;
    cur ^= L::kBuf;
    if (c + 1 < nchunks) stash(slab + cur);
    __syncthreads();
  };
  step(Flag<false>(), 0);
  int c = 1;
  for (; c + 2 <= D / kC; ++c) step(Flag<true>(), c);
  for (; c < nchunks; ++c) step(Flag<false>(), c);
  // out(D-1) is still open when the last chunk ended on slice D-1.
  if (valid && nchunks * kC == D) *oq = from_f32<T>(part_prev);
}

template <typename T, int R>
cudaError_t launch(const void* x, const void* g, void* out, int B, int D, int H, int W,
                   cudaStream_t stream) {
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  lga_fwd_kernel<T, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(out), D, H, W);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t describe(int B, int H, int W, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, lga_fwd_kernel<T, R>);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lga_fwd_kernel<T, R>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int blocks = ((W + kTW - 1) / kTW) * ((H + kTH - 1) / kTH) * B;
  const int v[] = {attr.numRegs, (int)attr.sharedSizeBytes, 0,
                   (int)attr.localSizeBytes, per_sm, kThreads, kTH, kTW, kC, blocks};
  for (int i = 0; i < 10; ++i) info[i] = v[i];
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, void* out, int B, int D, int H, int W,
                     int radius, cudaStream_t stream) {
  if (radius == 1) return launch<T, 1>(x, g, out, B, D, H, W, stream);
  if (radius == 2) return launch<T, 2>(x, g, out, B, D, H, W, stream);
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

// x, out: (B, D, H, W); g: (B, 3*(2*radius+1)^2, H, W); all contiguous and
// of one dtype (0 = float32, 1 = bfloat16); radius 1 or 2.  Returns the
// CUDA error of the launch (0 on success).
int lga_fwd(const void* x, const void* g, void* out, int B, int D, int H, int W, int radius,
            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, g, out, B, D, H, W, radius, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, g, out, B, D, H, W, radius, s);
  return cudaErrorInvalidValue;
}

// What `lga_fwd` with these arguments launches, without launching (one
// kernel a launch): info[0..9] = registers a thread, static shared memory
// a block (bytes), dynamic shared memory a block (bytes), local memory a
// thread (bytes; spills), blocks an SM (occupancy), threads a block, tile
// height, tile width, disparity slices a chunk, blocks in the grid.
int lga_fwd_describe(int B, int D, int H, int W, int radius, int dtype, int* info) {
  (void)D;
  if (dtype == 0) return dispatch_describe<float>(B, H, W, radius, info);
  if (dtype == 1) return dispatch_describe<__nv_bfloat16>(B, H, W, radius, info);
  return cudaErrorInvalidValue;
}

}  // extern "C"
