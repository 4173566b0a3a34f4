// LGA stencil, forward, over a fold of channels (channel-wise LGA, `lga3d`),
// for Hopper.
//
// Replaces the TPU kernel `_make_fwd_kernel` launched by `_lga_once_v1` in
// ganet_tpu/ops/lga_pallas.py: one LGA pass with halo tiles that walks the
// disparity slices innermost while the tile's guidance stays resident.  In
// the JAX package the same per-pass stencil carries `dispatch.lga3d` (the
// reference's Lga3dFunction), which folds the C channels of a (B, C, D, H, W)
// volume into the batch and repeats the guidance C times.
//
// One launch is one pass over x (N, D, H, W), N = B*C fold indices, with
// guidance g (N / gdiv, 3*K*K, H, W), K = 2R+1, channels in (k, dy, dx)
// row-major order; fold index n reads guidance n / gdiv:
//
//   out(n, p, d) = sum_{|dy|,|dx| <= R} g0(p) x(n, p+o, d) + g1(p) x(n, p+o, d-1)
//                                     + g2(p) x(n, p+o, d+1)
//
// with zeros outside the image and outside [0, D) of each fold index.  x, g
// and out are contiguous, of one dtype (float32 or bfloat16); sums are f32.
//
// Bound on this card: operations.  Each output takes 75 f32 FMAs off the
// tensor cores; at (1, 32, 64, 192, 320) that is 18.9 GFLOP (0.28 ms at
// 67 TFLOP/s) against 0.51 GB of compulsory traffic in bf16 (0.15 ms).
//
// Design.  A block owns an 8 x 32 pixel tile of one guidance index b and a
// group of consecutive fold indices b*gdiv + [c0, c0 + nc).  Each thread
// keeps its pixel's 75 guidance values in registers for the whole walk over
// the group's nc x D slices, so the guidance is read once per block and not
// once per channel (the TPU kernel's d-resident guidance, extended across
// the fold).  The haloed x slices, (8 + 2R) x (32 + 2R), enter a 4-slot
// shared-memory ring by 4-byte `cp.async`, three slices ahead of the one
// being summed; out-of-image elements are zero-filled by the copy itself
// (src-size 0).  A bf16 row is copied in 4-byte pairs from the even flat
// index at or below its first column, so its place in shared memory moves
// by that parity; the reader adds it back.  Each slice value read from
// shared memory feeds three accumulators (out(s) by g0, out(s+1) by g1,
// out(s-1) by g2), which restart at each fold index: the walk crosses from
// slice D-1 of one channel to slice 0 of the next without mixing them.  The
// group size is a launch choice: enough groups that the grid holds about
// four blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTW = 32;  // tile width (threads along W)
constexpr int kTH = 8;   // tile height (threads along H)
constexpr int kThreads = kTW * kTH;
constexpr int kSlots = 4;           // slices in the shared-memory ring
constexpr int kAhead = kSlots - 1;  // slices in flight ahead of the one summed
constexpr int kBlocksPerSM = 4;     // grid size the channel grouping aims for

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 4-byte asynchronous copy global -> shared; the bytes past `src_bytes`
// (0, 2 or 4) are filled with zeros and not read.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
lga3d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ out,
                 int D, int H, int W, int gdiv, int cg, int ngroups) {
  constexpr int K = 2 * R + 1;
  constexpr int KK = K * K;
  constexpr int EPU = 4 / sizeof(T);                // elements per 4-byte unit
  constexpr int TWP = kTW + 2 * R;                  // haloed tile width
  constexpr int PW = (TWP + 2 * (EPU - 1)) / EPU;   // units per row, parity shift included
  constexpr int PE = PW * EPU;                      // ... in elements
  constexpr int ROWS = kTH + 2 * R;
  constexpr int SU = ROWS * PW;                     // units per slot
  __shared__ __align__(16) uint32_t ring[kSlots][SU];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int b = blockIdx.z / ngroups;
  const int c0 = (blockIdx.z - b * ngroups) * cg;
  const int nc = min(cg, gdiv - c0);
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const int h = h0 + ty, w = w0 + tx;
  const bool valid = h < H && w < W;
  const long long plane = (long long)H * W;
  const bool odd_plane = (plane & 1) != 0;
  const long long slice0 = ((long long)b * gdiv + c0) * D;  // the block's first slice
  const int steps = nc * D;

  float gr[3][KK];
  {
    const T* gp = g + (long long)b * 3 * KK * plane + (valid ? (long long)h * W + w : 0);
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int o = 0; o < KK; ++o) gr[k][o] = valid ? to_f32(gp[(k * KK + o) * plane]) : 0.f;
  }

  // Parity of the flat index of column w0 - R in halo row r, within a slice
  // (bf16 only); a slice of odd H*W flips it from one slice to the next.
  auto row_parity = [&](int r) -> int {
    if (EPU == 1) return 0;
    const unsigned gy = static_cast<unsigned>(h0 - R + r);
    return static_cast<int>((gy * static_cast<unsigned>(W) + static_cast<unsigned>(w0 - R)) & 1u);
  };
  auto slice_parity = [&](int t) -> int {
    return (EPU == 2 && odd_plane) ? static_cast<int>((slice0 + t) & 1) : 0;
  };

  // Start the copy of step t's haloed slice into its slot; one commit group
  // per call, empty past the last step.
  auto prefetch = [&](int t) {
    if (t < steps) {
      const long long base = (slice0 + t) * plane;
      const int sp = slice_parity(t);
      uint32_t* dst = ring[t % kSlots];
      for (int u = tid; u < SU; u += kThreads) {
        const int r = u / PW;
        const int gy = h0 - R + r;
        const int c = w0 - R - (row_parity(r) ^ sp) + (u - r * PW) * EPU;  // first column
        const bool row_ok = gy >= 0 && gy < H;
        const bool ok0 = row_ok && c >= 0 && c < W;
        const bool ok1 = EPU == 2 && row_ok && c + 1 >= 0 && c + 1 < W;
        const T* src = x + (base + (long long)gy * W + c);
        if (ok0) {
          cp_async4(dst + u, src, (EPU == 1 || ok1) ? 4 : 2);
        } else if (ok1) {
          // bf16 pair (column -1, column 0): only its upper half is in the image.
          dst[u] = static_cast<uint32_t>(__bfloat16_as_ushort(
                       reinterpret_cast<const __nv_bfloat16*>(src)[1])) << 16;
        } else {
          cp_async4(dst + u, x, 0);
        }
      }
    }
    cp_async_commit();
  };

  int rpar[K];
#pragma unroll
  for (int iy = 0; iy < K; ++iy) rpar[iy] = row_parity(ty + iy);

#pragma unroll
  for (int i = 0; i < kAhead; ++i) prefetch(i);

  T* ob = out + slice0 * plane + (valid ? (long long)h * W + w : 0);
  float acc_prev = 0.f;  // out(s-1): still needs g2 * x(s)
  float acc_cur = 0.f;   // out(s):   needs g0 * x(s), later g2 * x(s+1)
  int s = 0;             // slice of the current fold index
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of step t have landed
    __syncthreads();              // ... everyone's, and step t-1's reads are done
    prefetch(t + kAhead);         // into the slot step t-1 read

    const T* tile = reinterpret_cast<const T*>(ring[t % kSlots]);
    const int sp = slice_parity(t);
    float acc_next = 0.f;  // out(s+1): g1 * x(s)
#pragma unroll
    for (int iy = 0; iy < K; ++iy) {
      const T* row = tile + (ty + iy) * PE + (rpar[iy] ^ sp) + tx;
#pragma unroll
      for (int ix = 0; ix < K; ++ix) {
        const int o = iy * K + ix;
        const float v = to_f32(row[ix]);
        acc_cur = fmaf(gr[0][o], v, acc_cur);
        acc_prev = fmaf(gr[2][o], v, acc_prev);
        acc_next = fmaf(gr[1][o], v, acc_next);
      }
    }
    if (s > 0 && valid) ob[(s - 1) * plane] = from_f32<T>(acc_prev);
    acc_prev = acc_cur;
    acc_cur = acc_next;
    if (s == D - 1) {  // the fold index ends: flush out(D-1), restart the sums
      if (valid) ob[(D - 1) * plane] = from_f32<T>(acc_prev);
      acc_prev = acc_cur = 0.f;
      ob += D * plane;
      s = 0;
    } else {
      ++s;
    }
  }
}

template <typename T, int R>
cudaError_t launch(const void* x, const void* g, void* out, int N, int D, int H, int W,
                   int gdiv, cudaStream_t stream) {
  const int tiles_w = (W + kTW - 1) / kTW, tiles_h = (H + kTH - 1) / kTH;
  const int nb = N / gdiv;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // Split each fold's channels into groups until the grid holds about
  // kBlocksPerSM blocks per SM; each group re-reads the guidance once.
  const long long tiles = (long long)tiles_w * tiles_h * nb;
  const long long want = (long long)kBlocksPerSM * sms;
  long long splits = (want + tiles - 1) / tiles;
  if (splits > gdiv) splits = gdiv;
  if (splits < 1) splits = 1;
  const int cg = (int)((gdiv + splits - 1) / splits);
  const int ngroups = (gdiv + cg - 1) / cg;
  if ((long long)nb * ngroups > 65535 || tiles_h > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(tiles_w, tiles_h, nb * ngroups);
  dim3 block(kTW, kTH);
  lga3d_fwd_kernel<T, R><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(out), D, H, W, gdiv,
      cg, ngroups);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, void* out, int N, int D, int H, int W,
                     int gdiv, int radius, cudaStream_t stream) {
  if (radius == 1) return launch<T, 1>(x, g, out, N, D, H, W, gdiv, stream);
  if (radius == 2) return launch<T, 2>(x, g, out, N, D, H, W, gdiv, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, out: (N, D, H, W); g: (N / gdiv, 3*(2*radius+1)^2, H, W); all contiguous,
// of one dtype (0 = float32, 1 = bfloat16), x 4-byte aligned; gdiv divides N;
// radius 1 or 2.  Returns the CUDA error of the launch (0 on success).
int lga3d_fwd(const void* x, const void* g, void* out, int N, int D, int H, int W, int gdiv,
              int radius, int dtype, void* stream) {
  if (gdiv < 1 || N % gdiv != 0 || D < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 4 != 0) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, g, out, N, D, H, W, gdiv, radius, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, g, out, N, D, H, W, gdiv, radius, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
