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
// and out are contiguous, of one dtype (float32 or bfloat16); sums are f32
// and the output is rounded once to the input dtype.
//
// Bound on this card: operations in bfloat16, bytes in float32.  Each
// output takes 3*K*K = 75 f32 FMAs off the tensor cores; at `lga3d`'s
// (1, 32, 64, 192, 320) that is 18.9 GFLOP (0.282 ms at 67 TFLOP/s)
// against 0.51 GB of compulsory traffic in bf16 (0.153 ms at 3.35 TB/s)
// and 1.03 GB in f32 (0.306 ms).  Each shared-memory word read feeds 3
// FMAs, so shared-memory bandwidth and instruction issue bind next: the
// design spends as few instructions as it can besides the FMAs.
//
// Design: the LGA forward of lga_fwd.cu (K2) with a walk over channels.
// One block of 256 threads per 8 x 32 pixel tile of one guidance index b,
// one thread a pixel, holding the pixel's 75 guidance values in registers.
// The block owns a group of consecutive fold indices b*gdiv + [ch0, ch0 +
// nc) and walks them in order, so the guidance is read once for all the
// channels of the group (the TPU kernel's d-resident guidance, extended
// across the fold).  The group's channels lie one after another in memory,
// so their slices are one run of S = nc*D, which the block walks as K2
// walks D: in chunks of kC = 4 through a shared slab with an R-pixel halo,
// in f32, each haloed position's kC slices side by side, so one 16-byte
// shared load feeds 12 FMAs.  Each slice t gets three fresh sums, cs0 (g0,
// for out(t)), cs1 (g1, for out(t+1)) and cs2 (g2, for out(t-1)), combined
// in K2's fixed order, out(t) = (cs1(t-1) + cs0(t)) + cs2(t+1), through two
// carries in registers.  Where slice t starts a channel, out(t-1) takes a
// zero for cs2(t) and out(t) a zero for cs1(t-1), the zeros K2 takes past
// D: so no output sums another channel's slices, at gdiv 1 the two kernels
// agree bit for bit, and every channel of a walk equals that channel run
// alone.  When D is a whole number of chunks, boundaries fall on a chunk's
// first slice and an interior chunk cuts them by two selects; otherwise a
// chunk with a boundary inside takes the guarded path.  No atomics.
//
// Two buffers and one block barrier a chunk: while the current chunk is
// summed, the next is loaded into registers, then widened to f32 and
// stored into the other buffer, which every thread left at the last
// barrier.  Each thread stages up to 2 haloed positions from addresses
// clamped into the image, worked out once, so a full chunk loads without a
// guard; positions outside the image are stored as zeros.  Only the run's
// first and last two chunks test slices against S.  256 threads at no more
// than 128 registers (0 B of local memory) leave two blocks an SM.
//
// The group size (`group_size`): a block's walk costs a fixed part (the
// guidance, the first chunk) and a part per channel, and the grid runs in
// waves of the blocks the card holds at once.  The rule takes the cg that
// makes waves x (cg + kBlockCost channels) least, the larger on a tie: at
// (1, 32, 64, 192, 320) one group of 32 (240 blocks in 264 slots), at
// (2, 32, 64, 80, 176) two groups of 16 (240 blocks).  Fixed groups of 1 to
// 32 timed: at the full-res volume 4 to 32 within 2 % of each other and 1
// about 8 % slower; at the training crop one group of 32 (half the card
// idle) about 55 % slower, 2 to 16 within 3 %.
//
// Layouts timed on an H100 (PERF.md; chip_smoke.py phase 13 on edited
// copies), all lost to this one: the first port (one slice at a time
// through a 4-slot ring of bf16 rows, a barrier a slice); a channel loop
// that restarts the chunk grid at each channel (its ragged pointer steps
// and carries cost registers: 72-88 B of spills at radius 2); chunks across
// channels in one loop that branches between the interior and the guarded
// step (no spills, but a loop twice as long: 4 % slower in f32); an
// interior loop per channel (spills);
// f32 by 4-byte cp.async, K2's f32 staging (5 % slower: a warp's copies
// write 4 words to a bank), also with a lane-swizzled slice order (spills);
// bf16 loads guarded by the in-image test, K2's (ptxas placed them after
// most of the FMAs, so their latency stood before the barrier: 17 %
// slower); bf16 staged in packed pairs (slower).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTW = 32;              // tile width (pixels along W, one warp)
constexpr int kTH = 8;               // tile height (pixels along H)
constexpr int kThreads = kTW * kTH;  // one thread a pixel
constexpr int kMinBlocks = 2;        // blocks an SM the register budget aims at
constexpr int kC = 4;                // disparity slices a chunk
static_assert(kC % 4 == 0, "a position's chunk is read as float4s");
constexpr float kBlockCost = 0.25f;  // a block's fixed cost, in channels of its walk

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
lga3d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ out,
                 int D, int H, int W, int gdiv, int cg, int ngroups) {
  using L = Tile<R>;
  constexpr int K = L::K, KK = L::KK, TWP = L::TWP;
  __shared__ __align__(16) float slab[2 * L::kBuf];  // each position's kC slices side by side

  const int tid = threadIdx.x;
  const int ty = tid / kTW, tx = tid % kTW;
  const int b = blockIdx.z / ngroups;                    // guidance index
  const int ch0 = (blockIdx.z - b * ngroups) * cg;       // the group's first channel
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const int h = h0 + ty, w = w0 + tx;
  const bool valid = h < H && w < W;
  const long long plane = (long long)H * W;
  const long long pix = valid ? (long long)h * W + w : 0;
  // The walk: the group's channels lie one after another in memory, so
  // their slices are one run of S = nc * D, chunked as one axis.
  const int S = min(cg, gdiv - ch0) * D;
  const long long first = ((long long)b * gdiv + ch0) * D * plane;  // the run's first slice

  // Staging: this thread owns haloed positions tid + i * kThreads of every
  // slice; src[i] points at the next chunk's first slice, at the position
  // clamped into the image, so that a full chunk loads every position
  // without a guard (those outside the image are stored as zeros).  The
  // chunk is loaded into registers at the start of a step and widened to
  // f32 as it is stored, at the step's end.
  const T* src[L::kPer];
  bool in_img[L::kPer];
  const T* xb = x + first;
#pragma unroll
  for (int i = 0; i < L::kPer; ++i) {
    const int e = tid + i * kThreads;
    const int gy = h0 + e / TWP - R, gx = w0 + e % TWP - R;
    in_img[i] = e < L::kSlice && gy >= 0 && gy < H && gx >= 0 && gx < W;
    src[i] = xb + (long long)min(max(gy, 0), H - 1) * W + min(max(gx, 0), W - 1);
  }
  T pre[L::kPer][kC];
#pragma unroll
  for (int i = 0; i < L::kPer; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) pre[i][j] = from_f32<T>(0.f);
  // The next chunk, c0 .. c0 + kC - 1 of the run; `left` = S - c0 slices
  // remain (a full chunk needs no guard).
  auto fetch = [&](auto full, int left) {
#pragma unroll
    for (int i = 0; i < L::kPer; ++i) {
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        if (decltype(full)::value) {
          pre[i][j] = src[i][j * plane];
        } else {
          const bool ok = in_img[i] && j < left;
          pre[i][j] = ok ? src[i][j * plane] : from_f32<T>(0.f);
        }
      }
      src[i] += kC * plane;
    }
  };
  // The fetched chunk into the buffer at dst; the block barrier that
  // follows publishes it.
  auto stash = [&](float* dst) {
#pragma unroll
    for (int i = 0; i < L::kPer; ++i) {
      const int e = tid + i * kThreads;
      if (i + 1 < L::kPer || e < L::kSlice)
#pragma unroll
        for (int j = 0; j < kC; j += 4)
          *reinterpret_cast<float4*>(dst + e * kC + j) =
              in_img[i] ? make_float4(to_f32(pre[i][j]), to_f32(pre[i][j + 1]),
                                      to_f32(pre[i][j + 2]), to_f32(pre[i][j + 3]))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  const int nchunks = (S + kC - 1) / kC;
  fetch(Flag<false>(), S);
  // The guidance after the first chunk's staging, so that the two do not
  // hold registers at once.
  stash(slab);
  float gr[3][KK];
  {
    const T* gp = g + (long long)b * 3 * KK * plane + pix;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int o = 0; o < KK; ++o) gr[k][o] = valid ? to_f32(gp[(k * KK + o) * plane]) : 0.f;
  }
  __syncthreads();

  T* oq = out + first + pix - plane;  // out(c0 - 1), stepped a chunk at a time
  float part_prev = 0.f;  // out(t-1) without its g2 * x(t) sum
  float part_cur = 0.f;   // out(t) so far: its g1 * x(t-1) sum
  int cur = 0;            // offset of the buffer being summed (0 or kBuf)
  int cut = D;            // the next channel boundary: the first slice of the next channel
  // One chunk.  An interior chunk (c >= 1, the next chunk full, a channel
  // boundary at most at its first slice) needs no guard on its slices, and
  // cuts such a boundary before it combines its sums; the first and last
  // two chunks, and every chunk with a boundary inside it, take the guards.
  auto step = [&](auto interior, int c) {
    const int c0 = c * kC;
    // The next chunk goes into the other buffer at the step's end: that
    // buffer was last read in the chunk before, which every thread has left.
    if (decltype(interior)::value) {
      fetch(Flag<true>(), S - c0 - kC);
    } else if (c + 1 < nchunks) {
      fetch(Flag<false>(), S - c0 - kC);
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
    if (decltype(interior)::value) {  // slice c0 starts a channel: cut as below
      const bool starts = c0 == cut;
      cs[2][0] = starts ? 0.f : cs[2][0];
      part_cur = starts ? 0.f : part_cur;
      cut += starts ? D : 0;
    }
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int t = c0 + j;
      if (decltype(interior)::value) {
        if (valid) oq[j * plane] = from_f32<T>(part_prev + cs[2][j]);
        part_prev = part_cur + cs[0][j];
      } else {
        // Slice t starts a channel: out(t-1) takes no g2 * x(t), out(t) no
        // g1 * x(t-1); zeros in their place, as past D in one channel.
        const bool starts = t == cut;
        if (starts) cut += D;
        if (valid && t >= 1 && t <= S) oq[j * plane] = from_f32<T>(part_prev + (starts ? 0.f : cs[2][j]));
        part_prev = (starts ? 0.f : part_cur) + cs[0][j];
      }
      part_cur = cs[1][j];
    }
    oq += kC * plane;
    cur ^= L::kBuf;
    if (c + 1 < nchunks) stash(slab + cur);
    __syncthreads();
  };
  step(Flag<false>(), 0);
  int c = 1;
  // Channel boundaries fall on chunk starts when D is a whole number of
  // chunks, and there are none inside a run of one channel.
  if (D % kC == 0 || S == D)
    for (; c + 2 <= S / kC; ++c) step(Flag<true>(), c);
  for (; c < nchunks; ++c) step(Flag<false>(), c);
  // out(S-1) is still open when the last chunk ended on slice S-1.
  if (valid && nchunks * kC == S) *oq = from_f32<T>(part_prev);
}

// Channels a block walks (module comment): of the group sizes that split
// gdiv into a given number of groups most evenly, the one that makes waves
// of the grid x (cg + kBlockCost) least, the larger on a tie, within the
// grid's z limit.  `tiles` = pixel tiles x guidance indices nb, `slots` =
// blocks the card holds at once.
int group_size(long long tiles, int gdiv, int nb, long long slots) {
  int best = gdiv;
  float best_cost = -1.f;
  for (int n = 1; n <= gdiv; ++n) {
    const int cg = (gdiv + n - 1) / n;
    const long long ngroups = (gdiv + cg - 1) / cg;
    if ((long long)nb * ngroups > 65535) break;
    const long long waves = (tiles * ngroups + slots - 1) / slots;
    const float cost = waves * (cg + kBlockCost);
    if (best_cost < 0.f || cost < best_cost) best = cg, best_cost = cost;
  }
  return best;
}

template <typename T, int R>
void geometry(int N, int H, int W, int gdiv, dim3* grid, int* cg, int* ngroups) {
  const int tiles_w = (W + kTW - 1) / kTW, tiles_h = (H + kTH - 1) / kTH;
  const int nb = N / gdiv;
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, lga3d_fwd_kernel<T, R>, kThreads, 0);
    return n > 0 ? n : 1;
  }();
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *cg = group_size((long long)tiles_w * tiles_h * nb, gdiv, nb, (long long)sms * per_sm);
  *ngroups = (gdiv + *cg - 1) / *cg;
  *grid = dim3(tiles_w, tiles_h, nb * *ngroups);
}

template <typename T, int R>
cudaError_t launch(const void* x, const void* g, void* out, int N, int D, int H, int W,
                   int gdiv, cudaStream_t stream) {
  dim3 grid;
  int cg = 0, ngroups = 0;
  geometry<T, R>(N, H, W, gdiv, &grid, &cg, &ngroups);
  if ((long long)(N / gdiv) * ngroups > 65535 || grid.y > 65535) return cudaErrorInvalidConfiguration;
  lga3d_fwd_kernel<T, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(out), D, H, W, gdiv,
      cg, ngroups);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t describe(int N, int H, int W, int gdiv, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, lga3d_fwd_kernel<T, R>);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lga3d_fwd_kernel<T, R>, kThreads, 0);
  if (err != cudaSuccess) return err;
  dim3 grid;
  int cg = 0, ngroups = 0;
  geometry<T, R>(N, H, W, gdiv, &grid, &cg, &ngroups);
  const int v[] = {attr.numRegs, (int)attr.sharedSizeBytes, 0, (int)attr.localSizeBytes, per_sm,
                   kThreads, kTH, kTW, kC, (int)(grid.x * grid.y * grid.z), cg, ngroups};
  for (int i = 0; i < 12; ++i) info[i] = v[i];
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, void* out, int N, int D, int H, int W,
                     int gdiv, int radius, cudaStream_t stream) {
  if (radius == 1) return launch<T, 1>(x, g, out, N, D, H, W, gdiv, stream);
  if (radius == 2) return launch<T, 2>(x, g, out, N, D, H, W, gdiv, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_describe(int N, int H, int W, int gdiv, int radius, int* info) {
  if (radius == 1) return describe<T, 1>(N, H, W, gdiv, info);
  if (radius == 2) return describe<T, 2>(N, H, W, gdiv, info);
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

// What `lga3d_fwd` with these arguments launches, without launching (one
// kernel a launch): info[0..11] = registers a thread, static shared memory
// a block (bytes), dynamic shared memory a block (bytes), local memory a
// thread (bytes; spills), blocks an SM (occupancy), threads a block, tile
// height, tile width, disparity slices a chunk, blocks in the grid,
// channels a block walks (the group size), groups a guidance index.
int lga3d_fwd_describe(int N, int D, int H, int W, int gdiv, int radius, int dtype, int* info) {
  (void)D;
  if (gdiv < 1 || N % gdiv != 0 || H < 1 || W < 1) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_describe<float>(N, H, W, gdiv, radius, info);
  if (dtype == 1) return dispatch_describe<__nv_bfloat16>(N, H, W, gdiv, radius, info);
  return cudaErrorInvalidValue;
}

}  // extern "C"
