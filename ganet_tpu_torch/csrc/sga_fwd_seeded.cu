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
// Bound on this card: bytes.  A launch reads x in the window, 5 weight
// planes and the seed, and writes A and the boundary row, against about 10
// f32 operations an element: at the wavefront's eval chunk, (32, 64, 48,
// 320) with a 128-column window, 53.3 MB in bf16 (0.0159 ms at 3.35 TB/s);
// at its training chunk, (64, 64, 20, 176) [48, 176), 45.7 MB (0.0136 ms).
// The walk is 48 or 20 steps; the parallelism is the N x cols columns.
//
// Design: K1's H sweep (sga_fwd.cu) over a column window, with K1's step
// (`recur` and the staging helpers of sga_sweep_h.cuh, shared with K1).
//  * A column's carry lives in f32 registers over a group of G lanes of one
//    warp, B bins a lane (lane g owns d in [g B, g B + B)); a warp owns
//    TM = 32 / G columns of the window adjacent along W, tiles counted from
//    col0.  K1's ladder: G x B = 1 x 8, 2 x 8, 2 x 16, 2 x 32 (D <= 64),
//    4 x 32, 8 x 32 (D <= 256), 16 x 32 (D <= 512); but at D <= 64, where
//    2 x 32 would give fewer than 2 warps an SM (kFewWarps), 4 x 16, twice
//    the warps with half the bins a lane: the eval chunk's 256 warps become
//    512.  (The rule reads only D <= 64; 16 x 32 has twice the warps of
//    8 x 32 on the same window.)
//  * With `valid` the lanes load their bins of the seed into the carry
//    before the walk (the seed's rows are staged like a step's x) and step
//    0 is a full step; without it step 0 is K1's copy step.  So over the
//    whole width, unseeded, K5 runs K1's arithmetic and equals K1's H sweep
//    bit for bit.
//  * Each warp stages its own steps, D rows of x and the 5 weight rows,
//    into its own ring of kStages steps in shared memory by `cp.async`
//    (`.cg` for 16 bytes) ahead of use and waits on them with
//    `cp.async.wait_group` plus `__syncwarp`: warps never wait on each
//    other, no block barrier.  bf16 is widened where the step reads it from
//    the ring.  The result goes over the consumed x of the slot and leaves
//    it as whole rows of one copy's width, the last step's also to
//    `boundary`.  Columns past col0 + cols in a ragged last tile are
//    computed but never stored.
//  * Blocks are sized from the grid: up to kMaxWarps warps a block on
//    adjacent tiles, as many as keep the blocks at or above kMinBlocks.
//  * Alignment: vectorised staging (16-byte copies, or a whole shorter row:
//    8 bytes in bf16 at G = 8, 8 in f32 and 4 in bf16 at G = 16) where x,
//    w, out, the seed and boundary, W, the weights' n stride, col0 and cols
//    allow, as at every shape of the wavefront; element-wise (`ld.global`
//    -> `st.shared`, element stores) otherwise.
//  * Measured on an H100 80GB HBM3 at 700 W with chip_smoke.py phase 10 on
//    edited copies of this source, each time the mean of 20 launches
//    queued behind a spin kernel; f32 / bf16 ms a launch at the eval chunk
//    (a) and the training chunk (b).  The previous design (a block of 8 x
//    32 threads over 32 columns, the bins over 8 rows of threads, two block
//    barriers a step, the next step prefetched into f32 registers): (a)
//    0.0613 / 0.1362-0.1364.  2 x 32 with 4-warp launch bounds (1-warp
//    blocks at (a), 2 at (b); 119-120 registers): (a) 0.0552-0.0556 /
//    0.0461-0.0464, (b) 0.0396-0.0399 / 0.0241-0.0242; rings of 3 and 6
//    steps within 2 % of 4 at both; 4-warp blocks (a) 0.0565 / 0.0469, (b)
//    0.0392 / 0.0240; launch bounds of 1 or 2 warps (151-155 registers, a
//    step loop of 954 / 1,067 SASS instructions against 1,003 / 1,110):
//    (a) 0.0526-0.0531 / 0.0440, (b) 0.0397-0.0403 / 0.0243-0.0247.  4 x
//    16 (4-warp launch bounds): (a) 0.0484 / 0.0387, (b) 0.0442 / 0.0421
//    (there 1,024 warps, and each copy instruction takes 32 rows of 16
//    bytes, half a 32-byte row of 2 x 32's 16 rows: K6 lost so too).  The
//    walk is one warp's pace, not the bytes': at (a) in bf16 a step takes
//    0.91 us at 2 x 32 and 0.77 us at 4 x 16 (the slope over H = 12, 24,
//    48; 2.3-2.7 us at H = 0), where its 1.09 MB take 0.33 us at 3.35
//    TB/s.  Hence 4 x 16 where the grid is small, 2 x 32 elsewhere, and
//    2-warp launch bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sga_sweep_h.cuh"  // copy_bytes_h, to_f32, from_f32, cp_async*, recur, Plan, aligned

namespace {

constexpr int kStages = 4;       // steps in a warp's ring
constexpr int kMaxWarps = 2;     // warps a block, at most
constexpr int kMinBlocks = 132;  // blocks a launch keeps, where it can (the SMs)
constexpr int kFewWarps = 2 * kMinBlocks;  // below 2 warps an SM at 2 x 32, D <= 64 runs 4 x 16

// The walk of a window.  Warp `warp` of a launch owns the TM window columns
// [mc0, mc0 + TM) of one n; a block is blockDim.x / 32 warps on adjacent
// tiles.  A warp's ring holds kStages steps; a step's stage is, in rows of
// TM elements of T, DP rows of x (bin d at row (d % B) G + d / B; A on the
// way out), then the 5 weight rows.  With `valid` the seed's rows are
// staged in the last slot before the walk.
template <typename T, int G, int B>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
sga_fwd_seeded_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ seed, T* __restrict__ out, T* __restrict__ boundary,
                      int N, int D, int H, int W, int col0, int cols, long long w_nstride,
                      int reverse, int valid, int vec) {
  constexpr int TM = 32 / G;                 // columns a warp owns
  constexpr int DP = G * B;                  // bin rows of a stage
  constexpr int CB = copy_bytes_h<T, G>();   // bytes of one copy
  constexpr int EPC = CB / sizeof(T);        // elements of one copy
  constexpr int STAGE = (DP + 5) * TM;       // elements of a stage
  static_assert(TM % EPC == 0 && (CB == 16 || CB == 8 || CB == 4), "a row is whole copies");
  using Vec = CopyVec<CB>;                   // one copy's bytes
  extern __shared__ __align__(16) unsigned char smem[];

  const int tiles = (cols + TM - 1) / TM;
  const int warp = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (warp >= N * tiles) return;
  const int lane = threadIdx.x % 32, c = lane / G, g = lane % G;
  const int n = warp / tiles, mc0 = (warp % tiles) * TM;  // the warp's first window column
  const long long plane = (long long)H * W;
  T* const ring = reinterpret_cast<T*>(smem) + (threadIdx.x / 32) * (kStages * STAGE);
  auto binrow = [](int d) { return (d % B) * G + d / B; };
  // This lane's share of a stage's copies and stores: the elements [col,
  // col + per) of rows row0, row0 + rstep, ... (whole copies when
  // vectorised, single elements otherwise).
  const int per = vec ? EPC : 1, cpr = TM / per;
  const int col = (lane % cpr) * per, row0 = lane / cpr, rstep = 32 / cpr;
  const bool live = mc0 + col < cols;  // whole copies: cols % EPC == 0 when vectorised
  const long long vbase = (long long)n * D * plane + col0 + mc0 + col;  // x, out
  const long long rbase = (long long)n * D * cols + mc0 + col;          // seed, boundary
  const long long pbase = n * w_nstride + col0 + mc0 + col;             // weight planes

  auto copy = [&](T* to, const T* from) {
    if (vec)
      cp_async_h<CB>(to, from);
    else
      *to = *from;
  };
  auto store = [&](T* to, const T* from) {
    if (vec)
      *reinterpret_cast<Vec*>(to) = *reinterpret_cast<const Vec*>(from);
    else
      *to = *from;
  };
  // The D rows of a volume at row pitch `pitch` from `from` (this lane's
  // first row) into a slot's bin rows.
  auto stage_rows = [&](T* st, const T* from, long long pitch) {
    for (int d = row0; d < D; d += rstep, from += rstep * pitch) copy(st + binrow(d) * TM, from);
  };
  // Stage the walk's step s into slot `slot`.
  auto prefetch = [&](int s, int slot) {
    if (!live) return;
    const long long row = (long long)(reverse ? H - 1 - s : s) * W;
    T* const st = ring + slot * STAGE + col;
    stage_rows(st, x + vbase + row + row0 * plane, plane);
    for (int k = row0; k < 5; k += rstep) copy(st + (DP + k) * TM, w + pbase + k * plane + row);
  };

  if (valid) {  // the seed's rows, in the slot the walk fills last
    if (live) stage_rows(ring + (kStages - 1) * STAGE + col, seed + rbase + row0 * cols, cols);
    cp_async_commit();
  }
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < H) prefetch(k, k);
    cp_async_commit();
  }
  float a[B];
  const int dlo = g * B;
  auto at = [&](int i) { return (i * G + g) * TM + c; };  // this lane's bin i in a slot
  if (valid) {
    cp_async_wait<kStages - 1>();
    __syncwarp();  // the seed of every lane's copies is in the ring
    const T* st = ring + (kStages - 1) * STAGE;
#pragma unroll
    for (int i = 0; i < B; ++i) a[i] = dlo + i < D ? to_f32(st[at(i)]) : 0.f;
    __syncwarp();  // every lane has its seed before step 0 refills the slot
  } else {
#pragma unroll
    for (int i = 0; i < B; ++i) a[i] = 0.f;
  }
#pragma unroll 1
  for (int s = 0; s < H; ++s) {
    if (s + kStages - 1 < H) prefetch(s + kStages - 1, (s + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();  // step s of every lane's copies is in the ring
    T* const st = ring + (s % kStages) * STAGE;
    float wv[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) wv[k] = to_f32(st[(DP + k) * TM + c]);
    recur<G, B>(a, [&](int i) { return to_f32(st[at(i)]); }, wv, g, dlo, D, s == 0 && !valid);
#pragma unroll
    for (int i = 0; i < B; ++i) st[at(i)] = from_f32<T>(a[i]);  // over the consumed x
    __syncwarp();  // every lane's results are in the slot
    if (live) {
      const T* from = st + col;
      T* to = out + vbase + (long long)(reverse ? H - 1 - s : s) * W + row0 * plane;
      for (int d = row0; d < D; d += rstep, to += rstep * plane) store(to, from + binrow(d) * TM);
      if (s == H - 1) {
        T* tb = boundary + rbase + row0 * cols;
        for (int d = row0; d < D; d += rstep, tb += rstep * cols) store(tb, from + binrow(d) * TM);
      }
    }
    __syncwarp();  // every lane is done with the slot the next step refills
  }
  cp_async_wait<0>();
}

// G lanes a column, B bins a lane: K1's ladder along H (sga_fwd.cu), but
// 4 x 16 at D <= 64 where 2 x 32 would give fewer than kFewWarps warps.
#define SGA_FWD_SEEDED_BY_D(CALL)                                      \
  if (D <= 8) return CALL(1, 8);                                       \
  if (D <= 16) return CALL(2, 8);                                      \
  if (D <= 32) return CALL(2, 16);                                     \
  if (D <= 64)                                                         \
    return (long long)N * ((cols + 15) / 16) < kFewWarps ? CALL(4, 16) \
                                                          : CALL(2, 32); \
  if (D <= 128) return CALL(4, 32);                                    \
  if (D <= 256) return CALL(8, 32);                                    \
  if (D <= 512) return CALL(16, 32);                                   \
  return cudaErrorInvalidValue;

// ptrs: x, w, out, boundary, seed (null without `valid`; null pointers are
// not checked).
template <typename T, int G, int B>
Plan plan(const void* const (&ptrs)[5], int N, int W, int col0, int cols, long long w_nstride) {
  constexpr int TM = 32 / G, CB = copy_bytes_h<T, G>();
  const long long elem = sizeof(T);
  Plan p;
  p.G = G;
  p.B = B;
  p.steps = 1;
  p.stages = kStages;
  p.vec = (W * elem) % CB == 0 && (w_nstride * elem) % CB == 0 && (col0 * elem) % CB == 0 &&
          (cols * elem) % CB == 0;
  for (const void* q : ptrs) p.vec = p.vec && (q == nullptr || aligned(q, CB));
  constexpr size_t ring = (size_t)kStages * (G * B + 5) * TM * sizeof(T);  // a warp's
  static_assert(kMaxWarps * ring <= 232448, "a block's rings fit its 227 KB of shared memory");
  const long long warps = (long long)N * ((cols + TM - 1) / TM);
  int wpb = kMaxWarps;
  while (wpb > 1 && (warps + wpb - 1) / wpb < kMinBlocks) wpb /= 2;
  p.warps_per_block = wpb;
  p.blocks = (int)((warps + wpb - 1) / wpb);
  p.smem = wpb * ring;
  return p;
}

template <typename T, int G, int B>
const void* kernel_of() {
  return reinterpret_cast<const void*>(sga_fwd_seeded_kernel<T, G, B>);
}

template <typename T, int G, int B>
cudaError_t launch(const T* x, const T* w, const T* seed, T* out, T* boundary, int N, int D, int H,
                   int W, int col0, int cols, int reverse, int valid, long long w_nstride,
                   cudaStream_t stream) {
  const void* const ptrs[5] = {x, w, out, boundary, valid ? seed : nullptr};
  const Plan p = plan<T, G, B>(ptrs, N, W, col0, cols, w_nstride);
  cudaError_t err = cudaFuncSetAttribute(kernel_of<T, G, B>(),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  sga_fwd_seeded_kernel<T, G, B><<<p.blocks, p.warps_per_block * 32, p.smem, stream>>>(
      x, w, seed, out, boundary, N, D, H, W, col0, cols, w_nstride, reverse, valid, p.vec);
  return cudaGetLastError();
}

template <typename T, int G, int B>
cudaError_t describe(const void* const (&ptrs)[5], int N, int W, int col0, int cols,
                     long long w_nstride, int* info) {
  const Plan p = plan<T, G, B>(ptrs, N, W, col0, cols, w_nstride);
  const void* k = kernel_of<T, G, B>();
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, p.warps_per_block * 32, p.smem);
  if (err != cudaSuccess) return err;
  const int v[] = {p.vec,   attr.numRegs, (int)p.smem,         (int)attr.localSizeBytes,
                   p.G,     p.B,          p.steps,             p.stages,
                   p.warps_per_block,     p.blocks,            per_sm};
  for (int i = 0; i < 11; ++i) info[i] = v[i];
  return cudaSuccess;
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
#define SGA_FWD_SEEDED_LAUNCH(G, B)                                                          \
  launch<T, G, B>(x, w, seed, out, boundary, N, D, H, W, col0, cols, reverse, valid, w_nstride, \
                  stream)
  SGA_FWD_SEEDED_BY_D(SGA_FWD_SEEDED_LAUNCH)
#undef SGA_FWD_SEEDED_LAUNCH
}

template <typename T>
cudaError_t dispatch_describe(const void* const (&ptrs)[5], int N, int D, int W, int col0,
                              int cols, long long w_nstride, int* info) {
#define SGA_FWD_SEEDED_DESCRIBE(G, B) describe<T, G, B>(ptrs, N, W, col0, cols, w_nstride, info)
  SGA_FWD_SEEDED_BY_D(SGA_FWD_SEEDED_DESCRIBE)
#undef SGA_FWD_SEEDED_DESCRIBE
}

bool bad_window(int H, int W, int col0, int cols) {
  return H < 1 || cols < 1 || col0 < 0 || col0 + cols > W;
}

}  // namespace

extern "C" {

// Largest D one launch takes (16 lanes x 32 bins a column).
int sga_sweep_fwd_seeded_max_d() { return 512; }

// x, out: (N, D, H, W), the window [col0, col0 + cols) of each row; w: this
// direction's (N, 5, H, W) weights with a stride of w_nstride elements
// between consecutive n; seed (read when valid) and boundary: (N, D, cols)
// contiguous.  dtype 0 = float32, 1 = bfloat16.  Returns the CUDA error of
// the launch (0 on success).
int sga_sweep_fwd_seeded(const void* x, const void* w, const void* seed, void* out,
                         void* boundary, int N, int D, int H, int W, int col0, int cols,
                         int reverse, int valid, long long w_nstride, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_window(H, W, col0, cols) || (valid && seed == nullptr)) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(x, w, seed, out, boundary, N, D, H, W, col0, cols, reverse, valid,
                           w_nstride, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, seed, out, boundary, N, D, H, W, col0, cols, reverse,
                                   valid, w_nstride, s);
  return cudaErrorInvalidValue;
}

// What `sga_sweep_fwd_seeded` with these arguments launches, without
// launching (seed null: not `valid`; a null pointer is taken as aligned):
// info[0..10] = vectorised staging (1) or element-wise (0), registers a
// thread, dynamic shared memory a block (bytes), local memory a thread
// (bytes; spills), lanes a column G, bins a lane B, steps a stage, stages
// in a warp's ring, warps a block, blocks, blocks resident an SM.  Returns
// a CUDA error.
int sga_sweep_fwd_seeded_describe(const void* x, const void* w, const void* seed,
                                  const void* out, const void* boundary, int N, int D, int H,
                                  int W, int col0, int cols, long long w_nstride, int dtype,
                                  int* info) {
  const void* const ptrs[5] = {x, w, out, boundary, seed};
  if (bad_window(H, W, col0, cols)) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_describe<float>(ptrs, N, D, W, col0, cols, w_nstride, info);
  if (dtype == 1)
    return dispatch_describe<__nv_bfloat16>(ptrs, N, D, W, col0, cols, w_nstride, info);
  return cudaErrorInvalidValue;
}

}  // extern "C"
