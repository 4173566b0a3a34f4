// SGA directional sweep, forward (semi-global aggregation), for Hopper.
//
// Replaces the TPU kernel `_make_fwd_kernel` launched by
// `_sweep_fwd_canonical` in ganet_tpu/ops/sga_pallas.py.
//
// One launch runs one directional sweep over a (N, D, H, W) volume,
// N = batch * channels, with the recurrence along the sweep axis
//
//   A[l] = w0*x[l] + w1*A[l-1] + w2*A[l-1](d-1) + w3*A[l-1](d+1)
//        + w4*max_d A[l-1]
//
// (zero outside [0, D); the first step of the sweep copies x).  Weights are
// (N, 5, H, W) for this direction, read at a caller-given per-n stride so
// that one (N, 4, 5, H, W) tensor feeds all four directions.  With
// `accumulate` set the sweep writes max(out, A) instead of A, which fuses
// the max over the four directions into the sweeps: the first direction
// stores, the other three take the running max in place.  Sums run in f32;
// the output is rounded to x's dtype.
//
// Bound on this card: bytes.  A launch reads x and 5 weight planes and
// writes the output (and reads it first when accumulating): at GANet_deep's
// full-res block (32, 64, 192, 320) in bf16 that is 523 MB (0.156 ms at
// 3.35 TB/s) for a storing launch and 775 MB (0.231 ms) for an accumulating
// one, against about 10 f32 operations an element.  The recurrence is
// sequential in l; the parallelism is the columns, one (n, m) position
// across the sweep (m = w for sweeps along H, m = h along W).
//
// Design: register-resident columns, no block barrier.
//  * A column's state A[l-1, :, m] lives in f32 registers, split over a
//    group of G lanes of one warp, B bins a lane (lane g owns d in
//    [g*B, g*B + B)); G and B are template parameters chosen from D and the
//    axis (below).  The max over d is an in-lane max plus log2(G)
//    xor-shuffles (one `redux.sync` for a whole warp); the two d +- 1
//    neighbours across a lane boundary are one shuffle each; the state is
//    updated in place, the old d-1 value carried in one register.
//  * Each warp stages its own columns' inputs, x and the 5 weight rows
//    (and, along H, the running max when accumulating), into its own ring
//    of shared memory by asynchronous copies ahead of use, and waits on
//    them with `cp.async.wait_group` plus `__syncwarp` once per stage.
//    Warps never wait on each other: the kernel has no `__syncthreads`.
//    Results are written over the consumed x of the stage and leave it as
//    whole rows of memory.
//  * Sweeps along H (l = h): a column group is G lanes, at most 16 bins a
//    lane up to D = 32 and 32 above (2 x 32 at D = 64, 8 x 32 at D = 256,
//    16 x 32 at D = 512), and a warp owns 32/G columns adjacent along W, so
//    a stage is one step: D rows of x (and D of running max) plus 5 weight
//    rows of 32/G contiguous elements (32 bytes in bf16 at D = 64), copied
//    16 bytes at a time (8 where a row is 8 bytes: bf16 at G = 8; at G =
//    16 a row is 8 bytes in f32 and 4 in bf16, the least `cp.async`
//    copies, so 32 lanes a column would not stage by copies).  4 stages, 3
//    steps in flight; 2 warps a block.  Rows of bin d sit at
//    (d % B) * G + d / B so the lanes of a warp read one contiguous span;
//    outputs go back as stores of one copy's width.  Measured on an H100 80GB HBM3 at
//    700 W (chip_smoke.py phase 2, full-res block, bf16, storing): 4 lanes
//    x 16 bins, whose rows are 16 bytes, took 0.737 ms a launch; 2 x 32
//    took 0.353 ms.
//  * Sweeps along W (l = w): the rows a column needs lie W apart, so the
//    run along W that a stage holds decides the bandwidth: a stage holds
//    RUN = 128 bytes of each row (64 bf16 or 32 f32 steps).  (With 16-byte
//    runs, 8 columns a warp, the full-res f32 W sweep took 3.35 ms a
//    storing launch, chip_smoke.py phase 2 on the same card.)  Shared
//    memory then holds few columns, so one column a warp: its D bins over
//    all 32 lanes (B = 1, 2, 4, 8 or 16 a lane, d = g*B + i; at B = 16, D
//    up to 512, a stage holds 64 bytes of each row, `run_w`), the max over d one
//    `redux.sync` on an order-preserving integer image of the floats.  A
//    stage at D = 64 is (64 + 5) rows x 132 bytes, 2 stages (one in
//    flight), 9 KB a warp.  Rows are copied by 4-byte `cp.async`, one
//    128-byte row a warp instruction, into a pitch of 33 words, so that the
//    lanes' reads of one step down the rows (bin row (d % B) * 32 + d / B)
//    fall in 32 different banks; 16-byte copies would force a pitch of
//    whole 16-byte units and a 4-way conflict on every read.  The running
//    max of an accumulating launch is not staged: each lane loads its
//    stage's 4-byte units of it into registers while the stage is
//    computed and takes the max at the store, which keeps as many columns
//    in flight as a storing launch.  Above D = 128 (8 bins a lane) those
//    units would take 256 registers a lane, so there the lane reads each
//    unit of the running max at its store instead.
//  * Alignment.  The weights of direction k start k*5*H*W elements in, and
//    a row starts at an odd element when W is odd.  Each sweep has two
//    staging paths: vectorised (copies and stores of 16 bytes, or 8, along H, 4-byte
//    copies and stores along W) when x, w and out and every row start are
//    aligned to the copy, as at every shape of the model's paths;
//    element-wise (`ld.global` -> `st.shared`, one element a copy, and
//    element stores) otherwise.  Steps of a ragged last stage along W are
//    never run, so they cannot advance the carry.
//  * bf16 is widened and rounded one element at a time in the recurrence,
//    not in pairs: no 4-byte word of the ring holds two elements one lane
//    needs in one step.  Along H a lane's bins lie in different rows and
//    the element beside its own in a row is another lane's column; along W
//    it is the same row's next step, which the sequential recurrence reads
//    only after this one.  Pairs occur only in the running max of an
//    accumulating W launch, a lane's 4-byte units, and are converted there
//    as pairs (`umax`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "sga_sweep_h.cuh"  // copy_bytes_h, to_f32, from_f32, cp_async*, warp_max, recur, Plan, aligned

namespace {

constexpr int kWarpsH = 2;    // warps per block, sweeps along H
constexpr int kStagesH = 4;   // steps in a warp's ring, sweeps along H
constexpr int kWarpsW = 1;    // warps per block, sweeps along W
constexpr int kStagesW = 2;   // stages in a warp's ring, sweeps along W
// Bytes of a row a W-sweep stage holds at B bins a lane: 128, but 64 at
// B = 16 (D up to 512), where 128-byte runs take 136,488 bytes of shared
// memory a block, one block (one warp) an SM, and 64-byte runs 70,312,
// three.  Measured on an H100 80GB HBM3 at 700 W (in turns in one call,
// W sweep at (32, 512, 192, 320), ms a storing / accumulating launch):
// 64-byte runs 7.93-8.00 / 22.91-22.98 in bf16, 18.12-18.21 / 43.33-43.43
// in f32; 128-byte runs 26.05-26.06 / 62.13-62.15 and 42.62-42.68 /
// 114.56-114.58, with 40 bytes of local memory in f32.
template <int B>
__host__ __device__ constexpr int run_w() {
  return B >= 16 ? 64 : 128;
}

// Sweep along H.  A warp's ring holds kStagesH steps, each (in elements of
// T) DP rows of x, DP rows of running max when accumulating, then 5 weight
// rows, every row TM columns.
template <typename T, int G, int B>
__global__ void __launch_bounds__(32 * kWarpsH)
sga_sweep_h_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int N,
                   int D, int H, int W, long long w_nstride, int reverse, int accumulate, int vec) {
  constexpr int TM = 32 / G;             // columns a warp owns
  constexpr int DP = G * B;              // bin rows a stage holds
  constexpr int CB = copy_bytes_h<T, G>(); // bytes of one copy
  constexpr int EPC = CB / sizeof(T);    // elements of one copy
  constexpr int CPR = TM / EPC;          // copies per row
  static_assert(CPR >= 1 && TM % EPC == 0, "a row is whole copies");
  using Vec = CopyVec<CB>;               // one copy's bytes
  extern __shared__ __align__(16) unsigned char smem[];

  const int tiles = (W + TM - 1) / TM;
  const int warp = blockIdx.x * kWarpsH + threadIdx.x / 32;
  if (warp >= N * tiles) return;
  const int lane = threadIdx.x % 32, c = lane / G, g = lane % G;
  const int n = warp / tiles, m0 = (warp % tiles) * TM;
  const long long plane = (long long)H * W;
  const T* xn = x + (long long)n * D * plane;
  T* on = out + (long long)n * D * plane;
  const T* wn = w + n * w_nstride;
  const int xrows = D * (1 + accumulate);  // rows of x and running max copied
  const int wrow = DP * (1 + accumulate);  // first weight row of a stage
  const int stage = (wrow + 5) * TM;       // elements of a stage
  T* ring = reinterpret_cast<T*>(smem) + (size_t)(threadIdx.x / 32) * kStagesH * stage;
  // Row r of the copy order (x bins, running max, weights): its stage row
  // and its start in memory.
  auto srow = [&](int r) {
    return r < D ? (r % B) * G + r / B
                 : r < xrows ? DP + ((r - D) % B) * G + (r - D) / B : wrow + r - xrows;
  };
  auto grow = [&](int r) -> const T* {
    return r < D ? xn + r * plane : r < xrows ? on + (r - D) * plane : wn + (r - xrows) * plane;
  };

  // Stage the step s (in sweep order) into slot `slot`.
  auto issue = [&](int s, int slot) {
    const long long off = (long long)(reverse ? H - 1 - s : s) * W + m0;
    T* st = ring + slot * stage;
    if (vec) {
      for (int q = lane; q < (xrows + 5) * CPR; q += 32) {
        const int r = q / CPR, col = (q % CPR) * EPC;
        if (m0 + col < W)  // whole copies: W is a multiple of EPC
          cp_async_h<CB>(st + srow(r) * TM + col, grow(r) + off + col);
      }
    } else {
      for (int q = lane; q < (xrows + 5) * TM; q += 32) {
        const int r = q / TM, col = q % TM;
        if (m0 + col < W) st[srow(r) * TM + col] = grow(r)[off + col];
      }
    }
  };

  float a[B];
#pragma unroll
  for (int i = 0; i < B; ++i) a[i] = 0.f;
  const int dlo = g * B;
#pragma unroll
  for (int k = 0; k < kStagesH - 1; ++k) {
    if (k < H) issue(k, k);
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < H; ++s) {
    if (s + kStagesH - 1 < H) issue(s + kStagesH - 1, (s + kStagesH - 1) % kStagesH);
    cp_async_commit();
    cp_async_wait<kStagesH - 1>();
    __syncwarp();  // step s of every lane's copies is in the ring
    T* st = ring + (s % kStagesH) * stage;
    float wv[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) wv[k] = to_f32(st[(wrow + k) * TM + c]);
    recur<G, B>(a, [&](int i) { return to_f32(st[(i * G + g) * TM + c]); }, wv, g, dlo, D, s == 0);
#pragma unroll
    for (int i = 0; i < B; ++i) {  // the result goes over the consumed x
      float v = a[i];
      if (accumulate) v = fmaxf(v, to_f32(st[(DP + i * G + g) * TM + c]));
      st[(i * G + g) * TM + c] = from_f32<T>(v);
    }
    __syncwarp();  // every lane's results are in the slot
    T* dst = on + (long long)(reverse ? H - 1 - s : s) * W + m0;
    if (vec) {
      for (int q = lane; q < D * CPR; q += 32) {
        const int d = q / CPR, col = (q % CPR) * EPC;
        if (m0 + col < W)
          *reinterpret_cast<Vec*>(dst + d * plane + col) =
              *reinterpret_cast<const Vec*>(st + srow(d) * TM + col);
      }
    } else {
      for (int q = lane; q < D * TM; q += 32) {
        const int d = q / TM, col = q % TM;
        if (m0 + col < W) dst[d * plane + col] = st[srow(d) * TM + col];
      }
    }
    __syncwarp();  // every lane is done with the slot the next step refills
  }
  cp_async_wait<0>();
}

// Sweep along W: one column (n, h) a warp, bin d = g*B + i on lane g.  A
// warp's ring holds kStagesW stages of S = RUN / elem steps (RUN =
// run_w<B>()); a stage is rows of S elements at a pitch of RUN + 4 bytes
// (an odd number of words): 32*B rows of x (bin d
// at row (d % B) * 32 + d / B), then 5 weight rows.  When accumulating,
// the running max of a stage is loaded into registers (KU 4-byte units a
// lane) while the stage is computed, and taken at the store; above 4 bins a
// lane (HOLD false) each unit is read at its store instead.
template <typename T, int B>
__global__ void __launch_bounds__(32 * kWarpsW)
sga_sweep_w_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int N,
                   int D, int H, int W, long long w_nstride, int reverse, int accumulate, int vec) {
  constexpr int RUN = run_w<B>();            // bytes of a row a stage holds
  constexpr int S = RUN / sizeof(T);         // steps of a stage
  constexpr int U = RUN / 4;                 // 4-byte units of a row
  constexpr int EPU = 4 / sizeof(T);         // elements of a unit
  constexpr int P = (RUN + 4) / sizeof(T);   // row pitch, elements
  constexpr int DP = 32 * B;                 // bin rows a stage holds
  constexpr int KU = B * U;                  // units of a stage's rows a lane stores
  constexpr bool HOLD = KU <= 128;           // the running max held in registers
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = blockIdx.x * kWarpsW + threadIdx.x / 32;
  if (warp >= N * H) return;
  const int g = threadIdx.x % 32;
  const int n = warp / H, h = warp % H;
  const long long plane = (long long)H * W;
  const T* xn = x + (long long)n * D * plane + (long long)h * W;
  T* on = out + (long long)n * D * plane + (long long)h * W;
  const T* wn = w + n * w_nstride + (long long)h * W;
  const int stage = (DP + 5) * P;
  T* ring = reinterpret_cast<T*>(smem) + (size_t)(threadIdx.x / 32) * kStagesW * stage;
  const int nst = (W + S - 1) / S;
  auto first_col = [&](int t) { return (reverse ? nst - 1 - t : t) * S; };
  // Row r of the copy order (x bins, then weights): its stage row and its
  // start in memory at the column's first step.
  auto srow = [&](int r) { return r < D ? (r % B) * 32 + r / B : DP + r - D; };
  auto grow = [&](int r) -> const T* { return r < D ? xn + r * plane : wn + (r - D) * plane; };

  // Stage t (in sweep order) into slot `slot`.
  auto issue = [&](int t, int slot) {
    const int l0 = first_col(t), nl = min(S, W - l0);
    T* st = ring + slot * stage;
    if (vec) {  // a 4-byte unit a lane, 128 bytes a warp; W is a multiple of EPU
      for (int q = g; q < (D + 5) * U; q += 32) {
        const int r = q / U, e = (q % U) * EPU;
        if (e < nl) cp_async4(st + srow(r) * P + e, grow(r) + l0 + e);
      }
    } else {
      for (int q = g; q < (D + 5) * S; q += 32) {
        const int r = q / S, j = q % S;
        if (j < nl) st[srow(r) * P + j] = grow(r)[l0 + j];
      }
    }
  };
  // The elementwise max of two units of T.
  auto umax = [](uint32_t u, uint32_t v) {
    if (EPU == 1) return __float_as_uint(fmaxf(__uint_as_float(u), __uint_as_float(v)));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
    const __nv_bfloat162 m = __floats2bfloat162_rn(fmaxf(a.x, b.x), fmaxf(a.y, b.y));
    return *reinterpret_cast<const uint32_t*>(&m);
  };

  float a[B];
#pragma unroll
  for (int i = 0; i < B; ++i) a[i] = 0.f;
  const int dlo = g * B;
#pragma unroll
  for (int k = 0; k < kStagesW - 1; ++k) {
    if (k < nst) issue(k, k);
    cp_async_commit();
  }
  int s = 0;  // sweep step
#pragma unroll 1
  for (int t = 0; t < nst; ++t) {
    if (t + kStagesW - 1 < nst) issue(t + kStagesW - 1, (t + kStagesW - 1) % kStagesW);
    cp_async_commit();
    const int l0 = first_col(t), nl = min(S, W - l0);
    T* dst = on + l0;
    uint32_t old[HOLD ? KU : 1];  // the running max of this stage's units, in flight
    if constexpr (HOLD) {
      if (accumulate && vec) {
#pragma unroll
        for (int m = 0; m < KU; ++m) {
          const int q = g + 32 * m, r = q / U, e = (q % U) * EPU;
          if (q < D * U && e < nl) old[m] = *reinterpret_cast<const uint32_t*>(dst + r * plane + e);
        }
      }
    }
    cp_async_wait<kStagesW - 1>();
    __syncwarp();  // stage t of every lane's copies is in the ring
    T* st = ring + (t % kStagesW) * stage;
#pragma unroll 1
    for (int jj = 0; jj < nl; ++jj, ++s) {
      const int j = reverse ? nl - 1 - jj : jj;
      float wv[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) wv[k] = to_f32(st[(DP + k) * P + j]);
      recur<32, B>(a, [&](int i) { return to_f32(st[(i * 32 + g) * P + j]); }, wv, g, dlo, D,
                   s == 0);
#pragma unroll
      for (int i = 0; i < B; ++i)  // the result goes over the consumed x
        if (dlo + i < D) st[(i * 32 + g) * P + j] = from_f32<T>(a[i]);
    }
    __syncwarp();  // every lane's results are in the slot
    if (vec) {
#pragma unroll
      for (int m = 0; m < KU; ++m) {
        const int q = g + 32 * m, r = q / U, e = (q % U) * EPU;
        if (q < D * U && e < nl) {
          uint32_t v = *reinterpret_cast<const uint32_t*>(st + srow(r) * P + e);
          uint32_t* to = reinterpret_cast<uint32_t*>(dst + r * plane + e);
          if constexpr (HOLD) {
            if (accumulate) v = umax(v, old[m]);
          } else {
            if (accumulate) v = umax(v, *to);
          }
          *to = v;
        }
      }
    } else {
      for (int q = g; q < D * S; q += 32) {
        const int r = q / S, j = q % S;
        if (j < nl) {
          const T v = st[srow(r) * P + j];
          dst[r * plane + j] =
              accumulate ? from_f32<T>(fmaxf(to_f32(v), to_f32(dst[r * plane + j]))) : v;
        }
      }
    }
    __syncwarp();  // every lane is done with the slot before it is refilled
  }
  cp_async_wait<0>();
}

// G lanes a column, B bins a lane.  Along H: rows of at least 32 bytes in
// bf16 up to D = 64.  Along W: a warp a column.
#define SGA_BY_D_H(CALL)             \
  if (D <= 8) return CALL(1, 8);     \
  if (D <= 16) return CALL(2, 8);    \
  if (D <= 32) return CALL(2, 16);   \
  if (D <= 64) return CALL(2, 32);   \
  if (D <= 128) return CALL(4, 32);  \
  if (D <= 256) return CALL(8, 32);  \
  if (D <= 512) return CALL(16, 32); \
  return cudaErrorInvalidValue;
#define SGA_BY_D_W(CALL)             \
  if (D <= 32) return CALL(32, 1);   \
  if (D <= 64) return CALL(32, 2);   \
  if (D <= 128) return CALL(32, 4);  \
  if (D <= 256) return CALL(32, 8);  \
  if (D <= 512) return CALL(32, 16); \
  return cudaErrorInvalidValue;

template <typename T, int G, int B>
Plan plan(const void* x, const void* w, const void* out, int N, int D, int H, int W, int axis_w,
          int accumulate, long long w_nstride) {
  Plan p;
  p.G = G;
  p.B = B;
  if (axis_w) {
    const int elem = sizeof(T);
    p.vec = aligned(x, 4) && aligned(w, 4) && aligned(out, 4) && (W * elem) % 4 == 0 &&
            (w_nstride * elem) % 4 == 0;
    p.steps = run_w<B>() / elem;
    p.stages = kStagesW;
    p.warps_per_block = kWarpsW;
    p.smem = (size_t)kWarpsW * kStagesW * (32 * B + 5) * (run_w<B>() + 4);
    p.blocks = (int)(((long long)N * H + kWarpsW - 1) / kWarpsW);
  } else {
    const int TM = 32 / G, cb = copy_bytes_h<T, G>();
    p.vec = aligned(x, cb) && aligned(w, cb) && aligned(out, cb) && (W * sizeof(T)) % cb == 0 &&
            (w_nstride * (long long)sizeof(T)) % cb == 0;
    p.steps = 1;
    p.stages = kStagesH;
    p.warps_per_block = kWarpsH;
    p.smem = (size_t)kWarpsH * kStagesH * (G * B * (1 + accumulate) + 5) * TM * sizeof(T);
    const long long warps = (long long)N * ((W + TM - 1) / TM);
    p.blocks = (int)((warps + kWarpsH - 1) / kWarpsH);
  }
  return p;
}

template <typename T, int G, int B>
const void* kernel_of() {
  if constexpr (G == 32)
    return reinterpret_cast<const void*>(sga_sweep_w_kernel<T, B>);
  else
    return reinterpret_cast<const void*>(sga_sweep_h_kernel<T, G, B>);
}

template <typename T, int G, int B>
cudaError_t launch(const T* x, const T* w, T* out, int N, int D, int H, int W, int axis_w,
                   int reverse, int accumulate, long long w_nstride, cudaStream_t stream) {
  const Plan p = plan<T, G, B>(x, w, out, N, D, H, W, axis_w, accumulate, w_nstride);
  cudaError_t err = cudaFuncSetAttribute(kernel_of<T, G, B>(),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  if constexpr (G == 32)
    sga_sweep_w_kernel<T, B><<<p.blocks, 32 * kWarpsW, p.smem, stream>>>(
        x, w, out, N, D, H, W, w_nstride, reverse, accumulate, p.vec);
  else
    sga_sweep_h_kernel<T, G, B><<<p.blocks, 32 * kWarpsH, p.smem, stream>>>(
        x, w, out, N, D, H, W, w_nstride, reverse, accumulate, p.vec);
  return cudaGetLastError();
}

template <typename T, int G, int B>
cudaError_t describe(const void* x, const void* w, const void* out, int N, int D, int H, int W,
                     int axis_w, int accumulate, long long w_nstride, int* info) {
  const Plan p = plan<T, G, B>(x, w, out, N, D, H, W, axis_w, accumulate, w_nstride);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel_of<T, G, B>());
  if (err != cudaSuccess) return err;
  const int v[] = {p.vec, attr.numRegs, (int)p.smem, (int)attr.localSizeBytes, p.G, p.B,
                   p.steps, p.stages, p.warps_per_block, p.blocks};
  for (int i = 0; i < 10; ++i) info[i] = v[i];
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const void* xv, const void* wv, void* outv, int N, int D, int H, int W,
                     int axis_w, int reverse, int accumulate, long long w_nstride,
                     cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* out = static_cast<T*>(outv);
#define SGA_LAUNCH(G, B) \
  launch<T, G, B>(x, w, out, N, D, H, W, axis_w, reverse, accumulate, w_nstride, stream)
  if (axis_w) {
    SGA_BY_D_W(SGA_LAUNCH)
  }
  SGA_BY_D_H(SGA_LAUNCH)
#undef SGA_LAUNCH
}

template <typename T>
cudaError_t dispatch_describe(const void* x, const void* w, const void* out, int N, int D, int H,
                              int W, int axis_w, int accumulate, long long w_nstride, int* info) {
#define SGA_DESCRIBE(G, B) \
  describe<T, G, B>(x, w, out, N, D, H, W, axis_w, accumulate, w_nstride, info)
  if (axis_w) {
    SGA_BY_D_W(SGA_DESCRIBE)
  }
  SGA_BY_D_H(SGA_DESCRIBE)
#undef SGA_DESCRIBE
}

}  // namespace

extern "C" {

// Largest D one launch takes (16 lanes x 32 bins along H, 32 x 16 along W).
int sga_sweep_max_d() { return 512; }

// x, out: (N, D, H, W); w: this direction's (N, 5, H, W) weights with a
// stride of w_nstride elements between consecutive n.  dtype 0 = float32,
// 1 = bfloat16.  axis_w: 0 sweeps along H, 1 along W.  Returns the CUDA
// error of the launch (0 on success).
int sga_sweep_fwd(const void* x, const void* w, void* out, int N, int D, int H, int W,
                  int axis_w, int reverse, int accumulate, long long w_nstride, int dtype,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, w, out, N, D, H, W, axis_w, reverse, accumulate, w_nstride, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, out, N, D, H, W, axis_w, reverse, accumulate,
                                   w_nstride, s);
  return cudaErrorInvalidValue;
}

// What `sga_sweep_fwd` with these arguments launches, without launching:
// info[0..9] = vectorised staging (1) or element-wise (0), registers a
// thread, dynamic shared memory a block (bytes), local memory a thread
// (bytes; spills), lanes a column G, bins a lane B, steps a stage, stages
// in a warp's ring, warps a block, blocks.  Returns a CUDA error.
int sga_sweep_fwd_describe(const void* x, const void* w, const void* out, int N, int D, int H,
                           int W, int axis_w, int accumulate, long long w_nstride, int dtype,
                           int* info) {
  if (dtype == 0)
    return dispatch_describe<float>(x, w, out, N, D, H, W, axis_w, accumulate, w_nstride, info);
  if (dtype == 1)
    return dispatch_describe<__nv_bfloat16>(x, w, out, N, D, H, W, axis_w, accumulate,
                                            w_nstride, info);
  return cudaErrorInvalidValue;
}

}  // extern "C"
