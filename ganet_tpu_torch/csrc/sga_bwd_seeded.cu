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
//   g      = gbar[l] + c
//   dx[l] += w0 g
//   dw[l] += (sum_d g x, sum_d g A', sum_d g A'(d-1), sum_d g A'(d+1),
//             (sum_d g) max_d A')
//   c      = w1 g + w2 g(d+1) + w3 g(d-1) + w4 (sum_d g) e
//
// with A' the forward's output at the previous position of the sweep and
// e the indicator of argmax_d A' split evenly among ties.  K3's
// differences:
//  * at the sweep's first step A' is the seed when `valid`, and that step
//    is a full one; without `valid` it is the copy step (dx += g, dw += 0,
//    the carry cut to 0);
//  * the carry starts at `dboundary` (N, D, cols) float32 when given: the
//    cotangent of the boundary row this chunk sent downstream, which adds
//    to gbar at the forward's last row;
//  * the carry left after the first step is written to `dseed`
//    (N, D, cols) float32, the seed's cotangent (0 without `valid`);
//  * dx and dw are added into (the wavefront sums the directions into one
//    dx, and overlapping chunks each add their share into dw), in float32,
//    rounded once.
// x, A, gbar, dx and the weights are read and written in place in the
// window at row pitch W; the seed, dboundary and dseed at row pitch cols.
//
// Bound on this card: bytes.  A launch reads x, A, gbar and the old dx in
// the window, 5 weight planes and the 5 old dw planes, the seed and
// dboundary, and writes dx, 5 dw planes and dseed: (5 numel + 15 N H cols)
// elements and 2 N D cols float32 rows, about 25 f32 operations an
// element.  At the wavefront's per-shard tail chunk of the training crop,
// (64, 64, 20, 176) with the window [48, 176), that is 0.0343 ms in bf16
// and 0.0674 ms in f32 at 3.35 TB/s.  The walk is 20 steps; the
// parallelism is the 8,192 columns (n, m) of the window.
//
// Design: K3's H sweep (sga_bwd.cu) over a column window.
//  * A column's carry lives in f32 registers over a group of G lanes of one
//    warp, B bins a lane (lane g owns d in [g B, g B + B)); a warp owns
//    TM = 32 / G columns adjacent along W.  A step turns c into g in place,
//    sums the five products over the lane's bins, then over the G lanes by
//    a reduce-scatter of xor-shuffles (lane g of the column ends with the
//    sums g, g + G, ..., the lane that adds that dw row), reduces (max_d A',
//    tie count) as pairs in the same rounds, and turns g into the next c in
//    place; g(d+-1) across a lane boundary is one shuffle each.  A lane
//    keeps a bit mask of its bins at its own maximum, so the indicator e
//    needs no second read of A'.
//  * Layout: K3's ladder along H, G x B = 1 x 8, 2 x 8, 2 x 16, 2 x 32 (D
//    <= 64: 16 columns a warp, 32-byte bf16 rows), 4 x 32, 8 x 32 (D <=
//    256: 8-byte bf16 rows), 16 x 32 (D <= 512: rows of 8 bytes in f32, 4
//    in bf16).  A block is 4 warps on adjacent column tiles of one n
//    (fewer for a window of fewer tiles): at the tail chunk's shape 512
//    warps in 128 blocks, one an SM.  At 16 x 32 a warp's ring of 3 steps
//    is 49,392 bytes in f32, 197,568 for a block's 4 warps.
//  * Each warp stages its own steps into its own ring of shared memory by
//    asynchronous copies ahead of use and waits on them with
//    `cp.async.wait_group` plus `__syncwarp`: warps never wait on each
//    other, no block barrier.  A stage is one step of x, A' (the seed's
//    rows at the first step, when `valid`), gbar and the old dx (bin d at
//    row (d % B) G + d / B of its volume), then the 5 weight rows and the 5
//    old dw rows, so that no global read stands inside a step.  dx is
//    written over the consumed gbar and the new dw over the old dw rows
//    (only the lane that owns an element reads and writes it), and both
//    leave as whole rows; the copy step leaves the old dw rows as they
//    were.  3 steps in the ring.
//  * `__launch_bounds__(128, 1)`: without the block count ptxas held some
//    instantiations at 128 registers and spilled 4-8 bytes; with it they
//    take 78-160 registers and none spills.
//  * Alignment: vectorised staging (16-byte copies, or a whole shorter row
//    as above) where x, A, gbar, dx, w, dw and the seed, W, the
//    weights' n stride, col0 and cols allow, as at every shape of the
//    wavefront; element-wise (`ld.global` -> `st.shared`, element stores)
//    otherwise.
//  * Measured on an H100 80GB HBM3 at 700 W with chip_smoke.py phase 11 on
//    edited copies of this source, each time the mean of launches queued
//    behind a spin kernel (its `cuda_ms`); f32 / bf16 ms a launch at (64,
//    64, 20, 176), window [48, 176).  The previous design (one block of 8 x
//    32 threads over 32 columns, two block barriers a step), timed alike in
//    turns with this one: 0.1025-0.1026 / 0.1566-0.1572, against this
//    build's 0.0879-0.0882 / 0.0555-0.0560.  8 lanes x 8 bins (2,048
//    warps in 512 blocks): 0.1556-0.1559 / 0.1455-0.1457; 2-step rings
//    0.1513 / 0.1050;
//    one-warp blocks 0.2682 / 0.1794.  4 x 16 (1,024 warps): 0.1097 /
//    0.0798; its 16-byte copies by `cp.async.ca` 0.1498 / 0.1071.  2 x 32
//    (512 warps): rings of 3 / 4 steps 0.0879 / 0.0654, 2 / 2 0.0894 /
//    0.0537, 3 / 3 0.0878-0.0883 / 0.0545-0.0554 (this build, 76 % and
//    62 % of the bound); one-warp blocks 0.1080 / 0.0665.  The copies, not
//    the warps, set the time: at 8 lanes a column a warp's copy instruction
//    takes one row a lane, 32 rows of 8 or 16 bytes, so a byte costs 4
//    times the L1 requests of 2 lanes (two 16-byte copies a 32-byte bf16
//    row, 16 rows an instruction), and f32 and bf16 took one time there.
//    A tree of pairwise maxima in place of a lane's chain of maximum
//    updates held A' of its 32 bins in registers: 127 registers and 128 B
//    of local memory in f32, 0.135.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCopy = 16;           // bytes of one copy, at most
constexpr int kWarps = 4;           // warps a block, on adjacent column tiles
constexpr int kStages = 3;          // steps in a warp's ring

// Bytes of one copy: 16, or a whole row of the 32/G columns a warp owns
// where that is less (8 bytes in bf16 at G = 8; 8 in f32 and 4 in bf16 at
// G = 16).
template <typename T, int G>
__host__ __device__ constexpr int copy_bytes() {
  return (32 / G) * (int)sizeof(T) < kCopy ? (32 / G) * (int)sizeof(T) : kCopy;
}

// One copy's bytes as a type, for the stores of a copy's width.
template <int CB>
using CopyVec = std::conditional_t<CB == 16, uint4, std::conditional_t<CB == 8, uint2, uint32_t>>;

// Sums a lane of a column holds after `group_sum5`: 8 slots over G lanes.
template <int G>
__host__ __device__ constexpr int slots_a_lane() {
  return G >= 8 ? 1 : 8 / G;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// An asynchronous copy of BYTES from global to shared memory: 16 bytes
// by `.cg` (L2 only; `.ca` lost, see the header), 8 or 4 by `.ca`, the
// one kind that copies fewer than 16.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where the (max, count) of a column's A' comes from: a lane's own maximum
// lm over its bins, the number lc of its bins at lm, and the bit mask of
// those bins; updated without branches.
struct LaneMax {
  float lm;
  unsigned lc, mask;
  __device__ __forceinline__ void add(float v, int i) {
    const bool gt = v > lm, eq = v == lm;
    lc = gt ? 1u : lc + eq;
    mask = gt ? 1u << i : (eq ? mask | 1u << i : mask);
    lm = gt ? v : lm;
  }
};

// The sums over a column's G lanes (G = 1, 2, 4, 8 or 16) of v0..v4,
// reduce-scattered: lane g of the column returns in r[j] the sum of slot
// g + j G (slots 0..4 are v0..v4, slots 5..7 are empty); at G = 16 lanes g
// and g + 8 both hold slot g.  Offsets 1, 2, 4 each halve the slots a lane
// holds: 3, 2 and 1 shuffles; offset 8 adds the two halves of a 16-lane
// column.
template <int G>
__device__ __forceinline__ void group_sum5(float v0, float v1, float v2, float v3, float v4,
                                           int g, float (&r)[slots_a_lane<G>()]) {
  static_assert(G == 1 || G == 2 || G == 4 || G == 8 || G == 16,
                "a column is 1, 2, 4, 8 or 16 lanes");
  if constexpr (G == 1) {
    r[0] = v0, r[1] = v1, r[2] = v2, r[3] = v3, r[4] = v4, r[5] = r[6] = r[7] = 0.f;
  } else {
    const bool b0 = g & 1;
    // Slot pairs (0, 1), (2, 3), (4, 5); (6, 7) are empty.  Keep slot 2p + b0.
    const float p0 = (b0 ? v1 : v0) + __shfl_xor_sync(kFull, b0 ? v0 : v1, 1);
    const float p1 = (b0 ? v3 : v2) + __shfl_xor_sync(kFull, b0 ? v2 : v3, 1);
    const float p2 = (b0 ? 0.f : v4) + __shfl_xor_sync(kFull, b0 ? v4 : 0.f, 1);
    if constexpr (G == 2) {
      r[0] = p0, r[1] = p1, r[2] = p2, r[3] = 0.f;
    } else {
      const bool b1 = g & 2;
      const float q0 = (b1 ? p1 : p0) + __shfl_xor_sync(kFull, b1 ? p0 : p1, 2);
      const float q1 = (b1 ? 0.f : p2) + __shfl_xor_sync(kFull, b1 ? p2 : 0.f, 2);
      if constexpr (G == 4) {
        r[0] = q0, r[1] = q1;
      } else {
        const bool b2 = g & 4;
        r[0] = (b2 ? q1 : q0) + __shfl_xor_sync(kFull, b2 ? q0 : q1, 4);
        if constexpr (G == 16) r[0] += __shfl_xor_sync(kFull, r[0], 8);
      }
    }
  }
}

// One gradient step of a column for this lane's bins d = g B + i, the
// column spread over G lanes (g = this lane's index in the group).  c holds
// the carry and becomes the next one.  `copy`: the sweep's first position
// without a seed (dx += g, dw += 0, the carry cut).  FULL: every lane's
// bins lie in [0, D) (D == G B), and no bin is guarded.  Accessors: gb(i),
// xs(i), ap(i), old(i) give gbar, x, A' and the old dx at bin i (only
// called for d < D); an(d) gives A' at any bin d in [0, D); put_dx(i, v)
// stores dx; add_dw(k, v) adds v into dw[k] (called by the one lane of the
// column that holds that sum).  wv are the step's 5 weights.
template <int G, int B, bool FULL, typename Gb, typename Xs, typename Ap, typename An,
          typename Old, typename PutDx, typename AddDw>
__device__ __forceinline__ void grad_step(float (&c)[B], int g, int D, bool copy,
                                          const float (&wv)[5], Gb gb, Xs xs, Ap ap, An an,
                                          Old old, PutDx put_dx, AddDw add_dw) {
  const int dlo = g * B;
  auto in = [&](int i) { return FULL || dlo + i < D; };
#pragma unroll
  for (int i = 0; i < B; ++i)
    if (in(i)) c[i] += gb(i);  // c is now g (0 at bins >= D)
  if (copy) {
#pragma unroll
    for (int i = 0; i < B; ++i) {
      if (in(i)) put_dx(i, c[i] + old(i));
      c[i] = 0.f;
    }
    return;
  }
  // The lane's partial sums and its maximum of A'.
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, sg = 0.f;
  static_assert(B <= 32, "a lane's bins fit one mask word");
  LaneMax m{-CUDART_INF_F, 0u, 0u};
  if (FULL || dlo < D) {
    float aprev = dlo > 0 ? an(dlo - 1) : 0.f;  // A' at d - 1
#pragma unroll
    for (int i = 0; i < B; ++i) {
      if (in(i)) {
        const float ai = ap(i);
        s0 += c[i] * xs(i);
        s1 += c[i] * ai;
        s2 += c[i] * aprev;
        if (i > 0) s3 += c[i - 1] * ai;
        sg += c[i];
        m.add(ai, i);
        aprev = ai;
      }
    }
    if (dlo + B < D) s3 += c[B - 1] * an(dlo + B);
  }
  // The column's sums, reduce-scattered, and its (max, tie count) of A'.
  float r[slots_a_lane<G>()];
  group_sum5<G>(s0, s1, s2, s3, sg, g, r);
  float M = m.lm;
  unsigned cnt = m.lc;
#pragma unroll
  for (int off = 1; off < G; off *= 2) {
    const float om = __shfl_xor_sync(kFull, M, off);
    const unsigned oc = __shfl_xor_sync(kFull, cnt, off);
    const float mm = fmaxf(M, om);
    cnt = (M == mm ? cnt : 0u) + (om == mm ? oc : 0u);
    M = mm;
  }
  // sum_d g is slot 4, on lane 4 % G of the column.
  float SG;
  if constexpr (G == 1)
    SG = r[4];
  else
    SG = __shfl_sync(kFull, r[4 / G], 4 % G, G);
#pragma unroll
  for (int j = 0; j < slots_a_lane<G>(); ++j) {
    const int k = g + j * G;
    if (k < 5) add_dw(k, k == 4 ? r[j] * M : r[j]);
  }
  // g(d - 1) below the lane's first bin and g(d + 1) above its last.
  float gdn = 0.f, gup = 0.f;
  if (G > 1) {
    gdn = __shfl_up_sync(kFull, c[B - 1], 1);
    gup = __shfl_down_sync(kFull, c[0], 1);
    if (g == 0) gdn = 0.f;
    if (g == G - 1) gup = 0.f;
  }
  // The even split of w4 (sum_d g) over the tied maxima.  A fast division
  // (one reciprocal, no slow-path call): the count is an exact small
  // integer and the share within 2 ulps of the plain version's.
  const float share = __fdividef(wv[4] * SG, (float)max(cnt, 1u));
  const unsigned at_max = m.lm == M ? m.mask : 0u;
  float prev = gdn;  // g at d - 1
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const float cur = c[i];
    const float next = i + 1 < B ? c[i + 1] : gup;
    if (in(i)) {
      put_dx(i, wv[0] * cur + old(i));
      c[i] = wv[1] * cur + wv[2] * next + wv[3] * prev + ((at_max >> i) & 1u ? share : 0.f);
    }
    prev = cur;
  }
}

// The walk of a window.  Warp `tile` of column tiles of one n owns the TM
// window columns [tile TM, tile TM + TM); a block is blockDim.x / 32 warps
// on adjacent tiles.  A warp's ring holds kStages steps; a step's stage is,
// in rows of TM elements of T, DP rows each of x, A', gbar (dx on the way
// out) and the old dx, then the 5 weight rows and the 5 old dw rows (the
// new dw on the way out).
template <typename T, int G, int B, bool FULL>
__global__ void __launch_bounds__(kWarps * 32, 1)
sga_bwd_seeded_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ a,
                      const T* __restrict__ seed, const T* __restrict__ gbar,
                      const float* __restrict__ dboundary, T* __restrict__ dx,
                      T* __restrict__ dw, float* __restrict__ dseed, int D, int H, int W,
                      int col0, int cols, long long w_nstride, int reverse, int valid, int vec) {
  constexpr int TM = 32 / G;                // columns a warp owns
  constexpr int DP = G * B;                 // bin rows of a volume
  constexpr int CB = copy_bytes<T, G>();    // bytes of one copy
  constexpr int EPC = CB / sizeof(T);       // elements of one copy
  constexpr int PROW = 4 * DP;              // first plane row of a stage
  constexpr int STAGE = (PROW + 10) * TM;   // elements of a stage
  static_assert(TM % EPC == 0 && (CB == 16 || CB == 8 || CB == 4), "a row is whole copies");
  using Vec = CopyVec<CB>;                  // one copy's bytes
  extern __shared__ __align__(16) unsigned char smem[];

  const int warps = blockDim.x / 32, wib = threadIdx.x / 32;
  const int tiles = (cols + TM - 1) / TM;
  const int bpn = (tiles + warps - 1) / warps;  // blocks an n
  const int n = blockIdx.x / bpn;
  const int tile = (blockIdx.x % bpn) * warps + wib;
  if (tile >= tiles) return;
  const int lane = threadIdx.x % 32, cm = lane / G, g = lane % G;
  const int mc0 = tile * TM;  // the warp's first column of the window
  const int Dk = FULL ? DP : D;
  const long long plane = (long long)H * W;
  T* const ring = reinterpret_cast<T*>(smem) + wib * (kStages * STAGE);
  const int first_l = reverse ? H - 1 : 0;
  auto binrow = [](int d) { return (d % B) * G + d / B; };
  // This lane's share of a stage's copies and stores: the elements [col,
  // col + per) of rows row0, row0 + rstep, ... (whole copies when
  // vectorised, single elements otherwise).
  const int per = vec ? EPC : 1, cpr = TM / per;
  const int col = (lane % cpr) * per, row0 = lane / cpr, rstep = 32 / cpr;
  const bool live = mc0 + col < cols;  // whole copies: cols % EPC == 0 when vectorised
  const long long vbase = (long long)n * D * plane + col0 + mc0 + col;  // volumes
  const long long sbase = (long long)n * D * cols + mc0 + col;          // the seed
  const long long pbase = n * w_nstride + col0 + mc0 + col;             // weight, dw planes

  auto copy = [&](T* to, const T* from) {
    if (vec)
      cp_async<CB>(to, from);
    else
      *to = *from;
  };
  // Stage the walk's step s into slot `slot`: each volume's D rows (bin d
  // to its bin row), then the 5 weight and the 5 dw rows.
  auto prefetch = [&](int s, int slot) {
    if (!live) return;
    const int l = reverse ? s : H - 1 - s;
    const bool first = l == first_l;
    const long long row = (long long)l * W;
    T* const st = ring + slot * STAGE + col;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const T* from;
      long long pitch = plane;
      if (v == 1) {                    // A' is A one step back, or the seed
        if (first && !valid) continue; // the copy step reads no A'
        if (first) {
          from = seed + sbase;
          pitch = cols;
        } else {
          from = a + vbase + (long long)(reverse ? l + 1 : l - 1) * W;
        }
      } else {
        from = (v == 0 ? x : v == 2 ? gbar : static_cast<const T*>(dx)) + vbase + row;
      }
      from += row0 * pitch;
      T* to = st + v * DP * TM;
      for (int d = row0; d < Dk; d += rstep, from += rstep * pitch) copy(to + binrow(d) * TM, from);
    }
    for (int k = row0; k < 10; k += rstep)
      copy(st + (PROW + k) * TM,
           (k < 5 ? w + pbase + k * plane : static_cast<const T*>(dw) + pbase + (k - 5) * plane) +
               row);
  };

  // The carry of this lane's bins starts at dboundary.
  const bool active = mc0 + cm < cols;
  const long long rbase = (long long)n * D * cols + mc0 + cm;  // the lane's column of a row
  float c[B];
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int d = g * B + i;
    c[i] = dboundary != nullptr && active && (FULL || d < D) ? dboundary[rbase + (long long)d * cols]
                                                              : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < H) prefetch(k, k);
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < H; ++s) {
    if (s + kStages - 1 < H) prefetch(s + kStages - 1, (s + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();  // step s of every lane's copies is in the ring
    const int l = reverse ? s : H - 1 - s;
    T* const st = ring + (s % kStages) * STAGE;
    const T* xs = st;
    const T* as = st + DP * TM;
    T* bs = st + 2 * DP * TM;
    const T* os = st + 3 * DP * TM;
    T* ps = st + PROW * TM;
    float wv[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) wv[k] = to_f32(ps[k * TM + cm]);
    auto at = [&](int i) { return (i * G + g) * TM + cm; };  // this lane's bin i
    grad_step<G, B, FULL>(
        c, g, D, l == first_l && !valid, wv, [&](int i) { return to_f32(bs[at(i)]); },
        [&](int i) { return to_f32(xs[at(i)]); }, [&](int i) { return to_f32(as[at(i)]); },
        [&](int d) { return to_f32(as[binrow(d) * TM + cm]); },
        [&](int i) { return to_f32(os[at(i)]); },
        [&](int i, float v) { bs[at(i)] = from_f32<T>(v); },
        [&](int k, float v) {
          T& p = ps[(5 + k) * TM + cm];
          p = from_f32<T>(to_f32(p) + v);
        });
    __syncwarp();  // every lane's dx and dw are in the slot
    if (live) {
      T* to = dx + vbase + (long long)l * W + row0 * plane;
      for (int r = row0; r < Dk; r += rstep, to += rstep * plane) {
        if (vec)
          *reinterpret_cast<Vec*>(to) = *reinterpret_cast<const Vec*>(bs + binrow(r) * TM + col);
        else
          *to = bs[binrow(r) * TM + col];
      }
      for (int k = row0; k < 5; k += rstep) {
        T* p = dw + pbase + k * plane + (long long)l * W;
        if (vec)
          *reinterpret_cast<Vec*>(p) = *reinterpret_cast<const Vec*>(ps + (5 + k) * TM + col);
        else
          *p = ps[(5 + k) * TM + col];
      }
    }
    __syncwarp();  // every lane is done with the slot the next step refills
  }
  cp_async_wait<0>();
  // The carry past the sweep's first step is the seed's cotangent.
  if (active) {
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int d = g * B + i;
      if (FULL || d < D) dseed[rbase + (long long)d * cols] = c[i];
    }
  }
}

// What one launch runs: kernel geometry and staging path.
struct Plan {
  int vec, G, B, steps, stages, warps_per_block, blocks;
  size_t smem;
};

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// G lanes a column, B bins a lane: K3's ladder along H.
#define SGA_BWD_SEEDED_BY_D(CALL)    \
  if (D <= 8) return CALL(1, 8);     \
  if (D <= 16) return CALL(2, 8);    \
  if (D <= 32) return CALL(2, 16);   \
  if (D <= 64) return CALL(2, 32);   \
  if (D <= 128) return CALL(4, 32);  \
  if (D <= 256) return CALL(8, 32);  \
  if (D <= 512) return CALL(16, 32); \
  return cudaErrorInvalidValue;

// ptrs: x, w, a, gbar, dx, dw, seed (null without `valid`).
template <typename T, int G, int B>
Plan plan(const void* const (&ptrs)[7], int N, int D, int H, int W, int col0, int cols,
          long long w_nstride) {
  constexpr int TM = 32 / G, CB = copy_bytes<T, G>();
  const long long elem = sizeof(T);
  Plan p;
  p.G = G;
  p.B = B;
  p.steps = 1;
  p.stages = kStages;
  p.vec = (W * elem) % CB == 0 && (w_nstride * elem) % CB == 0 && (col0 * elem) % CB == 0 &&
          (cols * elem) % CB == 0;
  for (const void* q : ptrs) p.vec = p.vec && (q == nullptr || aligned(q, CB));
  constexpr size_t ring = (size_t)kStages * (4 * G * B + 10) * TM * sizeof(T);  // a warp's
  static_assert(kWarps * ring <= 232448, "a block's rings fit its 227 KB of shared memory");
  const int tiles = (cols + TM - 1) / TM;
  p.warps_per_block = std::min(kWarps, tiles);
  p.blocks = N * ((tiles + p.warps_per_block - 1) / p.warps_per_block);
  p.smem = p.warps_per_block * ring;
  return p;
}

template <typename T, int G, int B, bool FULL>
const void* kernel_of() {
  return reinterpret_cast<const void*>(sga_bwd_seeded_kernel<T, G, B, FULL>);
}

template <typename T, int G, int B, bool FULL>
cudaError_t launch_as(const Plan& p, const T* x, const T* w, const T* a, const T* seed,
                      const T* gbar, const float* dboundary, T* dx, T* dw, float* dseed, int D,
                      int H, int W, int col0, int cols, int reverse, int valid,
                      long long w_nstride, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel_of<T, G, B, FULL>(),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  sga_bwd_seeded_kernel<T, G, B, FULL><<<p.blocks, p.warps_per_block * 32, p.smem, stream>>>(
      x, w, a, seed, gbar, dboundary, dx, dw, dseed, D, H, W, col0, cols, w_nstride, reverse,
      valid, p.vec);
  return cudaGetLastError();
}

template <typename T, int G, int B>
cudaError_t launch(const T* x, const T* w, const T* a, const T* seed, const T* gbar,
                   const float* dboundary, T* dx, T* dw, float* dseed, int N, int D, int H,
                   int W, int col0, int cols, int reverse, int valid, long long w_nstride,
                   cudaStream_t stream) {
  const void* const ptrs[7] = {x, w, a, gbar, dx, dw, valid ? seed : nullptr};
  const Plan p = plan<T, G, B>(ptrs, N, D, H, W, col0, cols, w_nstride);
  if (D == G * B)
    return launch_as<T, G, B, true>(p, x, w, a, seed, gbar, dboundary, dx, dw, dseed, D, H, W,
                                    col0, cols, reverse, valid, w_nstride, stream);
  return launch_as<T, G, B, false>(p, x, w, a, seed, gbar, dboundary, dx, dw, dseed, D, H, W,
                                   col0, cols, reverse, valid, w_nstride, stream);
}

template <typename T, int G, int B>
cudaError_t describe(const void* const (&ptrs)[7], int N, int D, int H, int W, int col0, int cols,
                     long long w_nstride, int* info) {
  const Plan p = plan<T, G, B>(ptrs, N, D, H, W, col0, cols, w_nstride);
  const void* k = D == G * B ? kernel_of<T, G, B, true>() : kernel_of<T, G, B, false>();
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
#define SGA_BWD_SEEDED_LAUNCH(G, B)                                                          \
  launch<T, G, B>(x, w, a, seed, b, db, dx, dw, ds, N, D, H, W, col0, cols, reverse, valid, \
                  w_nstride, stream)
  SGA_BWD_SEEDED_BY_D(SGA_BWD_SEEDED_LAUNCH)
#undef SGA_BWD_SEEDED_LAUNCH
}

template <typename T>
cudaError_t dispatch_describe(const void* const (&ptrs)[7], int N, int D, int H, int W, int col0,
                              int cols, long long w_nstride, int* info) {
#define SGA_BWD_SEEDED_DESCRIBE(G, B) \
  describe<T, G, B>(ptrs, N, D, H, W, col0, cols, w_nstride, info)
  SGA_BWD_SEEDED_BY_D(SGA_BWD_SEEDED_DESCRIBE)
#undef SGA_BWD_SEEDED_DESCRIBE
}

}  // namespace

extern "C" {

// Largest D one launch takes (16 lanes x 32 bins a column).
int sga_sweep_bwd_seeded_max_d() { return 512; }

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

// What `sga_sweep_bwd_seeded` with these arguments launches, without
// launching (seed null: not `valid`): info[0..10] = vectorised staging (1)
// or element-wise (0), registers a thread, dynamic shared memory a block
// (bytes), local memory a thread (bytes; spills), lanes a column G, bins a
// lane B, steps a stage, stages in a warp's ring, warps a block, blocks,
// blocks resident an SM.  Returns a CUDA error.
int sga_sweep_bwd_seeded_describe(const void* x, const void* w, const void* a, const void* seed,
                                  const void* gbar, const void* dx, const void* dw, int N, int D,
                                  int H, int W, int col0, int cols, long long w_nstride,
                                  int dtype, int* info) {
  const void* const ptrs[7] = {x, w, a, gbar, dx, dw, seed};
  if (H < 1 || cols < 1 || col0 < 0 || col0 + cols > W) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_describe<float>(ptrs, N, D, H, W, col0, cols, w_nstride, info);
  if (dtype == 1)
    return dispatch_describe<__nv_bfloat16>(ptrs, N, D, H, W, col0, cols, w_nstride, info);
  return cudaErrorInvalidValue;
}

}  // extern "C"
