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
// sum over directions) in float32 and rounded once.
//
// Bound on this card: bytes.  A launch reads x, A, gbar and 5 weight planes
// and writes dx and 5 dw planes, (4 numel + 10 N H W) elements, and reads
// dx too when accumulating; about 25 f32 operations an element.  At
// GANet_deep's training blocks (240x528, batch 2) in bf16 the floors at
// 3.35 TB/s are 0.143 ms a storing and 0.178 ms an accumulating launch at
// full res (64, 64, 80, 176), 0.676 ms for a block's 4 directions (one
// storing, three accumulating), and 0.028 / 0.034 / 0.131 ms at half res
// (96, 32, 40, 88); in f32 twice as much.  The recurrence is sequential in
// l; the parallelism is the columns, one (n, m) position across the sweep
// (m = w for sweeps along H, m = h along W).
//
// Design: sga_fwd.cu's, applied to the transposed recurrence.
//  * A column's carry c lives in f32 registers over a group of G lanes of
//    one warp, B bins a lane (lane g owns d in [g*B, g*B + B)).  A step
//    turns c into g in place, sums the five products over the lane's bins,
//    then over the G lanes by xor-shuffles, and turns g into the next c in
//    place, carrying the old g(d-1) in one register; g(d+-1) across a lane
//    boundary is one shuffle each.  max_d A' is an in-lane max plus
//    xor-shuffles, or one `redux.sync` on an order-preserving integer image
//    when G = 32; the tie count is the lanes' counts of their own maximum,
//    where that equals the column's, summed (one `redux.sync` at G = 32).
//    A lane keeps a bit mask of the bins at its own maximum, so the
//    indicator e needs no second read of A'.
//  * Along W (G = 32) the five sums use a reduce-scatter butterfly over 8
//    slots: offsets 1, 2, 4 halve the slots a lane holds (4 + 2 + 1
//    shuffles, the two empty slots of the first level need none), offsets
//    8 and 16 add the one left, so that lane k holds dw[k], the lane that
//    writes it; one more shuffle broadcasts sum_d g from lane 4.
//  * Each warp stages its own inputs into its own ring of shared memory by
//    asynchronous copies ahead of use, and waits on them with
//    `cp.async.wait_group` plus `__syncwarp`.  Warps never wait on each
//    other: no block barrier, and a block is one warp.  dx and dw leave as
//    whole rows from the ring.  Accumulating, the old dx is added in f32
//    at the step that makes dx and rounded once.
//  * Sweeps along H (l = h): A' is the A row at l -+ 1, as aligned as x.
//    G and B as in sga_fwd.cu (2 lanes x 32 bins at D = 64, 16 columns a
//    warp: 32-byte bf16 rows; 8 x 32 at D = 256, 8-byte bf16 rows; 16 x 32
//    at D = 512, rows of 8 bytes in f32 and 4 in bf16); a stage is one step
//    of x, A', gbar, the old dx when accumulating and the 5 weight rows,
//    copied and stored 16 bytes (or a whole shorter row) at a time; dx
//    goes over the consumed gbar (only the lane that
//    owns a bin reads or writes it), dw into 5 rows of its own (every lane
//    of a column reads the weights); 2 steps in the ring storing, 4
//    accumulating.
//  * Sweeps along W (l = w): one column a warp, bins over the 32 lanes
//    (B = 1, 2, 4, 8 or 16, bin row (d % B) * 32 + d / B).  A stage holds a
//    run of 128 bytes (64 bf16 or 32 f32 steps) of every row of x and A'
//    and of the 5 weight rows, at a pitch of 132 bytes (33 words, odd: the
//    lanes' reads down the rows hit 32 banks), copied 4 bytes a lane, 2
//    stages; at B = 16 (D up to 512) a run of 64 bytes at a pitch of 68
//    (17 words), since 128-byte runs of 1,034 rows would take 272,976 bytes
//    of shared memory for the 2 stages, more than a block's 232,448, and
//    64-byte runs take 140,624.  dx goes out over the consumed x.  gbar
//    and the old dx are not staged: each of their rows is read by the one
//    lane that owns its bin,
//    so that lane loads its own bins' rows straight into registers, 8
//    steps at a time (4 at B = 4, 2 at B = 8, a word at B = 16), by 16-byte
//    loads where the
//    rows allow, one chunk ahead of use; at B = 8 the old dx is read at its
//    use instead (with it in registers too, the build spilled in bf16).  A stage so holds two volumes for both
//    launches, where staging every input took three storing and four
//    accumulating.  A' at step l is A at l -+ 1, one element off x's run:
//    A's run is staged one 4-byte unit wider on the side of the shift, so
//    that every copy stays a whole aligned unit; a unit outside the volume
//    is not copied and never read (only the sweep's first position would
//    read it, and that step reads no A').
//  * Instructions, not bytes, bounded the first build (about 4,000 SASS
//    instructions a step along H at D = 64, from cuobjdump): where every
//    lane's bins lie in [0, D) (D = G * B, warp-uniform; the model's D = 64
//    and 32) no bin is guarded, the lane maximum is kept without branches,
//    and each lane copies and stores a fixed slice of fixed rows with
//    pointer increments (along W by 32-bit shared addresses).
//  * Alignment: vectorised staging (16-byte copies and stores along H, or
//    8-byte where a row is 8 bytes, 4-byte along W) where x, A, gbar, dx,
//    w, dw and every row start allow, as at every shape of the model's
//    paths; element-wise (`ld.global` -> `st.shared`, element stores and
//    loads) otherwise.  In the gradient
//    walk of a forward sweep the first stage met along W is the ragged
//    tail: steps outside [0, L) are never run and never touch the carry.
//  * Measured on an H100 80GB HBM3 at 700 W with chip_smoke.py phase 6 on
//    edited copies of this source, in turns, over three calls that each
//    ran the layout of every input staged with 64-byte runs as well (its
//    block 1.946-1.963 ms in all three).  Full-res bf16, ms a storing /
//    accumulating W launch, and a block's 4 directions.  Every input
//    staged, three volumes a stage (four accumulating): 32-byte runs
//    0.633 / 0.749, 64-byte 0.502 / 0.611 (block 1.948), 128-byte 0.622 /
//    0.826 (shared memory per column bounds the columns in flight).  gbar
//    and the old dx in registers, 8 steps a chunk: 32-byte runs 0.751 /
//    1.098, 64-byte 0.485 / 0.705 (block 2.025), 64-byte with 3 stages
//    0.505 / 0.670, 128-byte 0.462-0.466 / 0.573-0.577 (block
//    1.887-1.898): this layout, 3 % faster than the staged 64-byte one at
//    full res in bf16, 7 % at half res in bf16 (block 0.396-0.398 against
//    0.421-0.427) and 9 % in f32 (0.532-0.535 against 0.581-0.585), level
//    at full res in f32 (2.602-2.624 against 2.612-2.623).  16 steps a
//    chunk in bf16: block 2.073 / 2.076.  Along H, 3 steps in the ring for
//    both launches: 0.348 / 0.466, against 0.293 / 0.450 with 2 and 4.  A
//    block's 4 directions took 4.348 ms in the previous design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCopy = 16;  // bytes of one copy along H, at most

// Bytes of one copy along H: 16, or a whole row of the 32/G columns a warp
// owns where that is less (8 bytes in bf16 at G = 8; 8 in f32 and 4 in
// bf16 at G = 16).
template <typename T, int G>
__host__ __device__ constexpr int copy_bytes_h() {
  return (32 / G) * (int)sizeof(T) < kCopy ? (32 / G) * (int)sizeof(T) : kCopy;
}

// One copy's bytes as a type, for the stores of a copy's width.
template <int CB>
using CopyVec = std::conditional_t<CB == 16, uint4, std::conditional_t<CB == 8, uint2, uint32_t>>;

// Steps in a warp's ring along H, for a storing launch and for an
// accumulating one; stages in a warp's ring along W, and the bytes of a row
// a stage holds along W at B bins a lane: 128, but 64 at B = 16 (D up to
// 512), where 128-byte runs would take 272,976 bytes of shared memory, more
// than a block has (see "Measured" in the header).
constexpr int kStagesH[2] = {2, 4};
constexpr int kStagesW = 2;
template <int B>
__host__ __device__ constexpr int run_w() {
  return B >= 16 ? 64 : 128;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// An asynchronous copy of BYTES (16, 8 or 4) from global to shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async_h(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {  // dst: shared address
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The max of v over the warp: one redux.sync on the floats' order-preserving
// integer image (negative floats have their magnitude bits flipped).
__device__ __forceinline__ float warp_max(float v) {
  int i = __float_as_int(v);
  i ^= (i >> 31) & 0x7fffffff;
  i = __reduce_max_sync(kFull, i);
  i ^= (i >> 31) & 0x7fffffff;
  return __int_as_float(i);
}

// The sums over the warp of v0..v4, reduce-scattered: lane k (and k + 8,
// k + 16, k + 24) returns the sum of v_k for k < 5, 0 for k = 5, 6, 7.
// Offsets 1, 2, 4 each halve the slots a lane holds; 8 and 16 add the one
// left.  8 shuffles.
__device__ __forceinline__ float warp_sum5(float v0, float v1, float v2, float v3, float v4,
                                           int lane) {
  const bool b0 = lane & 1, b1 = lane & 2, b2 = lane & 4;
  // Slot pairs (0, 1), (2, 3), (4, 5); (6, 7) are empty.  Keep slot 2p + b0.
  const float r0 = (b0 ? v1 : v0) + __shfl_xor_sync(kFull, b0 ? v0 : v1, 1);
  const float r1 = (b0 ? v3 : v2) + __shfl_xor_sync(kFull, b0 ? v2 : v3, 1);
  const float r2 = (b0 ? 0.f : v4) + __shfl_xor_sync(kFull, b0 ? v4 : 0.f, 1);
  // r0, r1 hold slots b0, b0 + 2; r2 and the empty r3 slots b0 + 4, b0 + 6.
  const float q0 = (b1 ? r1 : r0) + __shfl_xor_sync(kFull, b1 ? r0 : r1, 2);
  const float q1 = (b1 ? 0.f : r2) + __shfl_xor_sync(kFull, b1 ? r2 : 0.f, 2);
  // q0, q1 hold slots b0 + 2 b1 and that + 4.
  float t = (b2 ? q1 : q0) + __shfl_xor_sync(kFull, b2 ? q0 : q1, 4);
  t += __shfl_xor_sync(kFull, t, 8);
  t += __shfl_xor_sync(kFull, t, 16);
  return t;
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

// One gradient step of a column for this lane's bins d = dlo + i (B bins),
// the column spread over G lanes (g = this lane's index in the group).
// c holds the carry and becomes the next one.  FULL: every lane's bins lie
// in [0, D) (D == G * B, warp-uniform), and no bin is guarded.  Accessors:
// gb(i), xs(i), ap(i) give gbar, x and A' at bin i (only called for
// d < D); an(d) gives A' at any bin d in [0, D); old(i) the old dx;
// put_dx(i, v) stores dx; put_dw(k, v) stores dw[k] (called by the lanes
// that write dw).  wv are the step's 5 weights.
template <int G, int B, bool FULL, typename Gb, typename Xs, typename Ap, typename An,
          typename Old, typename PutDx, typename PutDw>
__device__ __forceinline__ void grad_step(float (&c)[B], int g, int lane, int D, bool first,
                                          bool accumulate, const float (&wv)[5], Gb gb, Xs xs,
                                          Ap ap, An an, Old old, PutDx put_dx, PutDw put_dw) {
  const int dlo = g * B;
  auto in = [&](int i) { return FULL || dlo + i < D; };
#pragma unroll
  for (int i = 0; i < B; ++i)
    if (in(i)) c[i] += gb(i);  // c is now g (0 at bins >= D)
  if (first) {  // the sweep's first position: dx = g, dw = 0, the walk ends
#pragma unroll
    for (int i = 0; i < B; ++i)
      if (in(i)) put_dx(i, accumulate ? c[i] + old(i) : c[i]);
    if (G == 32) {
      if (lane < 5) put_dw(lane, 0.f);
    } else {
      for (int k = g; k < 5; k += G) put_dw(k, 0.f);
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
  float M, SG, dwk;  // max_d A', sum_d g, and dw[k] on the lanes that write it
  unsigned cnt;
  if (G == 32) {
    M = warp_max(m.lm);
    cnt = __reduce_add_sync(kFull, m.lm == M ? m.lc : 0u);
    dwk = warp_sum5(s0, s1, s2, s3, sg, lane);
    SG = __shfl_sync(kFull, dwk, 4);
    if (lane == 4) dwk *= M;
  } else {
    M = m.lm;
#pragma unroll
    for (int off = 1; off < G; off *= 2) {
      s0 += __shfl_xor_sync(kFull, s0, off);
      s1 += __shfl_xor_sync(kFull, s1, off);
      s2 += __shfl_xor_sync(kFull, s2, off);
      s3 += __shfl_xor_sync(kFull, s3, off);
      sg += __shfl_xor_sync(kFull, sg, off);
      M = fmaxf(M, __shfl_xor_sync(kFull, M, off));
    }
    cnt = m.lm == M ? m.lc : 0u;
#pragma unroll
    for (int off = 1; off < G; off *= 2) cnt += __shfl_xor_sync(kFull, cnt, off);
    SG = sg;
    dwk = 0.f;
  }
  // dw, from the lanes that hold it.
  if (G == 32) {
    if (lane < 5) put_dw(lane, dwk);
  } else {
    for (int k = g; k < 5; k += G)
      put_dw(k, k == 0 ? s0 : k == 1 ? s1 : k == 2 ? s2 : k == 3 ? s3 : sg * M);
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
  // integer and the share within 2 ulps of the plain version's
  // (w4 sum_d g) (1 / count).
  const float share = __fdividef(wv[4] * SG, (float)max(cnt, 1u));
  const unsigned at_max = m.lm == M ? m.mask : 0u;
  float prev = gdn;  // g at d - 1
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const float cur = c[i];
    const float next = i + 1 < B ? c[i + 1] : gup;
    if (in(i)) {
      const float v = wv[0] * cur;
      put_dx(i, accumulate ? v + old(i) : v);
      c[i] = wv[1] * cur + wv[2] * next + wv[3] * prev + ((at_max >> i) & 1u ? share : 0.f);
    }
    prev = cur;
  }
}

// Sweep along H (l = h).  A warp owns TM = 32 / G columns adjacent along W.
// Its ring holds STAGES steps; a step's stage is, in rows of TM elements
// of T, DP rows each of x, A', gbar (dx on the way out) and, accumulating,
// the old dx (bin d at row (d % B) * G + d / B of its volume), then the 5
// weight rows and the 5 dw rows.
template <typename T, int G, int B, int STAGES>
__device__ __forceinline__ void sga_bwd_h(const T* __restrict__ x, const T* __restrict__ w,
                                          const T* __restrict__ a, const T* __restrict__ gbar,
                                          T* __restrict__ dx, T* __restrict__ dw, int N, int D,
                                          int H, int W, long long w_nstride, int reverse,
                                          int accumulate, int vec) {
  constexpr int TM = 32 / G;               // columns a warp owns
  constexpr int DP = G * B;                // bin rows of a volume
  constexpr int CB = copy_bytes_h<T, G>(); // bytes of one copy
  constexpr int EPC = CB / sizeof(T);      // elements of one copy
  static_assert(TM % EPC == 0, "a row is whole copies");
  using Vec = CopyVec<CB>;                 // one copy's bytes
  extern __shared__ __align__(16) unsigned char smem[];

  const int tiles = (W + TM - 1) / TM;
  const int warp = blockIdx.x;
  if (warp >= N * tiles) return;
  const int lane = threadIdx.x, cm = lane / G, g = lane % G;
  const int n = warp / tiles, m0 = (warp % tiles) * TM;
  const long long plane = (long long)H * W;
  const int vols = 3 + accumulate;     // volumes staged
  const int wrow = vols * DP;          // first weight row of a stage
  const int stage = (wrow + 10) * TM;  // elements of a stage
  T* ring = reinterpret_cast<T*>(smem);
  const int first_l = reverse ? H - 1 : 0;
  auto binrow = [&](int d) { return (d % B) * G + d / B; };
  // This lane's share of a stage's copies and stores: the elements [col,
  // col + per) of rows row0, row0 + rstep, ... (whole copies when
  // vectorised, single elements otherwise).
  const int per = vec ? EPC : 1, cpr = TM / per;
  const int col = (lane % cpr) * per, row0 = lane / cpr, rstep = 32 / cpr;
  const bool live = m0 + col < W;  // whole copies: W % EPC == 0 when vectorised
  auto vol = [&](int v) -> const T* { return v == 0 ? x : v == 1 ? a : v == 2 ? gbar : dx; };
  const long long base = (long long)n * D * plane + m0 + col;
  const T* const wsrc = w + n * w_nstride + m0 + col;

  // Stage the walk's step s into slot `slot`: each volume's D rows (bin d
  // to its bin row), then the weights' 5.
  auto issue = [&](int s, int slot) {
    if (!live) return;
    const int l = reverse ? s : H - 1 - s;
    T* st = ring + slot * stage + col;
    auto copy = [&](T* to, const T* from) {
      if (vec)
        cp_async_h<CB>(to, from);
      else
        *to = *from;
    };
    for (int v = 0; v < vols; ++v) {
      if (v == 1 && l == first_l) continue;  // the sweep's first position reads no A'
      const int lv = v == 1 ? (reverse ? l + 1 : l - 1) : l;  // A' is A one step back
      const T* from = vol(v) + base + (long long)lv * W + row0 * plane;
      T* to = st + v * DP * TM;
      for (int d = row0; d < D; d += rstep, from += rstep * plane) copy(to + binrow(d) * TM, from);
    }
    const T* from = wsrc + (long long)l * W + row0 * plane;
    for (int k = row0; k < 5; k += rstep, from += rstep * plane) copy(st + (wrow + k) * TM, from);
  };

  float c[B];
#pragma unroll
  for (int i = 0; i < B; ++i) c[i] = 0.f;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < H) issue(k, k);
    cp_async_commit();
  }
  const bool full = D == DP;
#pragma unroll 1
  for (int s = 0; s < H; ++s) {
    if (s + STAGES - 1 < H) issue(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // step s of every lane's copies is in the ring
    const int l = reverse ? s : H - 1 - s;
    T* st = ring + (s % STAGES) * stage;
    T* xs = st;
    T* as = st + DP * TM;
    T* bs = st + 2 * DP * TM;
    T* os = st + 3 * DP * TM;
    T* ws = st + wrow * TM;
    float wv[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) wv[k] = to_f32(ws[k * TM + cm]);
    auto at = [&](int i) { return (i * G + g) * TM + cm; };  // this lane's bin i
    auto step = [&](auto full_tag) {
      grad_step<G, B, decltype(full_tag)::value>(
          c, g, lane, D, l == first_l, accumulate, wv,
          [&](int i) { return to_f32(bs[at(i)]); }, [&](int i) { return to_f32(xs[at(i)]); },
          [&](int i) { return to_f32(as[at(i)]); },
          [&](int d) { return to_f32(as[binrow(d) * TM + cm]); },
          [&](int i) { return to_f32(os[at(i)]); },
          [&](int i, float v) { bs[at(i)] = from_f32<T>(v); },
          [&](int k, float v) { ws[(5 + k) * TM + cm] = from_f32<T>(v); });
    };
    if (full)
      step(std::true_type());
    else
      step(std::false_type());
    __syncwarp();  // every lane's dx and dw are in the slot
    if (live) {
      T* to = dx + base + (long long)l * W + row0 * plane;
      for (int r = row0; r < D; r += rstep, to += rstep * plane) {
        if (vec)
          *reinterpret_cast<Vec*>(to) = *reinterpret_cast<const Vec*>(bs + binrow(r) * TM + col);
        else
          *to = bs[binrow(r) * TM + col];
      }
      to = dw + (wsrc - w) + (long long)l * W + row0 * plane;
      for (int k = row0; k < 5; k += rstep, to += rstep * plane) {
        if (vec)
          *reinterpret_cast<Vec*>(to) = *reinterpret_cast<const Vec*>(ws + (5 + k) * TM + col);
        else
          *to = ws[(5 + k) * TM + col];
      }
    }
    __syncwarp();  // every lane is done with the slot the next step refills
  }
  cp_async_wait<0>();
}

// The sweep along H as a kernel.  At 16 lanes a column (D up to 512) a
// block count of one lets ptxas take more than the 128 registers it held
// the kernel to without one, where it spilled 12 bytes in bf16 (an H100
// build, PR 25); the kernels of fewer lanes keep their bounds.
#define SGA_BWD_H_ARGS                                                                            \
  const T *__restrict__ x, const T *__restrict__ w, const T *__restrict__ a,                      \
      const T *__restrict__ gbar, T *__restrict__ dx, T *__restrict__ dw, int N, int D, int H,    \
      int W, long long w_nstride, int reverse, int accumulate, int vec
template <typename T, int G, int B, int STAGES>
__global__ void __launch_bounds__(32) sga_bwd_h_kernel(SGA_BWD_H_ARGS) {
  sga_bwd_h<T, G, B, STAGES>(x, w, a, gbar, dx, dw, N, D, H, W, w_nstride, reverse, accumulate, vec);
}
template <typename T, int B, int STAGES>
__global__ void __launch_bounds__(32, 1) sga_bwd_h16_kernel(SGA_BWD_H_ARGS) {
  sga_bwd_h<T, 16, B, STAGES>(x, w, a, gbar, dx, dw, N, D, H, W, w_nstride, reverse, accumulate,
                              vec);
}
#undef SGA_BWD_H_ARGS

// Element k of a run of T packed in 4-byte words, as f32.
template <typename T, int CW>
__device__ __forceinline__ float unpack(const uint32_t (&r)[CW], int k) {
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(r[k]);
  else  // bf16: the element at the lower address is the low half
    return __uint_as_float(k & 1 ? r[k / 2] & 0xffff0000u : r[k / 2] << 16);
}

// CH elements of a row of T from element c0 on (c0 a multiple of CH) into
// words r, none at or past W: 16-byte loads (wide), 4-byte (vec), or one
// element at a time.
template <typename T, int CH, int CW>
__device__ __forceinline__ void load_run(uint32_t (&r)[CW], const T* row, int c0, int W, bool wide,
                                         bool vec) {
  constexpr int EPU = 4 / sizeof(T);
  if (CW % 4 == 0 && wide) {
#pragma unroll
    for (int q = 0; q < CW / 4; ++q)
      if (c0 + 4 * q * EPU < W) {
        const uint4 u = *reinterpret_cast<const uint4*>(row + c0 + 4 * q * EPU);
        r[4 * q] = u.x, r[4 * q + 1] = u.y, r[4 * q + 2] = u.z, r[4 * q + 3] = u.w;
      }
  } else if (vec) {
#pragma unroll
    for (int q = 0; q < CW; ++q)
      if (c0 + q * EPU < W) r[q] = *reinterpret_cast<const uint32_t*>(row + c0 + q * EPU);
  } else {
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (c0 + k >= W) continue;
      if constexpr (sizeof(T) == 4) {
        r[k] = *reinterpret_cast<const uint32_t*>(row + c0 + k);
      } else {
        const uint32_t h = *reinterpret_cast<const unsigned short*>(row + c0 + k);
        r[k / 2] = k & 1 ? (r[k / 2] & 0xffffu) | h << 16 : (r[k / 2] & 0xffff0000u) | h;
      }
    }
  }
}

// Sweep along W (l = w): one column (n, h) a warp, bin d = g * B + i on
// lane g.  The ring holds STAGES stages of S = RUN / elem steps; a stage
// is rows of S elements at a pitch of P = S + 4 / elem: DP = 32 B rows of
// x (dx on the way out, over the consumed x), DP rows of A' (its run one
// 4-byte unit wider), bin d at row (d % B) * 32 + d / B, then 5 weight
// rows and 5 dw rows.  gbar and, accumulating, the old dx are not staged:
// each lane loads its own bins' rows into registers, CH steps at a time,
// one chunk ahead of use.
template <typename T, int B, int RUN, int STAGES, bool ACC>
__global__ void __launch_bounds__(32)
sga_bwd_w_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ a,
                 const T* __restrict__ gbar, T* __restrict__ dx, T* __restrict__ dw, int N, int D,
                 int H, int W, long long w_nstride, int reverse, int vec, int wide) {
  constexpr int S = RUN / sizeof(T);  // steps a stage
  constexpr int U = RUN / 4;          // 4-byte units of a run
  constexpr int EPU = 4 / sizeof(T);  // elements of a unit
  constexpr int P = S + EPU;          // row pitch, elements: U + 1 words
  constexpr int DP = 32 * B;          // bin rows of a volume
  // Steps of a chunk held in registers: at B = 16 one word a bin (one f32
  // step, two bf16), where two f32 steps spilled (8 bytes, 255 registers).
  constexpr int CH = B >= 16 ? 4 / (int)sizeof(T) : B >= 8 ? 2 : B == 4 ? 4 : 8;
  constexpr int CW = CH * sizeof(T) / 4;  // words of a chunk of a row
  static_assert(U <= 32 && 32 % U == 0, "a warp copies whole rows");
  static_assert(S % CH == 0, "a stage is whole chunks");
  // Accumulating, the old dx is held one chunk ahead like gbar up to 4 bins
  // a lane; above, each lane reads it at its use (the registers of both
  // would spill).
  constexpr bool OLD_AHEAD = ACC && B <= 4;
  extern __shared__ __align__(16) unsigned char smem[];

  const int column = blockIdx.x;
  if (column >= N * H) return;
  const int g = threadIdx.x;
  const int n = column / H, h = column % H;
  const long long plane = (long long)H * W;
  const long long base = (long long)n * D * plane + (long long)h * W;
  const T* const wsrc = w + n * w_nstride + (long long)h * W;
  constexpr int wrow = 2 * DP;               // first weight row of a stage
  constexpr int stage = (wrow + 10) * P;     // elements of a stage
  T* ring = reinterpret_cast<T*>(smem);
  const int nst = (W + S - 1) / S;
  const int nq = (W + CH - 1) / CH;
  const int first_l = reverse ? W - 1 : 0;
  // The walk runs opposite to the forward: stages, chunks and steps in
  // descending l for a forward sweep, ascending for a reverse one.
  auto first_col = [&](int t) { return (reverse ? t : nst - 1 - t) * S; };
  auto chunk_col = [&](int q) { return (reverse ? q : nq - 1 - q) * CH; };
  // A's run starts one unit before x's for a forward sweep (A' = A at
  // l - 1), at x's for a reverse one (A' = A at l + 1, its run one unit
  // longer); A' of step j of a stage is element j + ash of A's row.
  const int a_lead = reverse ? 0 : EPU;
  const int ash = reverse ? 1 : EPU - 1;
  auto binrow = [&](int d) { return (d % B) * 32 + d / B; };
  // This lane's share of a vectorised stage: unit e / EPU of rows row0,
  // row0 + rstep, ...
  const int e = (g % U) * EPU, row0 = g / U;
  constexpr int rstep = 32 / U;

  // Stage t (in walk order) into slot `slot`: x's and A's D rows (bin d to
  // its bin row), then the weights' 5.  Units (elements) of a row outside
  // [0, W) are not copied.  Vectorised copies address shared memory by its
  // 32-bit shared address.
  const unsigned sring = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  auto issue = [&](int t, int slot) {
    const int l0 = first_col(t);
    T* st = ring + slot * stage;
    for (int v = 0; v <= 2; ++v) {
      const bool is_w = v == 2;
      const int rows = is_w ? 5 : D;
      const int c0 = v == 1 ? l0 - a_lead : l0;  // the l of a row's element 0
      const T* from = is_w ? wsrc : (v == 0 ? x : a) + base;
      T* to = st + v * DP * P;
      if (vec) {  // a 4-byte unit a lane; W is a multiple of EPU
        const unsigned sto = sring + (unsigned)((slot * stage + v * DP * P) * sizeof(T));
        if (c0 + e >= 0 && c0 + e < W) {
          const T* src = from + row0 * plane + c0 + e;
          if (is_w) {
            for (int r = row0; r < 5; r += rstep, src += rstep * plane)
              cp_async4(sto + (r * P + e) * sizeof(T), src);
          } else {
            for (int r = row0; r < D; r += rstep, src += rstep * plane)
              cp_async4(sto + (binrow(r) * P + e) * sizeof(T), src);
          }
        }
        if (v == 1 && c0 + S >= 0 && c0 + S < W)  // the unit that widens A's run
          for (int d = g; d < D; d += 32)
            cp_async4(sto + (binrow(d) * P + S) * sizeof(T), from + d * plane + c0 + S);
      } else {
        const int len = v == 1 ? P : S;  // elements of a row
        for (int q = g; q < rows * len; q += 32) {
          const int r = q / len, k = q % len;
          if (c0 + k >= 0 && c0 + k < W) to[(is_w ? r : binrow(r)) * P + k] = from[r * plane + c0 + k];
        }
      }
    }
  };

  // gbar and the old dx of this lane's bins: the chunk in use and the next.
  const int dlo = g * B;
  uint32_t gb[B][CW], gbn[B][CW], od[B][CW], odn[B][CW];
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int k = 0; k < CW; ++k) gb[i][k] = gbn[i][k] = od[i][k] = odn[i][k] = 0u;
  auto fetch = [&](int q) {  // chunk q (in walk order) into gbn, odn
    const int c0 = chunk_col(q);
#pragma unroll
    for (int i = 0; i < B; ++i) {
      if (dlo + i >= D) continue;
      const long long row = base + (long long)(dlo + i) * plane;
      load_run<T, CH>(gbn[i], gbar + row, c0, W, wide, vec);
      if (OLD_AHEAD) load_run<T, CH>(odn[i], dx + row, c0, W, wide, vec);
    }
  };

  float c[B];
#pragma unroll
  for (int i = 0; i < B; ++i) c[i] = 0.f;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < nst) issue(k, k);
    cp_async_commit();
  }
  fetch(0);
  const bool full = D == DP;
  int q = 0;  // chunk, in walk order
#pragma unroll 1
  for (int t = 0; t < nst; ++t) {
    if (t + STAGES - 1 < nst) issue(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // stage t of every lane's copies is in the ring
    const int l0 = first_col(t), nl = min(S, W - l0);
    T* st = ring + (t % STAGES) * stage;
    T* xs = st;
    T* as = st + DP * P;
    T* ws = st + wrow * P;
    auto chunks = [&](auto full_tag) {
#pragma unroll 1
      for (int cc = 0; cc < (nl + CH - 1) / CH; ++cc, ++q) {
#pragma unroll
        for (int i = 0; i < B; ++i)
#pragma unroll
          for (int k = 0; k < CW; ++k) gb[i][k] = gbn[i][k], od[i][k] = odn[i][k];
        if (q + 1 < nq) fetch(q + 1);
        const int c0 = chunk_col(q), jc = c0 - l0;
#pragma unroll
        for (int kk = 0; kk < CH; ++kk) {
          // The element of the chunk; the registers are picked by
          // compile-time indices (kk, CH - 1 - kk), never by k.
          const int k = reverse ? kk : CH - 1 - kk;
          if (c0 + k >= W) continue;
          const int j = jc + k;  // step of the stage
          float wv[5];
#pragma unroll
          for (int r = 0; r < 5; ++r) wv[r] = to_f32(ws[r * P + j]);
          auto at = [&](int i) { return (i * 32 + g) * P + j; };  // this lane's bin i
          grad_step<32, B, decltype(full_tag)::value>(
              c, g, g, D, c0 + k == first_l, ACC, wv,
              [&](int i) { return reverse ? unpack<T>(gb[i], kk) : unpack<T>(gb[i], CH - 1 - kk); },
              [&](int i) { return to_f32(xs[at(i)]); },
              [&](int i) { return to_f32(as[at(i) + ash]); },
              [&](int d) { return to_f32(as[binrow(d) * P + j + ash]); },
              [&](int i) {
                if constexpr (OLD_AHEAD)
                  return reverse ? unpack<T>(od[i], kk) : unpack<T>(od[i], CH - 1 - kk);
                else
                  return to_f32(dx[base + (long long)(dlo + i) * plane + c0 + k]);
              },
              [&](int i, float v) { xs[at(i)] = from_f32<T>(v); },
              [&](int r, float v) { ws[(5 + r) * P + j] = from_f32<T>(v); });
        }
      }
    };
    if (full)
      chunks(std::true_type());
    else
      chunks(std::false_type());
    __syncwarp();  // every lane's dx and dw of the stage are in the slot
    T* dxl = dx + base + l0;
    T* dwl = dw + (wsrc - w) + l0;
    if (vec) {
      if (e < nl) {
        T* to = dxl + row0 * plane + e;
        for (int r = row0; r < D; r += rstep, to += rstep * plane)
          *reinterpret_cast<uint32_t*>(to) = *reinterpret_cast<const uint32_t*>(xs + binrow(r) * P + e);
        to = dwl + row0 * plane + e;
        for (int k = row0; k < 5; k += rstep, to += rstep * plane)
          *reinterpret_cast<uint32_t*>(to) = *reinterpret_cast<const uint32_t*>(ws + (5 + k) * P + e);
      }
    } else {
      for (int qq = g; qq < (D + 5) * S; qq += 32) {
        const int r = qq / S, k = qq % S;
        if (k < nl) {
          if (r < D)
            dxl[r * plane + k] = xs[binrow(r) * P + k];
          else
            dwl[(r - D) * plane + k] = ws[(r - D + 5) * P + k];
        }
      }
    }
    __syncwarp();  // every lane is done with the slot before it is refilled
  }
  cp_async_wait<0>();
}

// What one launch runs: kernel geometry and staging path.
struct Plan {
  int vec, wide, G, B, steps, stages, warps_per_block, blocks;
  size_t smem;
};

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// G lanes a column, B bins a lane: along H as in sga_fwd.cu, along W a warp
// a column.
#define SGA_BWD_BY_D_H(CALL)         \
  if (D <= 8) return CALL(1, 8);     \
  if (D <= 16) return CALL(2, 8);    \
  if (D <= 32) return CALL(2, 16);   \
  if (D <= 64) return CALL(2, 32);   \
  if (D <= 128) return CALL(4, 32);  \
  if (D <= 256) return CALL(8, 32);  \
  if (D <= 512) return CALL(16, 32); \
  return cudaErrorInvalidValue;
#define SGA_BWD_BY_D_W(CALL)         \
  if (D <= 32) return CALL(32, 1);   \
  if (D <= 64) return CALL(32, 2);   \
  if (D <= 128) return CALL(32, 4);  \
  if (D <= 256) return CALL(32, 8);  \
  if (D <= 512) return CALL(32, 16); \
  return cudaErrorInvalidValue;

template <typename T, bool AW, int G, int B>
Plan plan(const void* const (&ptrs)[6], int N, int D, int H, int W, int accumulate,
          long long w_nstride) {
  Plan p;
  p.G = G;
  p.B = B;
  p.warps_per_block = 1;
  const int elem = sizeof(T);
  const int vols = 3 + accumulate;
  const int bytes = AW ? 4 : copy_bytes_h<T, G>();  // one copy
  p.vec = (W * elem) % bytes == 0 && (w_nstride * elem) % bytes == 0;
  for (const void* q : ptrs) p.vec = p.vec && aligned(q, bytes);
  // Along W gbar and the old dx go to registers by 16-byte loads where
  // their rows allow.
  p.wide = p.vec && (W * elem) % 16 == 0 && aligned(ptrs[3], 16) && aligned(ptrs[4], 16);
  if (AW) {
    p.steps = run_w<B>() / elem;
    p.stages = kStagesW;
    p.smem = (size_t)kStagesW * (2 * G * B + 10) * (run_w<B>() + 4);
    p.blocks = N * H;
  } else {
    const int TM = 32 / G;
    p.steps = 1;
    p.stages = kStagesH[accumulate];
    p.smem = (size_t)p.stages * (vols * G * B + 10) * TM * elem;
    p.blocks = N * ((W + TM - 1) / TM);
  }
  return p;
}

// The kernel of a launch: axis, lanes and bins, storing or accumulating.
template <typename T, bool AW, int G, int B, int ACC>
const void* kernel_of() {
  if constexpr (AW)
    return reinterpret_cast<const void*>(sga_bwd_w_kernel<T, B, run_w<B>(), kStagesW, ACC == 1>);
  else if constexpr (G == 16)
    return reinterpret_cast<const void*>(sga_bwd_h16_kernel<T, B, kStagesH[ACC]>);
  else
    return reinterpret_cast<const void*>(sga_bwd_h_kernel<T, G, B, kStagesH[ACC]>);
}

template <typename T, bool AW, int G, int B, int ACC>
cudaError_t launch_as(const Plan& p, const T* x, const T* w, const T* a, const T* gbar, T* dx,
                      T* dw, int N, int D, int H, int W, int reverse, long long w_nstride,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel_of<T, AW, G, B, ACC>(),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  if constexpr (AW)
    sga_bwd_w_kernel<T, B, run_w<B>(), kStagesW, ACC == 1><<<p.blocks, 32, p.smem, stream>>>(
        x, w, a, gbar, dx, dw, N, D, H, W, w_nstride, reverse, p.vec, p.wide);
  else if constexpr (G == 16)
    sga_bwd_h16_kernel<T, B, kStagesH[ACC]><<<p.blocks, 32, p.smem, stream>>>(
        x, w, a, gbar, dx, dw, N, D, H, W, w_nstride, reverse, ACC, p.vec);
  else
    sga_bwd_h_kernel<T, G, B, kStagesH[ACC]><<<p.blocks, 32, p.smem, stream>>>(
        x, w, a, gbar, dx, dw, N, D, H, W, w_nstride, reverse, ACC, p.vec);
  return cudaGetLastError();
}

template <typename T, bool AW, int G, int B>
cudaError_t launch(const T* x, const T* w, const T* a, const T* gbar, T* dx, T* dw, int N, int D,
                   int H, int W, int reverse, int accumulate, long long w_nstride,
                   cudaStream_t stream) {
  const void* const ptrs[6] = {x, w, a, gbar, dx, dw};
  const Plan p = plan<T, AW, G, B>(ptrs, N, D, H, W, accumulate, w_nstride);
  if (accumulate)
    return launch_as<T, AW, G, B, 1>(p, x, w, a, gbar, dx, dw, N, D, H, W, reverse, w_nstride, stream);
  return launch_as<T, AW, G, B, 0>(p, x, w, a, gbar, dx, dw, N, D, H, W, reverse, w_nstride, stream);
}

template <typename T, bool AW, int G, int B>
cudaError_t describe(const void* const (&ptrs)[6], int N, int D, int H, int W, int accumulate,
                     long long w_nstride, int* info) {
  const Plan p = plan<T, AW, G, B>(ptrs, N, D, H, W, accumulate, w_nstride);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(
      &attr, accumulate ? kernel_of<T, AW, G, B, 1>() : kernel_of<T, AW, G, B, 0>());
  if (err != cudaSuccess) return err;
  const int v[] = {p.vec, attr.numRegs, (int)p.smem, (int)attr.localSizeBytes, p.G, p.B,
                   p.steps, p.stages, p.warps_per_block, p.blocks};
  for (int i = 0; i < 10; ++i) info[i] = v[i];
  return cudaSuccess;
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
#define SGA_BWD_LAUNCH(AW, G, B) \
  launch<T, AW, G, B>(x, w, a, b, dx, dw, N, D, H, W, reverse, accumulate, w_nstride, stream)
#define SGA_BWD_LAUNCH_W(G, B) SGA_BWD_LAUNCH(true, G, B)
#define SGA_BWD_LAUNCH_H(G, B) SGA_BWD_LAUNCH(false, G, B)
  if (axis_w) {
    SGA_BWD_BY_D_W(SGA_BWD_LAUNCH_W)
  }
  SGA_BWD_BY_D_H(SGA_BWD_LAUNCH_H)
#undef SGA_BWD_LAUNCH_H
#undef SGA_BWD_LAUNCH_W
#undef SGA_BWD_LAUNCH
}

template <typename T>
cudaError_t dispatch_describe(const void* const (&ptrs)[6], int N, int D, int H, int W,
                              int axis_w, int accumulate, long long w_nstride, int* info) {
#define SGA_BWD_DESCRIBE(AW, G, B) \
  describe<T, AW, G, B>(ptrs, N, D, H, W, accumulate, w_nstride, info)
#define SGA_BWD_DESCRIBE_W(G, B) SGA_BWD_DESCRIBE(true, G, B)
#define SGA_BWD_DESCRIBE_H(G, B) SGA_BWD_DESCRIBE(false, G, B)
  if (axis_w) {
    SGA_BWD_BY_D_W(SGA_BWD_DESCRIBE_W)
  }
  SGA_BWD_BY_D_H(SGA_BWD_DESCRIBE_H)
#undef SGA_BWD_DESCRIBE_H
#undef SGA_BWD_DESCRIBE_W
#undef SGA_BWD_DESCRIBE
}

}  // namespace

extern "C" {

// Largest D one launch takes (16 lanes x 32 bins along H, 32 x 16 along W).
int sga_sweep_bwd_max_d() { return 512; }

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

// What `sga_sweep_bwd` with these arguments launches, without launching:
// info[0..9] = vectorised staging (1) or element-wise (0), registers a
// thread, dynamic shared memory a block (bytes), local memory a thread
// (bytes; spills), lanes a column G, bins a lane B, steps a stage, stages
// in a warp's ring, warps a block, blocks.  Returns a CUDA error.
int sga_sweep_bwd_describe(const void* x, const void* w, const void* a, const void* gbar,
                           const void* dx, const void* dw, int N, int D, int H, int W,
                           int axis_w, int accumulate, long long w_nstride, int dtype,
                           int* info) {
  const void* const ptrs[6] = {x, w, a, gbar, dx, dw};
  if (dtype == 0)
    return dispatch_describe<float>(ptrs, N, D, H, W, axis_w, accumulate, w_nstride, info);
  if (dtype == 1)
    return dispatch_describe<__nv_bfloat16>(ptrs, N, D, H, W, axis_w, accumulate, w_nstride,
                                            info);
  return cudaErrorInvalidValue;
}

}  // extern "C"
