// What the flood kernels K1 (flood.cu) and K3 (flood_stats.cu) share: the
// arithmetic of every test and distance, and the staging of a sub-chunk.
// Both must compute every (sample, witness) distance the same way, so that
// K3's output equals K1's bit for bit and K1's admitted units stay within
// K3's computed tiles; keeping the forms here makes that hold by
// construction.
//
// Arithmetic. The sources are built with -fmad=false: every multiply and
// add is rounded on its own, as in the plain PyTorch versions, unless an
// FMA is written out. The one FMA is in the per-pair distance, contracted
// to d2 = fma(dz, dz, fma(dy, dy, dx * dx)): 7 issued instructions per
// pair with the min (the inner loop of flood_min_few<3> in SASS),
// against 9 for the separately rounded form. It moves d2 by an ulp or so
// from the plain version (3.7e-9 at most on the main path's operands,
// against a 1e-6 bar); the ball, box and tile tests are not contracted,
// and on every input checked the admitted units equal the plain version's.
// The expanded form |y|^2 - 2x.y + |x|^2 is never used: in fp32 its error
// is about eps * R^2 in d2, large next to small d2
// (flooder_tpu/ops/pallas_flood.py:51-56).
//
// Staging. A sub-chunk of SUB witnesses is fetched raw with cp.async, each
// lane copying its own slots (fetch_raw), and later staged ball-local into
// a shared tile by the same lanes (stage_compacted), so the raw copy needs
// no barrier. A staged witness is one float4 up to 4 coordinates and two
// (Staged8) for 5-8, with the components past DIM at 0; the template
// instances take 1-8 coordinates. Staging compacts each
// SEGW-witness segment: in-ball witnesses to the front (warp ballot +
// popc), out-of-ball ones (moved to MASK) behind them. The inner loop
// (min_over_staged) runs over the in-ball count rounded up to UNROLL, so
// padding slots hold out-of-ball witnesses, and a sub-chunk with none in
// the ball folds in the one value such a witness gives: min is exact, so
// the result is the min over all SUB witnesses bit for bit. K3 stages so;
// K1's template instances stage one segment at a time (fetch_segment,
// stage_segment) with the same compaction (compact_segment) and inner loop
// (min_over_segment), so K3's output equals theirs bit for bit.
//
// Runtime width (9 and more coordinates; the wide_* forms at the end). The
// pair loop is a register tile shaped like a matrix product whose inner
// term is (y - x)^2 instead of x * y: each thread keeps WIDE_TM samples x
// WIDE_TN witnesses of partial d2 in registers and walks the coordinates,
// reading both operands coordinate-major from shared memory with 128-bit
// loads. Samples come from a coordinate-major copy, (S, NR, dim, RT). A
// unit's in-ball witnesses are compacted in witness order (warp ballot +
// popc per 32 witnesses and a prefix over the sub-chunk, no shared
// atomics). Up to WIDE_KS coordinates (one slab) the tile's samples are
// staged once per simplex and a unit's witnesses once per unit, and K1
// fetches the next candidate's rows with cp.async while a unit computes;
// past WIDE_KS both operands go through shared memory in slabs of WIDE_KS
// coordinates, 32 witnesses at a time, and the partial sums persist across
// slabs (the K-loop of a matrix product). Each d2 is summed in coordinate
// order with one FMA a coordinate, d2 = fma(t, t, d2) with t = y - x (the
// first coordinate t * t), as the template instances do: it differs from
// the plain versions' separately rounded sums by the rounding of two
// summation orders, at most 2 * dim * 2^-24 * d2. K3's wide instance uses
// the same forms, so its output equals K1's bit for bit; so do K1's
// few-sample instances past 8 coordinates (flood.cu), whose register tiles
// read samples FEW_RT or 64 floats a row (wide_accumulate's XS).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace flood {

constexpr int SUB = 512;          // witnesses per sub-chunk
constexpr float MASK = 3e18f;     // out-of-ball witnesses move here
constexpr int SEGW = 128;         // witnesses per staging segment (4 a lane)
constexpr int NSEG = SUB / SEGW;  // segments per sub-chunk
constexpr int UNROLL = 4;         // inner-loop unroll; counts round up to it
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DIM = 8;  // the widest template instance
// A masked witness's d2 against a ball-local sample is a sum of dim terms of
// about MASK^2 = 9e36, in coordinate order. For the template instances
// (dim <= 8) it is at most 7.2e37, under FLT_MAX (3.4e38) by a factor of
// 4.7: finite and at or above the callers' 1e30 "no witness" mark.
static_assert(MAX_DIM * 9e36f < 3.4e38f, "masked d2 must stay finite");
// The wide instances sum the same terms with one FMA a term, so a masked
// d2 differs from the plain versions' value by a few ulps at most: finite
// (>= 8.1e37) up to 37 coordinates, and +inf from 38 on, where 38 * 9e36
// passes FLT_MAX by 0.5 %, far beyond any rounding, on both sides alike. Both
// sides then act alike on it: a unit with no in-ball witness folds in +inf
// (fminf leaves acc as it was, torch.minimum too); a tile whose samples met
// no in-ball witness keeps acc = +inf, so its max is +inf and the tile bound
// min(+inf, ub2) is ub2 on both sides; and the callers' _inf_masked maps
// every d2 >= 1e30, finite or not, to +inf.

// A staged witness of 5-8 coordinates: two float4, read as two LDS.128.
struct __align__(16) Staged8 {
  float4 lo, hi;
};
template <int DIM>
using Staged = typename std::conditional<(DIM <= 4), float4, Staged8>::type;
// Static shared memory a CTA may declare; past it a buffer goes dynamic.
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;

// Whether a kernel keeps its raw fetch buffer (SUB * DIM floats) in dynamic
// shared memory: beside the two staged tiles (and 1 KB for the kernel's
// small arrays) it would pass the static limit. Only at DIM 8 (16,384 +
// 32,768 B); at DIM 7 the two take 47,104 B.
template <int DIM>
__host__ __device__ constexpr bool raw_dynamic() {
  return SUB * DIM * sizeof(float) + 2 * SUB * sizeof(Staged<DIM>) + 1024 >
         STATIC_SMEM_LIMIT;
}

__device__ __forceinline__ float sq_add(float acc, float diff) {
  return __fadd_rn(acc, __fmul_rn(diff, diff));
}

__device__ __forceinline__ float comp(const float4 &v, int d) {
  return d == 0 ? v.x : d == 1 ? v.y : d == 2 ? v.z : v.w;
}
__device__ __forceinline__ float comp(const Staged8 &v, int d) {
  return d < 4 ? comp(v.lo, d) : comp(v.hi, d - 4);
}

__device__ __forceinline__ void pack(const float (&v)[4], float4 &out) {
  out = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void pack(const float (&v)[8], Staged8 &out) {
  out.lo = make_float4(v[0], v[1], v[2], v[3]);
  out.hi = make_float4(v[4], v[5], v[6], v[7]);
}

// Witness y in ball-local coordinates (y - c), and whether it lies in the
// ball (|y - c|^2 <= r2, summed in coordinate order). Components past DIM
// are 0.
template <int DIM>
__device__ __forceinline__ bool ball_local(const float *y, const float *c,
                                           float r2, Staged<DIM> &yl) {
  constexpr int N = DIM <= 4 ? 4 : 8;
  float v[N] = {};
  float y2 = 0.f;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    v[d] = __fsub_rn(y[d], c[d]);
    y2 = d == 0 ? __fmul_rn(v[d], v[d]) : sq_add(y2, v[d]);
  }
  pack(v, yl);
  return y2 <= r2;
}

// The staged form of an out-of-ball witness.
template <int DIM>
__device__ __forceinline__ Staged<DIM> masked() {
  constexpr int N = DIM <= 4 ? 4 : 8;
  float v[N];
#pragma unroll
  for (int d = 0; d < N; ++d) v[d] = d < DIM ? MASK : 0.f;
  Staged<DIM> m;
  pack(v, m);
  return m;
}

// Squared distance from sample x to a staged witness y, coordinate order.
template <int DIM>
__device__ __forceinline__ float pair_d2(const Staged<DIM> &y,
                                         const float *x) {
  const float d0 = __fsub_rn(comp(y, 0), x[0]);
  float d2 = __fmul_rn(d0, d0);
#pragma unroll
  for (int d = 1; d < DIM; ++d) {
    const float dd = __fsub_rn(comp(y, d), x[d]);
    d2 = __fmaf_rn(dd, dd, d2);
  }
  return d2;
}

// Squared distance from the ball centre c to the sub-chunk's box (the
// ball test).
template <int DIM>
__device__ __forceinline__ float near2(const float *sub_lo,
                                       const float *sub_hi, int sub,
                                       const float *c) {
  float n2 = 0.f;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const float lo = sub_lo[(size_t)sub * DIM + d];
    const float hi = sub_hi[(size_t)sub * DIM + d];
    n2 = sq_add(n2, __fsub_rn(fminf(fmaxf(c[d], lo), hi), c[d]));
  }
  return n2;
}

// Squared gap between the sub-chunk's box and a sample box (a tile's, or
// a simplex's), both ball-local.
template <int DIM>
__device__ __forceinline__ float gap2(const float *sub_lo,
                                      const float *sub_hi, int sub,
                                      const float *c, const float *tlo,
                                      const float *thi) {
  float g2 = 0.f;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const float blo = __fsub_rn(sub_lo[(size_t)sub * DIM + d], c[d]);
    const float bhi = __fsub_rn(sub_hi[(size_t)sub * DIM + d], c[d]);
    const float g =
        fmaxf(fmaxf(__fsub_rn(blo, thi[d]), __fsub_rn(tlo[d], bhi)), 0.f);
    g2 = sq_add(g2, g);
  }
  return g2;
}

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Warp `warp` of `nw` fetches its segments of sub-chunk `sub` into `raw`
// (SUB * DIM floats, 16-byte aligned), each lane its own 4 witnesses of a
// segment; `witnesses` is 16-byte aligned. Only the fetching lane reads its
// slots back (stage_compacted, same warp and lane), so no barrier is needed.
template <int DIM>
__device__ __forceinline__ void fetch_raw(float *raw, const float *witnesses,
                                          int sub, int warp, int nw,
                                          int lane) {
  cp_async_wait_all();  // no older copy may land after this one
  for (int seg = warp; seg < NSEG; seg += nw) {
    const size_t off = (size_t)(seg * SEGW + 4 * lane) * DIM;
    const float *src = witnesses + (size_t)sub * SUB * DIM + off;
#pragma unroll
    for (int j = 0; j < DIM; ++j) cp_async16(raw + off + 4 * j, src + 4 * j);
  }
  cp_async_commit();
}

// One warp compacts a SEGW-witness segment: this lane's 4 witnesses (raw,
// at `own`) ball-local into `seg_dst`, the segment's in-ball witnesses at
// the front and the others (moved to MASK) from the back. Returns the
// segment's in-ball count, the same in every lane.
template <int DIM>
__device__ __forceinline__ int compact_segment(const float *own,
                                               const float *c, float r2,
                                               Staged<DIM> *seg_dst,
                                               int lane) {
  const unsigned lanes_below = (1u << lane) - 1u;
  Staged<DIM> yl[4];
  bool in[4];
  int below = 0, cnt = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    in[i] = ball_local<DIM>(own + i * DIM, c, r2, yl[i]);
    const unsigned bal = __ballot_sync(FULL, in[i]);
    below += __popc(bal & lanes_below);
    cnt += __popc(bal);
  }
  int nin = below, nout = 4 * lane - below;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // in-ball witnesses to the front, the others from the back
    const int pos = in[i] ? nin++ : SEGW - 1 - nout++;
    seg_dst[pos] = in[i] ? yl[i] : masked<DIM>();
  }
  return cnt;
}

// Stage the sub-chunk that fetch_raw brought into `raw` into `dst` (SUB
// staged witnesses), ball-local and compacted per segment; segcnt[seg] is the
// segment's in-ball count. Readers need a barrier after it.
template <int DIM>
__device__ __forceinline__ void stage_compacted(const float *raw,
                                                const float *c, float r2,
                                                Staged<DIM> *dst,
                                                int *segcnt,
                                                int warp, int nw, int lane) {
  cp_async_wait_all();
  for (int seg = warp; seg < NSEG; seg += nw) {
    const int cnt = compact_segment<DIM>(
        raw + (size_t)(seg * SEGW + 4 * lane) * DIM, c, r2, dst + seg * SEGW,
        lane);
    if (lane == 0) segcnt[seg] = cnt;
  }
}

// acc[k] = min(acc[k], d2 from sample x[k] to the first n witnesses of a
// compacted segment, n rounded up to UNROLL): the inner loop.
template <int DIM, int SPT>
__device__ __forceinline__ void min_over_segment(const Staged<DIM> *ys,
                                                 int n,
                                                 float (&x)[SPT][DIM],
                                                 float (&acc)[SPT]) {
  const int n_pad = (n + UNROLL - 1) / UNROLL * UNROLL;
#pragma unroll 4
  for (int w = 0; w < n_pad; ++w) {
    const Staged<DIM> yv = ys[w];
#pragma unroll
    for (int k = 0; k < SPT; ++k)
      acc[k] = fminf(acc[k], pair_d2<DIM>(yv, x[k]));
  }
}

// A unit with no in-ball witness: every witness of it is masked and gives
// this value, which the min over all SUB witnesses folds in.
template <int DIM, int SPT>
__device__ __forceinline__ void fold_masked(float (&x)[SPT][DIM],
                                            float (&acc)[SPT]) {
  const Staged<DIM> m = masked<DIM>();
#pragma unroll
  for (int k = 0; k < SPT; ++k) acc[k] = fminf(acc[k], pair_d2<DIM>(m, x[k]));
}

// acc[k] = min(acc[k], d2 from sample x[k] to every witness of a staged
// sub-chunk). Returns the sub-chunk's in-ball count.
template <int DIM, int SPT>
__device__ __forceinline__ int min_over_staged(const Staged<DIM> *wsh,
                                               const int *segcnt,
                                               float (&x)[SPT][DIM],
                                               float (&acc)[SPT]) {
  int total = 0;
  for (int seg = 0; seg < NSEG; ++seg) {
    const int n = segcnt[seg];
    total += n;
    min_over_segment<DIM, SPT>(wsh + seg * SEGW, n, x, acc);
  }
  if (total == 0) fold_masked<DIM, SPT>(x, acc);
  return total;
}

// A warp that stages a sub-chunk one segment at a time (K1's few-sample
// instances): this lane's 4 witnesses of segment `seg` of sub-chunk `sub`
// into its own slots of `raw` (SEGW * DIM floats, 16-byte aligned) with
// cp.async. Only this lane reads them back (stage_segment).
template <int DIM>
__device__ __forceinline__ void fetch_segment(float *raw,
                                              const float *witnesses,
                                              int sub, int seg, int lane) {
  cp_async_wait_all();  // no older copy may land after this one
  const size_t off = (size_t)4 * lane * DIM;
  const float *src =
      witnesses + ((size_t)sub * SUB + seg * SEGW) * DIM + off;
#pragma unroll
  for (int j = 0; j < DIM; ++j) cp_async16(raw + off + 4 * j, src + 4 * j);
  cp_async_commit();
}

// Compact the segment that fetch_segment brought into `raw` into `dst`
// (SEGW staged witnesses); returns its in-ball count. The warp's readers
// need __syncwarp after it.
template <int DIM>
__device__ __forceinline__ int stage_segment(const float *raw, const float *c,
                                             float r2, Staged<DIM> *dst,
                                             int lane) {
  cp_async_wait_all();
  return compact_segment<DIM>(raw + (size_t)4 * lane * DIM, c, r2, dst,
                              lane);
}

// ---------------------------------------------------------------------------
// Runtime width: the forms of the wide instances (9 and more coordinates)
// ---------------------------------------------------------------------------

constexpr int WIDE_TM = 8;  // samples a thread (register tile rows)
constexpr int WIDE_TN = 8;  // witnesses a thread (register tile columns)
constexpr int WIDE_WL = 4;  // lanes of a warp that share samples
constexpr int WIDE_STEP = WIDE_WL * WIDE_TN;             // 32 witnesses
constexpr int WIDE_WARP_SAMPLES = 32 / WIDE_WL * WIDE_TM;  // 64 samples
constexpr int WIDE_KS = 16;            // coordinates of a slab
constexpr int WIDE_GROUPS = SUB / 32;  // ballot groups of a sub-chunk
constexpr int WIDE_XS = 512;  // floats a staged coordinate row of samples
constexpr int WIDE_MAX_WARPS = WIDE_XS / WIDE_WARP_SAMPLES;  // at rt 512
// A CTA has rt / 2 threads: rt / 64 warps, each on 64 of the tile's
// samples. Lane l holds samples xo + {0..3, 32..35} with xo = 64 * warp +
// 4 * (l >> 2), and witnesses wo + {0..3, 16..19} of each 32-witness step
// with wo = 4 * (l & 3): one LDS.128 of 8 lanes reads 128 contiguous bytes.

// Slots a unit of m in-ball witnesses computes: m rounded up to a step, and
// one step of masked witnesses when m is 0 (the value every out-of-ball
// witness gives, as the plain versions' min over all SUB).
__host__ __device__ constexpr int wide_padded(int m) {
  return m == 0 ? WIDE_STEP : (m + WIDE_STEP - 1) / WIDE_STEP * WIDE_STEP;
}

// Dynamic shared memory of the wide forms at `dim` coordinates: up to
// WIDE_KS coordinates the tile's samples (dim, WIDE_XS), the staged unit
// (dim, SUB) and, with `raw`, the raw rows of the next candidate (SUB,
// dim); past it a slab of each, (WIDE_KS, WIDE_XS) and (WIDE_KS,
// WIDE_STEP), and the unit's in-ball positions (SUB shorts). Both strides
// are constants, so the pair loop's addresses are immediates.
__host__ __device__ constexpr size_t wide_smem_bytes(int dim, bool raw) {
  return dim <= WIDE_KS
             ? ((size_t)dim * WIDE_XS + (raw ? 2 : 1) * (size_t)dim * SUB) * 4
             : ((size_t)WIDE_KS * WIDE_XS + WIDE_KS * WIDE_STEP) * 4 +
                   SUB * 2;
}

// The ball test at runtime width: squared distance from the centre c to
// sub-chunk `sub`'s box.
__device__ __forceinline__ float near2_wide(const float *sub_lo,
                                            const float *sub_hi, int sub,
                                            const float *c, int dim) {
  float n2 = 0.f;
  for (int d = 0; d < dim; ++d) {
    const float lo = sub_lo[(size_t)sub * dim + d];
    const float hi = sub_hi[(size_t)sub * dim + d];
    n2 = sq_add(n2, __fsub_rn(fminf(fmaxf(c[d], lo), hi), c[d]));
  }
  return n2;
}

// The squared gap between sub-chunk `sub`'s box and a ball-local sample box
// (a tile's, or a simplex's) at runtime width.
__device__ __forceinline__ float gap2_wide(const float *sub_lo,
                                           const float *sub_hi, int sub,
                                           const float *c, const float *tlo,
                                           const float *thi, int dim) {
  float g2 = 0.f;
  for (int d = 0; d < dim; ++d) {
    const float blo = __fsub_rn(sub_lo[(size_t)sub * dim + d], c[d]);
    const float bhi = __fsub_rn(sub_hi[(size_t)sub * dim + d], c[d]);
    const float g =
        fmaxf(fmaxf(__fsub_rn(blo, thi[d]), __fsub_rn(tlo[d], bhi)), 0.f);
    g2 = sq_add(g2, g);
  }
  return g2;
}

__device__ __forceinline__ void cp_async4(void *smem, const void *gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Fetch the rows of sub-chunk `sub` that wide_ball_test gives this thread
// (witnesses tid + i * blockDim.x) into raw, (SUB, dim) floats. Only this
// thread reads them back, so no barrier is needed.
__device__ __forceinline__ void wide_fetch_raw(float *raw,
                                               const float *witnesses,
                                               int sub, int dim) {
  cp_async_wait_all();  // no older copy may land after this one
  const float *src = witnesses + (size_t)sub * SUB * dim;
  for (int w = threadIdx.x; w < SUB; w += blockDim.x)
    for (int d = 0; d < dim; ++d)
      cp_async4(raw + w * dim + d, src + (size_t)w * dim + d);
  cp_async_commit();
}

// Staging a unit, part 1: the ball test (|y - c|^2 <= r2, summed in
// coordinate order, separately rounded as in the plain versions) of the
// SUB rows at `rows` (shared or global memory). This thread tests
// witnesses tid + i * blockDim.x: bit i of the result is set when that one
// lies in the ball. gcnt[g] gets the in-ball count of witnesses [32 g,
// 32 g + 32). Readers of gcnt need a barrier after it.
__device__ __forceinline__ unsigned wide_ball_test(const float *rows,
                                                   const float *c, float r2,
                                                   int dim, int *gcnt) {
  const int lane = threadIdx.x & 31;
  unsigned in_mask = 0;
  for (int i = 0, w = threadIdx.x; w < SUB; ++i, w += blockDim.x) {
    const float *y = rows + (size_t)w * dim;
    float y2 = 0.f;
    for (int d = 0; d < dim; ++d) y2 = sq_add(y2, __fsub_rn(y[d], c[d]));
    const bool in = y2 <= r2;
    const unsigned bal = __ballot_sync(FULL, in);
    if (lane == 0) gcnt[w >> 5] = __popc(bal);
    in_mask |= static_cast<unsigned>(in) << i;
  }
  return in_mask;
}

// Staging a unit, part 2 (after a barrier): the in-ball witnesses in
// witness order, ball-local, into ws (dim, SUB) when the tile is one slab
// (`one`), with slots [m, wide_padded(m)) masked; else their positions in
// the sub-chunk into idx. Returns the in-ball count m. Readers need a
// barrier after it.
__device__ __forceinline__ int wide_compact(const float *rows,
                                            const float *c, int dim,
                                            unsigned in_mask,
                                            const int *gcnt, bool one,
                                            float *ws,
                                            unsigned short *idx) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  int m = 0;
  for (int g = 0; g < WIDE_GROUPS; ++g) m += gcnt[g];
  for (int i = 0, w = threadIdx.x; w < SUB; ++i, w += blockDim.x) {
    const bool in = (in_mask >> i) & 1u;
    const unsigned bal = __ballot_sync(FULL, in);
    if (!in) continue;
    int pos = __popc(bal & below);
    for (int g = 0; g < (w >> 5); ++g) pos += gcnt[g];
    if (one) {
      const float *y = rows + (size_t)w * dim;
      for (int d = 0; d < dim; ++d) ws[d * SUB + pos] = __fsub_rn(y[d], c[d]);
    } else {
      idx[pos] = static_cast<unsigned short>(w);
    }
  }
  if (one)
    for (int p = m + threadIdx.x; p < wide_padded(m); p += blockDim.x)
      for (int d = 0; d < dim; ++d) ws[d * SUB + p] = MASK;
  return m;
}

// Copy kd coordinate rows of rt samples (16-byte aligned, contiguous at
// src) into xs, WIDE_XS floats a row.
__device__ __forceinline__ void wide_stage_samples(float *xs,
                                                   const float *src, int kd,
                                                   int rt) {
  const float4 *s4 = reinterpret_cast<const float4 *>(src);
  float4 *d4 = reinterpret_cast<float4 *>(xs);
  const int q = rt / 4;  // float4 a row
  for (int i = threadIdx.x; i < kd * q; i += blockDim.x)
    d4[i / q * (WIDE_XS / 4) + i % q] = __ldg(s4 + i);
}

// Past one slab: coordinates [k0, k0 + kd) of the tile's samples into xs
// (kd, WIDE_XS), and of the unit's in-ball witnesses [w0, w0 + WIDE_STEP),
// ball-local, into ws (kd, WIDE_STEP), masked from slot m on.
__device__ __forceinline__ void wide_stage_slab(
    float *xs, float *ws, const float *xt, const float *witnesses, int sub,
    const unsigned short *idx, const float *c, int rt, int dim, int m,
    int w0, int k0, int kd) {
  wide_stage_samples(xs, xt + (size_t)k0 * rt, kd, rt);
  for (int i = threadIdx.x; i < WIDE_STEP * kd; i += blockDim.x) {
    const int w = i / kd, d = i - w * kd;
    ws[d * WIDE_STEP + w] =
        w0 + w < m
            ? __fsub_rn(witnesses[((size_t)sub * SUB + idx[w0 + w]) * dim +
                                  k0 + d],
                        c[k0 + d])
            : MASK;
  }
}

// Eight values of a coordinate row: p[0..3] and p[gap..gap + 3].
__device__ __forceinline__ void wide_load8(const float *p, int gap,
                                           float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4 *>(p);
  const float4 b = *reinterpret_cast<const float4 *>(p + gap);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// The register tile's first coordinate: a[k][i] = t * t, t = y_i - x_k
// (fma(t, t, 0) rounds alike). x and y point at this thread's samples and
// witnesses in that coordinate's row.
__device__ __forceinline__ void wide_first(float (&a)[WIDE_TM][WIDE_TN],
                                           const float *x, const float *y) {
  float xv[WIDE_TM], yv[WIDE_TN];
  wide_load8(x, 32, xv);
  wide_load8(y, 16, yv);
#pragma unroll
  for (int k = 0; k < WIDE_TM; ++k)
#pragma unroll
    for (int i = 0; i < WIDE_TN; ++i) {
      const float t = __fsub_rn(yv[i], xv[k]);
      a[k][i] = __fmul_rn(t, t);
    }
}

// The pair loop: a[k][i] = fma(t, t, a[k][i]) over n more coordinate rows,
// XS floats apart for the samples and YS for the witnesses.
template <int YS, int XS = WIDE_XS>
__device__ __forceinline__ void wide_accumulate(
    float (&a)[WIDE_TM][WIDE_TN], const float *x, const float *y, int n) {
#pragma unroll 2
  for (const float *end = x + n * XS; x != end; x += XS, y += YS) {
    float xv[WIDE_TM], yv[WIDE_TN];
    wide_load8(x, 32, xv);
    wide_load8(y, 16, yv);
#pragma unroll
    for (int k = 0; k < WIDE_TM; ++k)
#pragma unroll
      for (int i = 0; i < WIDE_TN; ++i) {
        const float t = __fsub_rn(yv[i], xv[k]);
        a[k][i] = __fmaf_rn(t, t, a[k][i]);
      }
  }
}

// mn[k] = min(mn[k], a[k][i]) over the register tile's witness columns i.
__device__ __forceinline__ void wide_fold(float (&mn)[WIDE_TM],
                                          const float (&a)[WIDE_TM][WIDE_TN]) {
#pragma unroll
  for (int k = 0; k < WIDE_TM; ++k)
#pragma unroll
    for (int i = 0; i < WIDE_TN; ++i) mn[k] = fminf(mn[k], a[k][i]);
}

// mn[k] = min(mn[k], d2 from this thread's sample k to its witness columns
// of a staged unit of m in-ball witnesses). One slab: xs and ws hold the
// samples and the unit. Past it: each 32-witness step stages the slabs of
// both operands in turn, from xt (the tile's samples, (dim, rt)) and the
// in-ball positions idx; every thread of the CTA must call it.
__device__ __forceinline__ void wide_min_over_unit(
    float (&mn)[WIDE_TM], float *xs, float *ws, const unsigned short *idx,
    const float *xt, const float *witnesses, int sub, const float *c,
    int rt, int dim, int m, bool one, int xo, int wo) {
  for (int w0 = 0; w0 < wide_padded(m); w0 += WIDE_STEP) {
    float a[WIDE_TM][WIDE_TN];
    for (int k0 = 0; k0 < dim; k0 += WIDE_KS) {
      const float *x = xs + xo;
      if (one) {
        const float *y = ws + w0 + wo;
        wide_first(a, x, y);
        wide_accumulate<SUB>(a, x + WIDE_XS, y + SUB, dim - 1);
        continue;  // one slab: k0 + WIDE_KS passes dim
      }
      const int kd = min(WIDE_KS, dim - k0);
      __syncthreads();  // readers of the last slabs are done
      wide_stage_slab(xs, ws, xt, witnesses, sub, idx, c, rt, dim, m, w0, k0,
                      kd);
      __syncthreads();
      const float *y = ws + wo;
      if (k0 == 0) {
        wide_first(a, x, y);
        wide_accumulate<WIDE_STEP>(a, x + WIDE_XS, y + WIDE_STEP, kd - 1);
      } else {
        wide_accumulate<WIDE_STEP>(a, x, y, kd);
      }
    }
    wide_fold(mn, a);
  }
}

// The min over the WIDE_WL lanes that share samples: afterwards each of
// them holds its samples' exact running mins.
__device__ __forceinline__ void wide_lane_min(float (&mn)[WIDE_TM]) {
#pragma unroll
  for (int k = 0; k < WIDE_TM; ++k)
    for (int off = 1; off < WIDE_WL; off <<= 1)
      mn[k] = fminf(mn[k], __shfl_xor_sync(FULL, mn[k], off));
}

// The warp's max of its samples' running mins (after wide_lane_min).
__device__ __forceinline__ float wide_warp_max(const float (&mn)[WIDE_TM]) {
  float wm = mn[0];
#pragma unroll
  for (int k = 1; k < WIDE_TM; ++k) wm = fmaxf(wm, mn[k]);
  for (int off = 16; off > 0; off >>= 1)
    wm = fmaxf(wm, __shfl_xor_sync(FULL, wm, off));
  return wm;
}

}  // namespace flood
