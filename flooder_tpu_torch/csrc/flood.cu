// Flood min-distances on Hopper (kernel K1 of the port).
//
// Replaces the Pallas TPU kernel flooder_tpu/ops/pallas_flood.py:333
// (`_flood_kernel`, launched by `_flood_pairs_call` at :503). For every
// sample point of every simplex it computes the squared distance to the
// nearest witness inside the simplex's bounding ball, over a work-list of
// (block of BS simplices, chunk of kd-ordered witnesses) pairs, each chunk
// taken as SUB-witness sub-chunks.
//
// Structure at 1-8 coordinates (flood_min_few<DIM>): the caller tiles
// every pass in tiles of FEW_RT = 128 samples, and each warp owns one
// (simplex, tile): its tile's running mins stay in registers (SPT samples a
// lane), it walks the block's chunk list nearest-first (a per-block CSR
// built by the caller) and writes its output once. FEW_WARPS independent
// warps a CTA and no CTA barrier, so the BS simplices of a block run at
// once and an SM holds as many warps as its registers allow. Nothing is
// carried between warps but their counts (atomics on the zeroed stats), so
// there is no aliased accumulator and no launch segment (the TPU's
// sequential grid needed both). Warps take the blocks longest work-list
// first (`cta_order`, from the caller), so the longest blocks do not land
// in the last wave. A tile is one of three things: random mode's samples,
// a coarse grid's (up to 384 samples a simplex, one to three tiles), or
// past 384 samples a simplex a 128-sample patch of the grid's sample rows
// in curve order, so a tight piece of the simplex.
//
// Two skips, uniform over the warp:
//  1. ball test: the sub-chunk's box must meet the simplex's ball (exact:
//     the plain version's arithmetic, so both decide alike);
//  2. tile test: the squared gap between the sub-chunk's box and the
//     tile's sample box must not exceed min(pm, ub2), where pm is the
//     tile's current max running min and ub2 the static nearest-vertex
//     bound (+inf unless the landmarks lie in the cloud). The finer the
//     tile, the tighter its box, pm and ub2: a sub-chunk is admitted one
//     128-sample patch at a time, which leaves out about half of the
//     in-ball pairs that tiles of 512 samples admitted on a 10M-point
//     cheese at 30 points per edge, with the same face maxima (PERF.md). It
//     is lossless up to about an ulp of d2: rounding is monotone, so the gap
//     bounds every separately rounded pair distance in the box, but the
//     per-pair FMA (flood_common.cuh) can round a pair an ulp below it. pm
//     comes from FMA-rounded mins and may differ from the plain version's by
//     an ulp, so a gap within an ulp of pm can be admitted on one side and
//     skipped on the other; on every input checked (chip_smoke.py,
//     tests/test_torch_cuda.py) the admitted units are the plain version's.
// The seed pass: each (simplex, tile) walks its block's list twice, both
// times nearest first by the block's centres. The first pass admits the
// sub-chunks that pass the ball test and whose box meets the tile's (gap
// 0), so pm falls to the witnesses on the tile before the rest of the list
// is tested; the second admits those at a gap above 0 within min(pm,
// ub2). A walk in one pass admits every gap-0 sub-chunk too, and where the
// second pass reaches a sub-chunk it has seen a superset of what that walk
// had, so its pm is no larger: the two passes admit a subset of the one
// pass's units, with the same minima. On a 10M-point cheese, grid and
// random passes alike, it computes 0.43-0.48 of the one pass's in-ball
// pairs, and K1's time falls with them (an H100; PERF.md). Each pass folds
// its gap condition into the walk's ballot (pass_holds), so `todo` and the
// one-ahead prefetch hold only the pass's candidates; a tile whose box
// meets no sub-chunk walks as in one pass, at the cost of one more scan of
// the list's boxes. A unit's pass is its gap: 0 in the seed pass alone,
// and stats' third column counts its pairs.
//
// What bounds it: fp32 instruction issue in the inner loop. Each (sample,
// witness) pair costs 7 instructions (3 sub, 1 mul, 2 FMA, 1 min; see
// flood_common.cuh), with one shared-memory broadcast per witness for SPT
// samples; bytes are far below (inputs are read once per admitted unit,
// mostly from L2). What the design does about it:
//  - The walk tests 32 list positions at once, a lane each (ball and
//    tile-box tests as in the plain version), so the tests are not a serial
//    chain ahead of the pair loop.
//  - Compaction: an admitted sub-chunk is staged a 128-witness segment at a
//    time into the warp's own shared memory (4 witnesses a lane, cp.async),
//    its in-ball witnesses at the front (ballot + popc), and the inner loop
//    runs over the in-ball count rounded up to the unroll, not over all 128.
//    The padding slots hold out-of-ball witnesses (at 3e18), and a unit with
//    no in-ball witness folds in the one value such a witness gives: min is
//    exact, so the output is the min over all SUB witnesses bit for bit. The
//    compaction and the inner loop are K3's too (flood_common.cuh).
//  - No barrier but __syncwarp: the next segment, or the next ball
//    candidate's first, is fetched while a segment computes.
//
// Arithmetic: the difference form in fp32 (flood_common.cuh; no tensor
// cores: the |x|^2 - 2x.y + |y|^2 form breaks the oracle tolerance,
// pallas_flood.py:51-56); the ball, box and tile tests explicitly rounded
// as in the plain version. DIM * (3e18)^2, at most 7.2e37 at DIM 8, stays
// finite in fp32 (flood_common.cuh), and outputs >= 1e30 mean "no witness
// in the ball". The caller gets per-tile counts, from which the bound is
// computed: admitted units, in-ball pairs, and the seed pass's in-ball
// pairs.
//
// Template instances for 1-8 coordinates. At 5-8 a staged witness is two
// float4 (the pair loop reads it with two LDS.128). Tiles of 256-512
// samples at 1-8 coordinates are refused: no caller makes them, since a
// tile of 512 admits a sub-chunk for all its samples at once, and on a
// 10M-point cheese's grid pass it computed about twice the pairs of the
// patches at about the same cost a pair (an H100; PERF.md).
//
// Few samples past 8 coordinates: flood_min_few_wide (9-16 coordinates) and
// flood_min_few_slabs (17 and more, no width cap), the two forms of one body
// (few_wide_item) behind the same launch. Before them flood_min_wide took
// these tiles: on a 128-sample tile it is a CTA of 2 warps walking its
// block's 8 simplices in turn, with shared memory sized for 512 samples and
// 512-witness units (3 CTAs, 6 warps an SM at 10 coordinates, derived from
// ptxas) and three CTA barriers a unit. Here each (simplex, tile) is a warp,
// FEW_WIDE_WARPS independent warps a CTA with no CTA barrier, and a warp's
// shared memory is sized to its item (at most 14,336 bytes, at 16
// coordinates: 16 warps an SM up to 16 coordinates, where the 128-register
// cap binds). Its 128 samples are two register tiles of flood_min_wide's
// shape (8 samples x 8 witnesses a lane, 64 x 32 a warp), computed one after
// the other against each staged step of 32 witnesses, so the pair loop is the
// same FADD + FFMA a pair and coordinate (wide_first, wide_accumulate). Up to
// 16 coordinates the tile's samples are staged once; a unit is staged a
// 32-witness segment at a time (a lane each, coordinate-major, 4-byte
// cp.async), ball-tested and compacted by ballot into a ring of 64 slots, and
// a step computes whenever 32 compacted witnesses are in the ring; the next
// segment, or the next ball candidate's first, is fetched while a step
// computes; the unit's last, partial step is padded with masked witnesses, as
// flood_min_wide pads to wide_padded(m). Past 16 coordinates both operands go
// through shared memory in 16-coordinate slabs, each step and half in turn,
// from the unit's in-ball positions (no prefetch); the two forms are two
// kernels so that the slab form's state does not make the one-slab form
// spill. Each (simplex, tile) keeps its walk, tests and running max, and
// every pair's d2 is the same FMA chain in coordinate order, so the output
// equals flood_min_wide's at rt 128 bit for bit (a masked slot computed more
// or fewer times does not change a min); counts reach each (block, tile) row
// by atomics on the zeroed stats.
//
// 9 and more coordinates: one runtime-width instance, flood_min_wide (the
// forms in flood_common.cuh), for tiles of 256-512 samples (and of 128, where
// a check holds the few-sample instances to it): one CTA of rt / 2 threads a
// (block, tile), which takes the block's simplices in turn; the same launch
// order, work-list walk and tests, on a coordinate-major copy of the samples.
// What bounds it is the same fp32 issue, 2 * dim + 1 instructions an in-ball
// pair (a sub and an FMA a coordinate, one min). What the design does about
// it: the pair loop is a register tile of 8 samples x 8 witnesses a thread,
// both read from shared memory with LDS.128 (4 loads for 64 pairs a
// coordinate), so the loop issues little besides its FADD and FFMA; a unit's
// witnesses are compacted to the in-ball ones (ballot, popc, one prefix over
// the sub-chunk, no shared atomics) and computed 32 at a time; the walk tests
// 32 list positions at once, a lane each (its ball and box tests are latency
// chains over the coordinates); up to 16 coordinates the tile's samples are
// staged once a simplex and the next ball candidate's rows are fetched with
// cp.async while a unit computes (three barriers a unit); past 16 both
// operands go in 16-coordinate slabs. Its d2 differs from the plain version's
// by the rounding of two summation orders (at most 2 * dim * 2^-24 * d2); the
// ball, box and tile tests are the plain version's arithmetic.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flood_common.cuh"

namespace {

using flood::NSEG;
using flood::SUB;

constexpr int MAX_RT = 512;  // samples per tile, at most
constexpr int SPT = 4;       // samples per thread

// Whether a sub-chunk that passed the ball test, at squared gap g2 to the
// tile's box, is admitted by the walk's pass: a gap of 0 by the seed pass,
// a gap above 0 within min(pm, ub2) (skip 2) by the second. Between the
// ballot and its turn pm may fall, so a candidate is tested again then.
__device__ __forceinline__ bool pass_holds(float g2, bool seed, float pm,
                                           float ub) {
  return (g2 == 0.f) == seed && g2 <= fminf(pm, ub);
}

// Few samples a simplex: tiles of FEW_RT samples, one warp a (simplex,
// tile), FEW_WARPS independent warps a CTA (see the note at the top).
constexpr int FEW_RT = 32 * SPT;
constexpr int FEW_WARPS = 2;

template <int DIM>
__global__ void __launch_bounds__(32 * FEW_WARPS) flood_min_few(
    const float *__restrict__ samples,    // (S, NR, FEW_RT, DIM) ball-local
    const float *__restrict__ witnesses,  // (W, DIM) kd-ordered, 16B-aligned
    const float *__restrict__ sub_lo,     // (W / SUB, DIM) sub-chunk boxes
    const float *__restrict__ sub_hi,
    const float *__restrict__ centers,  // (S, DIM)
    const float *__restrict__ radii,    // (S,)
    const float *__restrict__ tile_lo,  // (S, NR, DIM) ball-local
    const float *__restrict__ tile_hi,
    const float *__restrict__ ub2,        // (S, NR)
    const int *__restrict__ blk_ptr,      // (n_blk + 1,) CSR offsets
    const int *__restrict__ blk_chunks,   // chunk ids, nearest first
    const int *__restrict__ cta_order,    // (n_blk,) blocks in launch order
    float *__restrict__ out,              // (S, NR, FEW_RT) min d^2
    unsigned long long *__restrict__ stats,  // (n_blk * NR, 3), zeroed
    int n_items, int nr, int bs, int spc) {
  // each warp's own raw segment (cp.async target, read back only by the
  // lane that fetched it) and its compacted segment
  using namespace flood;
  __shared__ __align__(16) float raw_all[FEW_WARPS][SEGW * DIM];
  __shared__ Staged<DIM> wsh_all[FEW_WARPS][SEGW];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // work items in launch order: blocks as cta_order lists them, then the
  // block's simplices, then their tiles
  const int item = blockIdx.x * FEW_WARPS + warp;
  if (item >= n_items) return;
  const int per_blk = bs * nr;
  const int b = cta_order[item / per_blk];
  const int si = item % per_blk / nr, r = item % nr;
  float *raw = raw_all[warp];
  Staged<DIM> *wsh = wsh_all[warp];

  const int s = b * bs + si;
  const size_t tile = (size_t)s * nr + r;
  float c[DIM], tlo[DIM], thi[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    c[d] = centers[(size_t)s * DIM + d];
    tlo[d] = tile_lo[tile * DIM + d];
    thi[d] = tile_hi[tile * DIM + d];
  }
  const float rad = radii[s];
  const float r2 = __fmul_rn(rad, rad);
  const float ub = ub2[tile];
  float x[SPT][DIM], acc[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      x[k][d] = samples[(tile * FEW_RT + lane + 32 * k) * DIM + d];
    acc[k] = CUDART_INF_F;
  }

  // The walk, in two passes over the list (the seed pass, then the rest),
  // 32 list positions at a time: lane l takes position base + l (sub-chunk
  // n % spc of the list's chunk n / spc) and votes for it where it passes
  // the ball (skip 1) and its gap to the tile's box belongs to the pass
  // (see the note at the top). `todo` holds the lanes that voted and are
  // ahead.
  const int c0 = blk_ptr[b];
  const int npos = (blk_ptr[b + 1] - c0) * spc;
  int base = -32, lsub = 0;
  float lgap = 0.f;
  unsigned todo = 0;
  bool seed = true;         // the walk is in its seed pass
  float pm = CUDART_INF_F;  // the tile's max of its running mins
  auto next_ball = [&](float &g2) -> int {
    while (todo == 0) {
      base += 32;
      if (base >= npos) {
        if (!seed) return -1;
        seed = false;
        base = -32;
        continue;
      }
      const int n = base + lane;
      bool vote = false;
      if (n < npos) {
        lsub = blk_chunks[c0 + n / spc] * spc + n % spc;
        if (near2<DIM>(sub_lo, sub_hi, lsub, c) <= r2) {  // skip 1
          lgap = gap2<DIM>(sub_lo, sub_hi, lsub, c, tlo, thi);
          vote = pass_holds(lgap, seed, pm, ub);
        }
      }
      todo = __ballot_sync(FULL, vote);
    }
    const int l = __ffs(todo) - 1;
    todo &= todo - 1;
    g2 = __shfl_sync(FULL, lgap, l);
    return __shfl_sync(FULL, lsub, l);
  };

  unsigned long long units = 0, inball = 0, seeded = 0;
  float cgap = 0.f;         // cand's gap to the tile's box
  bool fetched = false;     // cand's first segment is on its way into raw
  int cand = next_ball(cgap);
  while (cand >= 0) {
    if (!(cgap <= fminf(pm, ub))) {  // skip 2
      cand = next_ball(cgap);
      fetched = false;
      continue;
    }
    // an admitted unit, a segment at a time; each segment's successor (the
    // next segment, or the next ball candidate's first) is fetched while it
    // computes
    if (!fetched) fetch_segment<DIM>(raw, witnesses, cand, 0, lane);
    int total = 0, nxt = -1;
    float ngap = 0.f;
    for (int seg = 0; seg < NSEG; ++seg) {
      const int n = stage_segment<DIM>(raw, c, r2, wsh, lane);
      if (seg + 1 < NSEG)
        fetch_segment<DIM>(raw, witnesses, cand, seg + 1, lane);
      else if ((nxt = next_ball(ngap)) >= 0)
        fetch_segment<DIM>(raw, witnesses, nxt, 0, lane);
      __syncwarp();  // the compacted segment published
      min_over_segment<DIM, SPT>(wsh, n, x, acc);
      __syncwarp();  // its readers are done
      total += n;
    }
    if (total == 0) fold_masked<DIM, SPT>(x, acc);
    units += 1;
    inball += total;
    if (cgap == 0.f) seeded += total;  // a unit of the seed pass
    pm = acc[0];
#pragma unroll
    for (int k = 1; k < SPT; ++k) pm = fmaxf(pm, acc[k]);
    for (int off = 16; off > 0; off >>= 1)
      pm = fmaxf(pm, __shfl_xor_sync(FULL, pm, off));
    cand = nxt;
    cgap = ngap;
    fetched = true;
  }
  cp_async_wait_all();  // a rejected candidate's segment may be in flight
#pragma unroll
  for (int k = 0; k < SPT; ++k) out[tile * FEW_RT + lane + 32 * k] = acc[k];
  if (lane == 0) {
    const size_t row = (size_t)b * nr + r;
    atomicAdd(stats + 3 * row, units);
    atomicAdd(stats + 3 * row + 1, inball * FEW_RT);
    atomicAdd(stats + 3 * row + 2, seeded * FEW_RT);
  }
}

template <int DIM>
cudaError_t launch_few(const float *samples, const float *witnesses,
                       const float *sub_lo, const float *sub_hi,
                       const float *centers, const float *radii,
                       const float *tile_lo, const float *tile_hi,
                       const float *ub2, const int *blk_ptr,
                       const int *blk_chunks, const int *cta_order, float *out,
                       long long *stats, int n_blk, int nr, int bs, int spc,
                       cudaStream_t stream, long long *launched) {
  const long long items = (long long)n_blk * bs * nr;
  if (items == 0) return cudaSuccess;
  cudaError_t e = cudaMemsetAsync(
      stats, 0, 3 * sizeof(long long) * (size_t)n_blk * nr, stream);
  if (e != cudaSuccess) return e;
  const long long ctas = (items + FEW_WARPS - 1) / FEW_WARPS;
  flood_min_few<DIM><<<(unsigned)ctas, 32 * FEW_WARPS, 0, stream>>>(
      samples, witnesses, sub_lo, sub_hi, centers, radii, tile_lo, tile_hi,
      ub2, blk_ptr, blk_chunks, cta_order, out,
      reinterpret_cast<unsigned long long *>(stats), (int)items, nr, bs,
      spc);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

// The runtime-width instance (9 and more coordinates): see the note at the
// top and flood_common.cuh.
constexpr int WIDE_THREADS = MAX_RT / 2;

__global__ void __launch_bounds__(WIDE_THREADS, 2) flood_min_wide(
    const float *__restrict__ samples_t,  // (S, NR, dim, RT) ball-local
    const float *__restrict__ witnesses,  // (W, dim) kd-ordered
    const float *__restrict__ sub_lo,     // (W / SUB, dim) sub-chunk boxes
    const float *__restrict__ sub_hi,
    const float *__restrict__ centers,  // (S, dim)
    const float *__restrict__ radii,    // (S,)
    const float *__restrict__ tile_lo,  // (S, NR, dim) ball-local
    const float *__restrict__ tile_hi,
    const float *__restrict__ ub2,        // (S, NR)
    const int *__restrict__ blk_ptr,      // (n_blk + 1,) CSR offsets
    const int *__restrict__ blk_chunks,   // chunk ids, nearest first
    const int *__restrict__ cta_order,    // (n_blk,) block of each CTA row
    float *__restrict__ out,              // (S, NR, RT) min d^2
    long long *__restrict__ stats,        // (n_blk * NR, 3)
    int nr, int rt, int bs, int spc, int dim) {
  // xs: the tile's samples (or a slab of them); ws: the staged unit (or a
  // slab of a step); then raw, the next candidate's rows (one slab), or
  // idx, the unit's in-ball positions (past one slab)
  using namespace flood;
  extern __shared__ __align__(16) float dyn[];
  const bool one = dim <= WIDE_KS;
  float *xs = dyn;
  float *ws = xs + (one ? dim : WIDE_KS) * WIDE_XS;
  float *raw = ws + (one ? dim * SUB : WIDE_KS * WIDE_STEP);
  unsigned short *idx = reinterpret_cast<unsigned short *>(raw);
  __shared__ int gcnt[WIDE_GROUPS];
  __shared__ float wmax[WIDE_MAX_WARPS];

  const int b = cta_order[blockIdx.x / nr];
  const int r = blockIdx.x - (blockIdx.x / nr) * nr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int xo = warp * WIDE_WARP_SAMPLES + 4 * (lane / WIDE_WL);
  const int wo = 4 * (lane % WIDE_WL);
  const int c0 = blk_ptr[b], c1 = blk_ptr[b + 1];
  long long units = 0, inball = 0, seeded = 0;

  for (int si = 0; si < bs; ++si) {
    const int s = b * bs + si;
    const size_t tile = (size_t)s * nr + r;
    const float *c = centers + (size_t)s * dim;
    const float *tlo = tile_lo + tile * dim, *thi = tile_hi + tile * dim;
    const float rad = radii[s];
    const float r2 = __fmul_rn(rad, rad);
    const float ub = ub2[tile];
    const float *xt = samples_t + tile * dim * rt;
    __syncthreads();  // the last simplex's readers of xs are done
    if (one) wide_stage_samples(xs, xt, dim, rt);
    __syncthreads();
    float mn[WIDE_TM];
#pragma unroll
    for (int k = 0; k < WIDE_TM; ++k) mn[k] = CUDART_INF_F;
    float pm = CUDART_INF_F;  // the tile's max of its running mins

    // The walk, in two passes over the list (the seed pass, then the
    // rest), 32 list positions at a time: lane l of every warp takes
    // position base + l (sub-chunk n % spc of the list's chunk n / spc) and
    // votes for it where it passes the ball (skip 1) and its gap to the
    // tile's box belongs to the pass, whose bound changes with every unit.
    // `todo` holds the lanes that voted and are still ahead.
    const int npos = (c1 - c0) * spc;
    int base = -32, lsub = 0;
    float lgap = 0.f;
    unsigned todo = 0;
    bool seed = true;  // the walk is in its seed pass
    auto next_ball = [&](float &g2) -> int {
      while (todo == 0) {
        base += 32;
        if (base >= npos) {
          if (!seed) return -1;
          seed = false;
          base = -32;
          continue;
        }
        const int n = base + lane;
        bool vote = false;
        if (n < npos) {
          lsub = blk_chunks[c0 + n / spc] * spc + n % spc;
          if (near2_wide(sub_lo, sub_hi, lsub, c, dim) <= r2) {  // skip 1
            lgap = gap2_wide(sub_lo, sub_hi, lsub, c, tlo, thi, dim);
            vote = pass_holds(lgap, seed, pm, ub);
          }
        }
        todo = __ballot_sync(FULL, vote);
      }
      const int l = __ffs(todo) - 1;
      todo &= todo - 1;
      g2 = __shfl_sync(FULL, lgap, l);
      return __shfl_sync(FULL, lsub, l);
    };

    bool fetched = false;  // cand's rows are on their way into raw
    float cgap = 0.f;      // cand's gap to the tile's box
    int cand = next_ball(cgap);
    while (cand >= 0) {
      if (!(cgap <= fminf(pm, ub))) {  // skip 2
        cand = next_ball(cgap);
        fetched = false;
        continue;
      }
      const float *rows = witnesses + (size_t)cand * SUB * dim;
      if (one) {
        if (!fetched) wide_fetch_raw(raw, witnesses, cand, dim);
        cp_async_wait_all();
        rows = raw;
      }
      const unsigned in_mask = wide_ball_test(rows, c, r2, dim, gcnt);
      __syncthreads();  // gcnt published; the last unit's readers are done
      const int m = wide_compact(rows, c, dim, in_mask, gcnt, one, ws, idx);
      // fetch the next ball candidate while this unit computes
      float ngap;
      const int nxt = next_ball(ngap);
      if (one && nxt >= 0) wide_fetch_raw(raw, witnesses, nxt, dim);
      __syncthreads();  // the staged unit published
      wide_min_over_unit(mn, xs, ws, idx, xt, witnesses, cand, c, rt, dim, m,
                         one, xo, wo);
      units += 1;
      inball += m;
      if (cgap == 0.f) seeded += m;  // a unit of the seed pass
      wide_lane_min(mn);
      const float wm = wide_warp_max(mn);
      if (lane == 0) wmax[warp] = wm;
      __syncthreads();
      pm = wmax[0];
      for (int w = 1; w < nw; ++w) pm = fmaxf(pm, wmax[w]);
      cand = nxt;
      cgap = ngap;
      fetched = true;
    }
    if (lane % WIDE_WL == 0) {
      float *o = out + tile * rt + xo;
      *reinterpret_cast<float4 *>(o) = make_float4(mn[0], mn[1], mn[2], mn[3]);
      *reinterpret_cast<float4 *>(o + 32) =
          make_float4(mn[4], mn[5], mn[6], mn[7]);
    }
  }
  cp_async_wait_all();  // a rejected candidate's rows may be in flight
  if (tid == 0) {
    const size_t row = (size_t)b * nr + r;
    stats[3 * row] = units;
    stats[3 * row + 1] = inball * rt;
    stats[3 * row + 2] = seeded * rt;
  }
}

cudaError_t launch_wide(const float *samples_t, const float *witnesses,
                        const float *sub_lo, const float *sub_hi,
                        const float *centers, const float *radii,
                        const float *tile_lo, const float *tile_hi,
                        const float *ub2, const int *blk_ptr,
                        const int *blk_chunks, const int *cta_order,
                        float *out, long long *stats, int n_blk, int nr,
                        int rt, int bs, int spc, int dim,
                        cudaStream_t stream, long long *launched) {
  const long long ctas = (long long)n_blk * nr;
  if (ctas == 0) return cudaSuccess;
  const size_t smem = flood::wide_smem_bytes(dim, true);
  cudaError_t e = cudaFuncSetAttribute(
      flood_min_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flood_min_wide,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  flood_min_wide<<<(unsigned)ctas, rt / 2, smem, stream>>>(
      samples_t, witnesses, sub_lo, sub_hi, centers, radii, tile_lo, tile_hi,
      ub2, blk_ptr, blk_chunks, cta_order, out, stats, nr, rt, bs, spc, dim);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

// Few samples a simplex past 8 coordinates (flood_min_few_wide): a warp a
// (simplex, FEW_RT-sample tile), FEW_WIDE_WARPS independent warps a CTA;
// see the note at the top.
constexpr int FEW_WIDE_WARPS = 4;
constexpr int FEW_HALF = FEW_RT / 2;  // samples of one register tile's rows
constexpr int FEW_WIDE_SEG = 32;      // witnesses a staged segment (a lane)
constexpr int FEW_WIDE_NSEG = flood::SUB / FEW_WIDE_SEG;
constexpr int FEW_WIDE_RING = 2 * flood::WIDE_STEP;  // compacted slots
static_assert(FEW_HALF == flood::WIDE_WARP_SAMPLES, "a half is a tile's rows");

// Shared floats of one warp at `dim` coordinates. Up to WIDE_KS: the tile's
// samples (dim, FEW_RT), the ring of compacted ball-local witnesses (dim,
// FEW_WIDE_RING) and the raw segment (dim, FEW_WIDE_SEG), all
// coordinate-major. Past it: a slab of half the samples (WIDE_KS,
// FEW_HALF), a slab of a step's witnesses (WIDE_KS, WIDE_STEP) and the
// unit's in-ball positions (SUB shorts).
__host__ __device__ constexpr int few_wide_warp_floats(int dim) {
  return dim <= flood::WIDE_KS
             ? dim * (FEW_RT + FEW_WIDE_RING + FEW_WIDE_SEG)
             : flood::WIDE_KS * (FEW_HALF + flood::WIDE_STEP) +
                   flood::SUB / 2;
}

__host__ __device__ constexpr size_t few_wide_smem_bytes(int dim) {
  return (size_t)FEW_WIDE_WARPS * few_wide_warp_floats(dim) * sizeof(float);
}

// This lane's share of segment `seg` of sub-chunk `sub` (FEW_WIDE_SEG rows,
// contiguous in global memory) into raw, coordinate-major (dim,
// FEW_WIDE_SEG): elements lane + 32 j of the segment, j < dim, one 4-byte
// cp.async each, coalesced; element e is row e / dim, coordinate e % dim,
// kept as (w, d), which 32 elements on advance by (q, rr) = (32 / dim, 32 %
// dim). Each slot of raw is written by the same lane at every fetch.
__device__ __forceinline__ void few_wide_fetch(float *raw,
                                               const float *witnesses,
                                               int sub, int seg, int dim,
                                               int lane) {
  flood::cp_async_wait_all();  // no older copy may land after this one
  const float *src =
      witnesses + ((size_t)sub * flood::SUB + seg * FEW_WIDE_SEG) * dim + lane;
  const int q = 32 / dim, rr = 32 % dim;
  int w = lane / dim, d = lane % dim;
  for (int j = 0; j < dim; ++j, src += 32) {
    flood::cp_async4(raw + d * FEW_WIDE_SEG + w, src);
    w += q;
    d += rr;
    if (d >= dim) {
      d -= dim;
      ++w;
    }
  }
  flood::cp_async_commit();
}

// Past WIDE_KS: coordinates [k0, k0 + kd) of half the tile's samples (xh,
// rows FEW_RT floats apart) into xs (kd, FEW_HALF), and of the unit's
// in-ball witnesses [w0, w0 + WIDE_STEP) (a lane each, rows of the
// sub-chunk at `rows`, positions idx), ball-local, into ws (kd, WIDE_STEP),
// masked from slot m on.
__device__ __forceinline__ void few_wide_stage_slab(
    float *xs, float *ws, const float *xh, const float *rows,
    const unsigned short *idx, const float *c, int dim, int m, int w0, int k0,
    int kd, int lane) {
  using namespace flood;
  constexpr int Q = FEW_HALF / 4;  // float4 a row
  for (int i = lane; i < kd * Q; i += 32)
    reinterpret_cast<float4 *>(xs)[i] = __ldg(
        reinterpret_cast<const float4 *>(xh + (size_t)(i / Q) * FEW_RT) +
        i % Q);
  const bool real = w0 + lane < m;
  const float *y = rows + (size_t)(real ? idx[w0 + lane] : 0) * dim + k0;
  for (int d = 0; d < kd; ++d)
    ws[d * WIDE_STEP + lane] = real ? __fsub_rn(y[d], c[k0 + d]) : MASK;
}

// Into the running mins of half h of the tile (mn0 or mn1), the min d2 of
// this lane's own samples over a step's 32 witnesses: the register tile's
// row minima, reduced over the WIDE_WL lanes that share samples by halving
// exchanges, so that lane l keeps two of the group's 8 samples, k = 4 * b0
// + 2 * b1 + j with (b1, b0) the bits of l % 4 (few_wide_own gives their
// offsets).
__device__ __forceinline__ void few_wide_fold(
    float (&mn0)[2], float (&mn1)[2], int h,
    const float (&a)[flood::WIDE_TM][flood::WIDE_TN], int lane) {
  using namespace flood;
  float rm[WIDE_TM];
#pragma unroll
  for (int k = 0; k < WIDE_TM; ++k) {
    rm[k] = a[k][0];
#pragma unroll
    for (int i = 1; i < WIDE_TN; ++i) rm[k] = fminf(rm[k], a[k][i]);
  }
  const bool b0 = lane & 1, b1 = lane & 2;
  float r1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float keep = b0 ? rm[j + 4] : rm[j];
    const float send = b0 ? rm[j] : rm[j + 4];
    r1[j] = fminf(keep, __shfl_xor_sync(FULL, send, 1));
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float keep = b1 ? r1[j + 2] : r1[j];
    const float send = b1 ? r1[j] : r1[j + 2];
    const float v = fminf(keep, __shfl_xor_sync(FULL, send, 2));
    if (h == 0)
      mn0[j] = fminf(mn0[j], v);
    else
      mn1[j] = fminf(mn1[j], v);
  }
}

// The offset, within its half, of this lane's first own sample (the second
// follows it): samples xo + {0..3} are k 0-3, xo + {32..35} k 4-7.
__device__ __forceinline__ int few_wide_own(int lane) {
  return 4 * (lane / flood::WIDE_WL) + 32 * (lane & 1) + (lane & 2);
}

// The parameters of K1's few-sample instances past 8 coordinates, and the
// arguments that pass them on.
#define FEW_WIDE_PARAMS                                                     \
  const float *__restrict__ samples_t, /* (S, NR, dim, FEW_RT) */           \
      const float *__restrict__ witnesses, /* (W, dim), 16B-aligned */      \
      const float *__restrict__ sub_lo,    /* (W / SUB, dim) boxes */       \
      const float *__restrict__ sub_hi,                                     \
      const float *__restrict__ centers,   /* (S, dim) */                   \
      const float *__restrict__ radii,     /* (S,) */                       \
      const float *__restrict__ tile_lo,   /* (S, NR, dim) ball-local */    \
      const float *__restrict__ tile_hi,                                    \
      const float *__restrict__ ub2,       /* (S, NR) */                    \
      const int *__restrict__ blk_ptr,     /* (n_blk + 1,) CSR offsets */   \
      const int *__restrict__ blk_chunks,  /* chunk ids, nearest first */   \
      const int *__restrict__ cta_order,   /* (n_blk,) launch order */      \
      float *__restrict__ out,             /* (S, NR, FEW_RT) min d^2 */    \
      unsigned long long *__restrict__ stats, /* (n_blk * NR, 3), zeroed */ \
      int n_items, int nr, int bs, int spc, int dim
#define FEW_WIDE_ARGS                                                       \
  samples_t, witnesses, sub_lo, sub_hi, centers, radii, tile_lo, tile_hi,   \
      ub2, blk_ptr, blk_chunks, cta_order, out, stats, n_items, nr, bs, spc, \
      dim

// One warp's work item; SLABS: past WIDE_KS coordinates. The two forms are
// two kernels, so that each gets its own register allocation (in one kernel
// the slab form's live state made the one-slab form spill).
template <bool SLABS>
__device__ __forceinline__ void few_wide_item(FEW_WIDE_PARAMS) {
  using namespace flood;
  extern __shared__ __align__(16) float dyn[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // work items in launch order: blocks as cta_order lists them, then the
  // block's simplices, then their tiles
  const int item = blockIdx.x * FEW_WIDE_WARPS + warp;
  if (item >= n_items) return;
  const int per_blk = bs * nr;
  const int b = cta_order[item / per_blk];
  const int si = item % per_blk / nr, r = item % nr;
  const int s = b * bs + si;
  const size_t tile = (size_t)s * nr + r;
  const float *c = centers + (size_t)s * dim;
  const float *tlo = tile_lo + tile * dim, *thi = tile_hi + tile * dim;
  const float rad = radii[s];
  const float r2 = __fmul_rn(rad, rad);
  const float ub = ub2[tile];
  const float *xt = samples_t + tile * dim * FEW_RT;
  const unsigned below = (1u << lane) - 1u;
  // this warp's shared memory: one slab (xs, ring, raw) or slabs (xs, ws,
  // idx); see few_wide_warp_floats
  float *xs = dyn + (size_t)warp * few_wide_warp_floats(dim);
  float *ring = xs + dim * FEW_RT;
  float *raw = ring + dim * FEW_WIDE_RING;
  float *ws = xs + WIDE_KS * FEW_HALF;
  unsigned short *idx =
      reinterpret_cast<unsigned short *>(ws + WIDE_KS * WIDE_STEP);
  // lane l holds samples h * FEW_HALF + xo + {0..3, 32..35} of half h and
  // witness columns wo + {0..3, 16..19} of each step
  const int xo = 4 * (lane / WIDE_WL), wo = 4 * (lane % WIDE_WL);
  if constexpr (!SLABS) {  // the tile's samples, once
    for (int i = lane; i < dim * (FEW_RT / 4); i += 32)
      cp_async16(xs + 4 * i, xt + 4 * i);
    cp_async_commit();
  }
  // the running mins of this lane's own samples, two of each half
  // (few_wide_fold)
  float mn0[2] = {CUDART_INF_F, CUDART_INF_F};
  float mn1[2] = {CUDART_INF_F, CUDART_INF_F};

  // The walk, in two passes over the list (the seed pass, then the rest),
  // 32 list positions at a time: lane l takes position base + l (sub-chunk
  // n % spc of the list's chunk n / spc) and votes for it where it passes
  // the ball (skip 1) and its gap to the tile's box belongs to the pass.
  // `todo` holds the lanes that voted and are ahead.
  const int c0 = blk_ptr[b];
  const int npos = (blk_ptr[b + 1] - c0) * spc;
  int base = -32, lsub = 0;
  float lgap = 0.f;
  unsigned todo = 0;
  bool seed = true;         // the walk is in its seed pass
  float pm = CUDART_INF_F;  // the tile's max of its running mins
  auto next_ball = [&](float &g2) -> int {
    while (todo == 0) {
      base += 32;
      if (base >= npos) {
        if (!seed) return -1;
        seed = false;
        base = -32;
        continue;
      }
      const int n = base + lane;
      bool vote = false;
      if (n < npos) {
        lsub = blk_chunks[c0 + n / spc] * spc + n % spc;
        if (near2_wide(sub_lo, sub_hi, lsub, c, dim) <= r2) {  // skip 1
          lgap = gap2_wide(sub_lo, sub_hi, lsub, c, tlo, thi, dim);
          vote = pass_holds(lgap, seed, pm, ub);
        }
      }
      todo = __ballot_sync(FULL, vote);
    }
    const int l = __ffs(todo) - 1;
    todo &= todo - 1;
    g2 = __shfl_sync(FULL, lgap, l);
    return __shfl_sync(FULL, lsub, l);
  };
  // one step: the register tile of each half against 32 staged witnesses
  // (y: this lane's columns of the step's first coordinate row)
  auto ring_step = [&](const float *y) {
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      float a[WIDE_TM][WIDE_TN];
      const float *x = xs + h * FEW_HALF + xo;
      wide_first(a, x, y);
      wide_accumulate<FEW_WIDE_RING, FEW_RT>(a, x + FEW_RT,
                                             y + FEW_WIDE_RING, dim - 1);
      few_wide_fold(mn0, mn1, h, a, lane);
    }
  };

  // one item's: in-ball witnesses < 2^32
  unsigned units = 0, inball = 0, seeded = 0;
  float cgap = 0.f;         // cand's gap to the tile's box
  bool fetched = false;     // cand's first segment is on its way into raw
  int cand = next_ball(cgap);
  while (cand >= 0) {
    if (!(cgap <= fminf(pm, ub))) {  // skip 2
      cand = next_ball(cgap);
      fetched = false;
      continue;
    }
    // an admitted unit: m in-ball witnesses
    int m = 0, nxt = -1;
    float ngap = 0.f;
    if constexpr (!SLABS) {
      // a segment at a time: ball test and compaction (ballot) into the
      // ring, the next segment (or the next ball candidate's first) fetched
      // while a full step of 32 compacted witnesses computes
      if (!fetched) few_wide_fetch(raw, witnesses, cand, 0, dim, lane);
      int head = 0;  // the first compacted slot not computed yet
      for (int seg = 0; seg < FEW_WIDE_NSEG; ++seg) {
        cp_async_wait_all();
        __syncwarp();  // the segment (and the samples) published
        // this lane's witness, ball-local in place (its column of raw)
        float y2 = 0.f;
        for (int d = 0; d < dim; ++d) {
          float *y = raw + d * FEW_WIDE_SEG + lane;
          *y = __fsub_rn(*y, c[d]);
          y2 = sq_add(y2, *y);
        }
        const bool in = y2 <= r2;
        const unsigned bal = __ballot_sync(FULL, in);
        if (in) {
          float *dst = ring + ((m + __popc(bal & below)) & (FEW_WIDE_RING - 1));
          for (int d = 0; d < dim; ++d)
            dst[d * FEW_WIDE_RING] = raw[d * FEW_WIDE_SEG + lane];
        }
        m += __popc(bal);
        __syncwarp();  // raw read; the compacted slots published
        if (seg + 1 < FEW_WIDE_NSEG)
          few_wide_fetch(raw, witnesses, cand, seg + 1, dim, lane);
        else if ((nxt = next_ball(ngap)) >= 0)
          few_wide_fetch(raw, witnesses, nxt, 0, dim, lane);
        if (m - head >= WIDE_STEP) {
          ring_step(ring + (head & (FEW_WIDE_RING - 1)) + wo);
          head += WIDE_STEP;
        }
      }
      if (m > head || m == 0) {
        // the last, partial step: slots [m, head + WIDE_STEP) masked (a
        // whole step of them when no witness is in the ball)
        if (lane < head + WIDE_STEP - m) {
          float *dst = ring + ((m + lane) & (FEW_WIDE_RING - 1));
          for (int d = 0; d < dim; ++d) dst[d * FEW_WIDE_RING] = MASK;
        }
        __syncwarp();
        ring_step(ring + (head & (FEW_WIDE_RING - 1)) + wo);
      }
    } else {
      // past one slab: the unit's in-ball positions, then each step and
      // half in slabs of WIDE_KS coordinates, both operands staged
      const float *rows = witnesses + (size_t)cand * SUB * dim;
      for (int w = lane; w < SUB; w += 32) {
        const float *y = rows + (size_t)w * dim;
        float y2 = 0.f;
        for (int d = 0; d < dim; ++d) y2 = sq_add(y2, __fsub_rn(y[d], c[d]));
        const bool in = y2 <= r2;
        const unsigned bal = __ballot_sync(FULL, in);
        if (in) idx[m + __popc(bal & below)] = static_cast<unsigned short>(w);
        m += __popc(bal);
      }
      nxt = next_ball(ngap);
      for (int w0 = 0; w0 < wide_padded(m); w0 += WIDE_STEP) {
#pragma unroll 1
        for (int h = 0; h < 2; ++h) {
          float a[WIDE_TM][WIDE_TN];
          for (int k0 = 0; k0 < dim; k0 += WIDE_KS) {
            const int kd = min(WIDE_KS, dim - k0);
            __syncwarp();  // idx published; the last slabs' readers done
            few_wide_stage_slab(xs, ws, xt + (size_t)k0 * FEW_RT + h * FEW_HALF,
                                rows, idx, c, dim, m, w0, k0, kd, lane);
            __syncwarp();
            if (k0 == 0) {
              wide_first(a, xs + xo, ws + wo);
              wide_accumulate<WIDE_STEP, FEW_HALF>(
                  a, xs + xo + FEW_HALF, ws + wo + WIDE_STEP, kd - 1);
            } else {
              wide_accumulate<WIDE_STEP, FEW_HALF>(a, xs + xo, ws + wo, kd);
            }
          }
          few_wide_fold(mn0, mn1, h, a, lane);
        }
      }
    }
    units += 1;
    inball += m;
    if (cgap == 0.f) seeded += m;  // a unit of the seed pass
    pm = fmaxf(fmaxf(mn0[0], mn0[1]), fmaxf(mn1[0], mn1[1]));
    for (int off = 16; off > 0; off >>= 1)
      pm = fmaxf(pm, __shfl_xor_sync(FULL, pm, off));
    cand = nxt;
    cgap = ngap;
    fetched = true;
  }
  cp_async_wait_all();  // a rejected candidate's segment may be in flight
  float *o = out + tile * FEW_RT + few_wide_own(lane);
  *reinterpret_cast<float2 *>(o) = make_float2(mn0[0], mn0[1]);
  *reinterpret_cast<float2 *>(o + FEW_HALF) = make_float2(mn1[0], mn1[1]);
  if (lane == 0) {
    const size_t row = (size_t)b * nr + r;
    atomicAdd(stats + 3 * row, (unsigned long long)units);
    atomicAdd(stats + 3 * row + 1, (unsigned long long)inball * FEW_RT);
    atomicAdd(stats + 3 * row + 2, (unsigned long long)seeded * FEW_RT);
  }
}

// 9 to WIDE_KS coordinates, and past WIDE_KS.
__global__ void __launch_bounds__(32 * FEW_WIDE_WARPS, 4)
    flood_min_few_wide(FEW_WIDE_PARAMS) {
  few_wide_item<false>(FEW_WIDE_ARGS);
}
__global__ void __launch_bounds__(32 * FEW_WIDE_WARPS, 4)
    flood_min_few_slabs(FEW_WIDE_PARAMS) {
  few_wide_item<true>(FEW_WIDE_ARGS);
}
#undef FEW_WIDE_PARAMS
#undef FEW_WIDE_ARGS

cudaError_t launch_few_wide(const float *samples_t, const float *witnesses,
                            const float *sub_lo, const float *sub_hi,
                            const float *centers, const float *radii,
                            const float *tile_lo, const float *tile_hi,
                            const float *ub2, const int *blk_ptr,
                            const int *blk_chunks, const int *cta_order,
                            float *out, long long *stats, int n_blk, int nr,
                            int bs, int spc, int dim, cudaStream_t stream,
                            long long *launched) {
  const long long items = (long long)n_blk * bs * nr;
  if (items == 0) return cudaSuccess;
  cudaError_t e = cudaMemsetAsync(
      stats, 0, 3 * sizeof(long long) * (size_t)n_blk * nr, stream);
  const size_t smem = few_wide_smem_bytes(dim);
  const auto kernel =
      dim <= flood::WIDE_KS ? flood_min_few_wide : flood_min_few_slabs;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const long long ctas = (items + FEW_WIDE_WARPS - 1) / FEW_WIDE_WARPS;
  kernel<<<(unsigned)ctas, 32 * FEW_WIDE_WARPS, smem, stream>>>(
      samples_t, witnesses, sub_lo, sub_hi, centers, radii, tile_lo, tile_hi,
      ub2, blk_ptr, blk_chunks, cta_order, out,
      reinterpret_cast<unsigned long long *>(stats), (int)items, nr, bs, spc,
      dim);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

}  // namespace

extern "C" {

const char *flooder_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int flood_sub() { return SUB; }

// Warps (work items) of a few-sample CTA: 1-8 coordinates, and past 8.
int flood_few_warps() { return FEW_WARPS; }
int flood_few_wide_warps() { return FEW_WIDE_WARPS; }

// Dynamic shared memory of flood_min_few_wide's CTA at `dim` coordinates.
long long flood_few_wide_smem_bytes(int dim) {
  return (long long)few_wide_smem_bytes(dim);
}

// Dynamic shared memory of flood_min_wide's CTA at `dim` coordinates (the
// launch asks for it).
long long flood_wide_smem_bytes(int dim) {
  return (long long)flood::wide_smem_bytes(dim, true);
}

// Launch K1's instance for tiles of up to 512 samples on `stream`: past 8
// coordinates alone (flood_min_wide); 1-8 coordinates are refused, since
// their tiles hold FEW_RT samples (flood_min_few_launch). `rt` must be a
// multiple of 128 and at most 512; `samples` coordinate-major, (S, NR,
// dim, RT) (its shared memory, flood_wide_smem_bytes, is at most 98,304
// bytes at 16 coordinates and 35,840 at any width past 16: no width cap);
// `cta_order` a permutation of the blocks (CTA row i runs block
// cta_order[i]); `stats` (n_blk * NR, 3), a row a (block, tile), written
// whole; `witnesses` 16-byte aligned. *launched is set to the
// number of kernel launches enqueued without error (0 when there is no
// CTA). Returns 0 or the CUDA launch error.
int flood_min_launch(const float *samples, const float *witnesses,
                     const float *sub_lo, const float *sub_hi,
                     const float *centers, const float *radii,
                     const float *tile_lo, const float *tile_hi,
                     const float *ub2, const int *blk_ptr,
                     const int *blk_chunks, const int *cta_order, float *out,
                     long long *stats, int n_blk, int nr, int rt, int dim,
                     int bs, int subs_per_chunk, void *stream,
                     long long *launched) {
  *launched = 0;
  if (dim <= flood::MAX_DIM || rt <= 0 || rt > MAX_RT || rt % 128 != 0 ||
      reinterpret_cast<uintptr_t>(witnesses) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_wide(
      samples, witnesses, sub_lo, sub_hi, centers, radii, tile_lo, tile_hi,
      ub2, blk_ptr, blk_chunks, cta_order, out, stats, n_blk, nr, rt, bs,
      subs_per_chunk, dim, static_cast<cudaStream_t>(stream), launched));
}

// Launch K1's few-sample instances on `stream`: as flood_min_launch, for
// tiles of FEW_RT samples (`rt` must be FEW_RT), one warp a (simplex,
// tile): flood_min_few<DIM> at 1-8 coordinates, flood_min_few_wide past 8
// (samples coordinate-major, as flood_min_wide reads them; its shared
// memory, flood_few_wide_smem_bytes, is at most 57,344 bytes, at 16
// coordinates, and 28,672 at any width past 16: no width cap). `stats`,
// (n_blk * nr, 3), is zeroed on the stream before the launch adds each
// tile's counts to its row.
int flood_min_few_launch(const float *samples, const float *witnesses,
                         const float *sub_lo, const float *sub_hi,
                         const float *centers, const float *radii,
                         const float *tile_lo, const float *tile_hi,
                         const float *ub2, const int *blk_ptr,
                         const int *blk_chunks, const int *cta_order,
                         float *out, long long *stats, int n_blk, int nr,
                         int rt, int dim, int bs, int subs_per_chunk,
                         void *stream, long long *launched) {
  *launched = 0;
  if (rt != FEW_RT || reinterpret_cast<uintptr_t>(witnesses) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLOOD_MIN_FEW_LAUNCH(D)                                              \
  launch_few<D>(samples, witnesses, sub_lo, sub_hi, centers, radii, tile_lo, \
                tile_hi, ub2, blk_ptr, blk_chunks, cta_order, out, stats,    \
                n_blk, nr, bs, subs_per_chunk, s, launched)
  cudaError_t e;
  switch (dim) {
    case 1: e = FLOOD_MIN_FEW_LAUNCH(1); break;
    case 2: e = FLOOD_MIN_FEW_LAUNCH(2); break;
    case 3: e = FLOOD_MIN_FEW_LAUNCH(3); break;
    case 4: e = FLOOD_MIN_FEW_LAUNCH(4); break;
    case 5: e = FLOOD_MIN_FEW_LAUNCH(5); break;
    case 6: e = FLOOD_MIN_FEW_LAUNCH(6); break;
    case 7: e = FLOOD_MIN_FEW_LAUNCH(7); break;
    case 8: e = FLOOD_MIN_FEW_LAUNCH(8); break;
    default:
      e = dim < 1 ? cudaErrorInvalidValue
                  : launch_few_wide(samples, witnesses, sub_lo, sub_hi,
                                    centers, radii, tile_lo, tile_hi, ub2,
                                    blk_ptr, blk_chunks, cta_order, out, stats,
                                    n_blk, nr, bs, subs_per_chunk, dim, s,
                                    launched);
  }
#undef FLOOD_MIN_FEW_LAUNCH
  return static_cast<int>(e);
}

}  // extern "C"
