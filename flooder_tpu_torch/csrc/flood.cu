// Flood min-distances on Hopper (kernel K1 of the port).
//
// Replaces the Pallas TPU kernel flooder_tpu/ops/pallas_flood.py:333
// (`_flood_kernel`, launched by `_flood_pairs_call` at :503). For every
// sample point of every simplex it computes the squared distance to the
// nearest witness inside the simplex's bounding ball, over a work-list of
// (block of BS simplices, chunk of kd-ordered witnesses) pairs, each chunk
// taken as SUB-witness sub-chunks.
//
// Structure: one CTA per (simplex block, sample tile). The CTA takes the
// block's simplices one after another; for each it keeps the running min
// of its tile's samples in registers (SPT samples per thread), walks the
// block's chunk list nearest-first (a per-block CSR built by the caller)
// and writes its output once. Nothing is carried between CTAs, so there
// are no atomics, no aliased accumulator and no launch segments (the TPU's
// sequential grid needed all three). CTAs are launched longest work-list
// first (`cta_order`, from the caller), so the longest blocks do not land
// in the last wave.
//
// Two skips, uniform over the CTA:
//  1. ball test: the sub-chunk's box must meet the simplex's ball (exact:
//     the plain version's arithmetic, so both decide alike);
//  2. tile test: the squared gap between the sub-chunk's box and the
//     tile's sample box must not exceed min(pm, ub2), where pm is the
//     tile's current max running min and ub2 the static nearest-vertex
//     bound (+inf unless the landmarks lie in the cloud). It is lossless
//     up to about an ulp of d2: rounding is monotone, so the gap bounds
//     every separately rounded pair distance in the box, but the per-pair
//     FMA (flood_common.cuh) can round a pair an ulp below it. pm comes
//     from FMA-rounded mins and may differ from the plain version's by an
//     ulp, so a gap within an ulp of pm can be admitted on one side and
//     skipped on the other; on every input checked (chip_smoke.py,
//     tests/test_torch_cuda.py) the admitted units are the plain version's.
//
// What bounds it: fp32 instruction issue in the inner loop. Each (sample,
// witness) pair costs 7 instructions (3 sub, 1 mul, 2 FMA, 1 min; see
// flood_common.cuh), with one shared-memory broadcast per witness for SPT
// samples; bytes are far below (inputs are read once per admitted unit,
// mostly from L2). What the design does about it:
//  - Compaction: a staged sub-chunk keeps its in-ball witnesses at the
//    front of each 128-witness segment (warp ballot + popc), and the inner
//    loop runs over the in-ball count rounded up to the unroll, not over
//    all 512. The padding slots hold out-of-ball witnesses (at 3e18), and a
//    unit with no in-ball witness folds in the one value such a witness
//    gives: min is exact, so the output is the min over all 512 bit for
//    bit. The fetch, the compaction and the inner loop are K3's too
//    (flood_common.cuh).
//  - One barrier per staging instead of seven: witnesses are staged into a
//    double-buffered tile; each thread fetches its own slots of the next
//    candidate sub-chunk with cp.async while the CTA computes, so raw data
//    needs no barrier; the tile test's block max is folded into the staging
//    barrier (each warp publishes its max of the running mins with the
//    staged tile). The tile test needs the max after the last computed
//    unit, so the first candidate after a computed unit is staged before
//    its test; a rejected one costs that staging and its barrier.
//
// Arithmetic: the difference form in fp32 (flood_common.cuh; no tensor
// cores: the |x|^2 - 2x.y + |y|^2 form breaks the oracle tolerance,
// pallas_flood.py:51-56); the ball, box and tile tests explicitly rounded
// as in the plain version. DIM * (3e18)^2, at most 7.2e37 at DIM 8, stays
// finite in fp32 (flood_common.cuh), and outputs >= 1e30 mean "no witness
// in the ball". The caller gets per-CTA counts of admitted units and of
// in-ball pairs, from which the bound is computed.
//
// Template instances for 1-8 coordinates. At 5-8 a staged witness is two
// float4 (the pair loop reads it with two LDS.128), and at 8 the raw fetch
// buffer moves to dynamic shared memory; the code for 1-4 is unchanged.
//
// Few samples a simplex (random mode, coarse grids): the caller's tiles
// hold FEW_RT = 128 samples up to 384 samples a simplex, and those tiles
// take flood_min_few<DIM> (flood_min_few_launch). Above, a CTA of rt / 4
// threads would be one to three warps that walk a block's 8 simplices one
// after another, with shared memory sized for 512 witnesses: few warps an
// SM, each a serial chain of list tests, fetches and barriers. Here each
// warp owns one (simplex, tile) and shares nothing: FEW_WARPS independent
// warps a CTA, no CTA barrier, so the 8 simplices of a block run at once
// and an SM holds as many warps as its registers allow. A warp tests 32
// list positions at once (a lane each, ball and tile-box tests as in the
// plain version), and stages an admitted sub-chunk a 128-witness segment at
// a time into its own shared memory (4 witnesses a lane, cp.async,
// compaction by ballot), fetching the next segment, or the next ball
// candidate's first, while it computes one. Each (simplex, tile) keeps its
// walk, tests, running max and pair arithmetic (flood_common.cuh), so the
// output equals flood_min_kernel's bit for bit and the counts are the
// plain version's; a warp adds its counts to its (block, tile) row with
// atomics on stats, which the launch zeroes first.
//
// 9 and more coordinates: one runtime-width instance, flood_min_wide (the
// forms in flood_common.cuh). The same grid, launch order, work-list walk
// and tests, on a coordinate-major copy of the samples, with rt / 2 threads
// a CTA. What bounds it is the same fp32 issue, 2 * dim + 1 instructions
// an in-ball pair (a sub and an FMA a coordinate, one min). What the design
// does about it: the pair loop is a register tile of 8 samples x 8
// witnesses a thread, both read from shared memory with LDS.128 (4 loads
// for 64 pairs a coordinate), so the loop issues little besides its FADD
// and FFMA; a unit's witnesses are compacted to the in-ball ones (ballot,
// popc, one prefix over the sub-chunk, no shared atomics) and computed 32
// at a time; the walk tests 32 list positions at once, a lane each (its
// ball and box tests are latency chains over the coordinates); up to 16
// coordinates the tile's samples are staged once a
// simplex and the next ball candidate's rows are fetched with cp.async
// while a unit computes (three barriers a unit); past 16 both operands go
// in 16-coordinate slabs. Its d2 differs from the plain version's by the
// rounding of two summation orders (at most 2 * dim * 2^-24 * d2); the
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
constexpr int MAX_WARPS = MAX_RT / SPT / 32;

template <int DIM>
__global__ void __launch_bounds__(MAX_RT / SPT) flood_min_kernel(
    const float *__restrict__ samples,    // (S, NR, RT, DIM) ball-local
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
    const int *__restrict__ cta_order,    // (n_blk,) block of each CTA row
    float *__restrict__ out,              // (S, NR, RT) min d^2
    long long *__restrict__ stats,        // (n_blk * NR, 2)
    int nr, int rt, int bs, int spc) {
  // raw: each lane's own slots of the next sub-chunk (cp.async target, read
  // back only by the lane that fetched them), in dynamic shared memory where
  // it would not fit beside wsh (raw_dynamic); wsh: the staged tile
  constexpr bool RAW_DYN = flood::raw_dynamic<DIM>();
  __shared__ __align__(16) float raw_static[RAW_DYN ? 4 : SUB * DIM];
  extern __shared__ __align__(16) float raw_dyn[];
  float *raw = RAW_DYN ? raw_dyn : raw_static;
  __shared__ flood::Staged<DIM> wsh[2][SUB];
  __shared__ int segcnt[2][NSEG];
  __shared__ float wmax[2][MAX_WARPS];

  const int b = cta_order[blockIdx.x / nr];
  const int r = blockIdx.x - (blockIdx.x / nr) * nr;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const int c0 = blk_ptr[b], c1 = blk_ptr[b + 1];
  long long units = 0, inball = 0;
  int wb = 0;  // the staging buffer no thread reads

  for (int si = 0; si < bs; ++si) {
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
      const int j = tid + k * T;
#pragma unroll
      for (int d = 0; d < DIM; ++d)
        x[k][d] = samples[(tile * rt + j) * DIM + d];
      acc[k] = CUDART_INF_F;
    }

    // the list cursor and the next sub-chunk that passes the ball test
    int p = c0, q = 0;
    auto next_ball = [&]() -> int {
      while (p < c1) {
        const int sub = blk_chunks[p] * spc + q;
        if (++q == spc) {
          q = 0;
          ++p;
        }
        if (flood::near2<DIM>(sub_lo, sub_hi, sub, c) <= r2)  // skip 1
          return sub;
      }
      return -1;
    };

    float pm = CUDART_INF_F;  // block max of acc, valid unless `dirty`
    float wm = CUDART_INF_F;  // this warp's max of acc
    bool dirty = false;       // acc changed since pm was taken
    bool fetched = false;     // cand's raw data is on its way
    int cand = next_ball();
    while (cand >= 0) {
      if (!dirty) {
        // pm is exact: test before staging
        if (!(flood::gap2<DIM>(sub_lo, sub_hi, cand, c, tlo, thi) <=
              fminf(pm, ub))) {
          cand = next_ball();
          fetched = false;
          continue;
        }
        if (!fetched)
          flood::fetch_raw<DIM>(raw, witnesses, cand, warp, nw, lane);
      }

      // stage cand into wsh[wb], compacted per segment
      flood::stage_compacted<DIM>(raw, c, r2, wsh[wb], segcnt[wb], warp, nw,
                                  lane);
      if (dirty && lane == 0) wmax[wb][warp] = wm;
      // fetch the next ball candidate while this one is tested and computed
      const int nxt = next_ball();
      if (nxt >= 0)
        flood::fetch_raw<DIM>(raw, witnesses, nxt, warp, nw, lane);
      __syncthreads();  // publishes wsh[wb], segcnt[wb] and wmax[wb]

      if (dirty) {
        pm = wmax[wb][0];
        for (int w = 1; w < nw; ++w) pm = fmaxf(pm, wmax[wb][w]);
        dirty = false;
      }
      if (flood::gap2<DIM>(sub_lo, sub_hi, cand, c, tlo, thi) <=
          fminf(pm, ub)) {
        // an admitted unit (skip 2 passed)
        const int total =
            flood::min_over_staged<DIM, SPT>(wsh[wb], segcnt[wb], x, acc);
        units += 1;
        inball += total;
        wm = acc[0];
#pragma unroll
        for (int k = 1; k < SPT; ++k) wm = fmaxf(wm, acc[k]);
        for (int off = 16; off > 0; off >>= 1)
          wm = fmaxf(wm, __shfl_xor_sync(flood::FULL, wm, off));
        dirty = true;
        wb ^= 1;
      }
      cand = nxt;
      fetched = true;
    }
#pragma unroll
    for (int k = 0; k < SPT; ++k) out[tile * rt + tid + k * T] = acc[k];
  }
  if (tid == 0) {
    const size_t row = (size_t)b * nr + r;
    stats[2 * row] = units;
    stats[2 * row + 1] = inball * rt;
  }
}

template <int DIM>
cudaError_t launch(const float *samples, const float *witnesses,
                   const float *sub_lo, const float *sub_hi,
                   const float *centers, const float *radii,
                   const float *tile_lo, const float *tile_hi,
                   const float *ub2, const int *blk_ptr,
                   const int *blk_chunks, const int *cta_order, float *out,
                   long long *stats, int n_blk, int nr, int rt, int bs,
                   int spc, cudaStream_t stream, long long *launched) {
  const long long ctas = (long long)n_blk * nr;
  if (ctas == 0) return cudaSuccess;
  const size_t smem =
      flood::raw_dynamic<DIM>() ? (size_t)SUB * DIM * sizeof(float) : 0;
  cudaError_t e = cudaSuccess;
  if (smem)
    e = cudaFuncSetAttribute(flood_min_kernel<DIM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return e;
  flood_min_kernel<DIM><<<(unsigned)ctas, rt / SPT, smem, stream>>>(
      samples, witnesses, sub_lo, sub_hi, centers, radii, tile_lo, tile_hi,
      ub2, blk_ptr, blk_chunks, cta_order, out, stats, nr, rt, bs, spc);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
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
    unsigned long long *__restrict__ stats,  // (n_blk * NR, 2), zeroed
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

  // The walk, 32 list positions at a time: lane l takes position base + l
  // (sub-chunk n % spc of the list's chunk n / spc), tests it against the
  // ball (skip 1) and, where it passes, computes its gap to the tile's box
  // for skip 2. `todo` holds the lanes whose sub-chunk passed and is ahead.
  const int c0 = blk_ptr[b];
  const int npos = (blk_ptr[b + 1] - c0) * spc;
  int base = -32, lsub = 0;
  float lgap = 0.f;
  unsigned todo = 0;
  auto next_ball = [&](float &g2) -> int {
    while (todo == 0) {
      base += 32;
      if (base >= npos) return -1;
      const int n = base + lane;
      bool pass = false;
      if (n < npos) {
        lsub = blk_chunks[c0 + n / spc] * spc + n % spc;
        pass = near2<DIM>(sub_lo, sub_hi, lsub, c) <= r2;  // skip 1
        if (pass) lgap = gap2<DIM>(sub_lo, sub_hi, lsub, c, tlo, thi);
      }
      todo = __ballot_sync(FULL, pass);
    }
    const int l = __ffs(todo) - 1;
    todo &= todo - 1;
    g2 = __shfl_sync(FULL, lgap, l);
    return __shfl_sync(FULL, lsub, l);
  };

  unsigned long long units = 0, inball = 0;
  float pm = CUDART_INF_F;  // the tile's max of its running mins
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
    atomicAdd(stats + 2 * row, units);
    atomicAdd(stats + 2 * row + 1, inball * FEW_RT);
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
      stats, 0, 2 * sizeof(long long) * (size_t)n_blk * nr, stream);
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
    long long *__restrict__ stats,        // (n_blk * NR, 2)
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
  long long units = 0, inball = 0;

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

    // The walk, 32 list positions at a time: lane l of every warp takes
    // position base + l (sub-chunk n % spc of the list's chunk n / spc),
    // tests it against the ball (skip 1) and, where it passes, computes its
    // gap to the tile's box for skip 2, whose bound changes with every unit.
    // `todo` holds the lanes whose sub-chunk passed and is still ahead.
    const int npos = (c1 - c0) * spc;
    int base = -32, lsub = 0;
    float lgap = 0.f;
    unsigned todo = 0;
    auto next_ball = [&](float &g2) -> int {
      while (todo == 0) {
        base += 32;
        if (base >= npos) return -1;
        const int n = base + lane;
        bool pass = false;
        if (n < npos) {
          lsub = blk_chunks[c0 + n / spc] * spc + n % spc;
          pass = near2_wide(sub_lo, sub_hi, lsub, c, dim) <= r2;  // skip 1
          if (pass) lgap = gap2_wide(sub_lo, sub_hi, lsub, c, tlo, thi, dim);
        }
        todo = __ballot_sync(FULL, pass);
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
    stats[2 * row] = units;
    stats[2 * row + 1] = inball * rt;
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

}  // namespace

extern "C" {

const char *flooder_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int flood_sub() { return SUB; }

// Warps (work items) of a few-sample CTA.
int flood_few_warps() { return FEW_WARPS; }

// Dynamic shared memory of flood_min_wide's CTA at `dim` coordinates (the
// launch asks for it).
long long flood_wide_smem_bytes(int dim) {
  return (long long)flood::wide_smem_bytes(dim, true);
}

// Launch K1 on `stream`. `rt` must be a multiple of 128 and at most 512;
// `dim` at least 1; `samples` (S, NR, RT, dim) for 1-8 coordinates and
// coordinate-major, (S, NR, dim, RT), for more (flood_min_wide: its shared
// memory, flood_wide_smem_bytes, is at most 98,304 bytes at 16
// coordinates and 35,840 at any width past 16: no width cap);
// `cta_order` a permutation of the blocks (CTA row i runs block
// cta_order[i]); `witnesses` 16-byte aligned. *launched is set to the
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
  if (rt <= 0 || rt > MAX_RT || rt % 128 != 0 ||
      reinterpret_cast<uintptr_t>(witnesses) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLOOD_MIN_LAUNCH(D)                                                 \
  launch<D>(samples, witnesses, sub_lo, sub_hi, centers, radii, tile_lo,    \
            tile_hi, ub2, blk_ptr, blk_chunks, cta_order, out, stats, n_blk, \
            nr, rt, bs, subs_per_chunk, s, launched)
  cudaError_t e;
  switch (dim) {
    case 1: e = FLOOD_MIN_LAUNCH(1); break;
    case 2: e = FLOOD_MIN_LAUNCH(2); break;
    case 3: e = FLOOD_MIN_LAUNCH(3); break;
    case 4: e = FLOOD_MIN_LAUNCH(4); break;
    case 5: e = FLOOD_MIN_LAUNCH(5); break;
    case 6: e = FLOOD_MIN_LAUNCH(6); break;
    case 7: e = FLOOD_MIN_LAUNCH(7); break;
    case 8: e = FLOOD_MIN_LAUNCH(8); break;
    default:
      e = dim < 1 ? cudaErrorInvalidValue
                  : launch_wide(samples, witnesses, sub_lo, sub_hi, centers,
                                radii, tile_lo, tile_hi, ub2, blk_ptr,
                                blk_chunks, cta_order, out, stats, n_blk, nr,
                                rt, bs, subs_per_chunk, dim, s, launched);
  }
#undef FLOOD_MIN_LAUNCH
  return static_cast<int>(e);
}

// Launch K1's few-sample instances on `stream`: as flood_min_launch, for
// tiles of FEW_RT samples (`rt` must be FEW_RT) at 1-8 coordinates, one
// warp a (simplex, tile). `stats` is zeroed on the stream before the
// launch adds each tile's counts to its row.
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
    default: e = cudaErrorInvalidValue;
  }
#undef FLOOD_MIN_FEW_LAUNCH
  return static_cast<int>(e);
}

}  // extern "C"
