// Flood min-distances with work counters on Hopper (kernel K3 of the port).
//
// Replaces the Pallas TPU kernel tools/kernel_stats.py:55
// (`_flood_kernel_stats`, launched by `_flood_pairs_call_stats` at :164),
// the instrumented clone of the flood kernel. It computes K1's values (the
// squared distance from every sample of every simplex to the nearest
// witness inside the simplex's bounding ball, over the per-block CSR
// work-list of witness chunks, nearest chunk first) and counts, per simplex:
//   col 0  the work-list pairs of its block (all of them are walked),
//   col 1  admitted (simplex, sub-chunk) units,
//   col 2  computed (simplex, tile, sub-chunk) sample tiles.
//
// Three tests, on the running mins K1 also computes (so K3 decides as K1's
// walk in one pass; against the plain version see flood.cu's note on the
// tile test):
//  1. ball: the sub-chunk's box must meet the simplex's ball;
//  2. unit: the squared gap between the sub-chunk's box and the simplex's
//     sample box must not exceed the simplex's bound, the max of its running
//     mins over ALL of its samples, taken once at the start of each pair;
//  3. tile: the squared gap to the tile's sample box must not exceed
//     min(tile's current max running min, ub2), K1's own tile test.
// Since sample-box gap <= tile gap <= tile max <= simplex max at the start
// of the pair, every tile a walk in one pass computes passes test 2: K3
// computes that walk's tiles, the counterpart of the TPU tool's. K1 walks
// each list twice, its seed pass first (flood.cu), and admits a subset of
// them: K3's output equals K1's bit for bit, and K1's admitted units and
// pairs are no more than K3's computed tiles and their pairs, block by
// block.
//
// Design: one CTA per simplex, because test 2 needs a max over all of a
// simplex's samples and K1's (block, tile) CTAs never see a whole simplex.
// The CTA keeps the simplex's nr x rt running mins in shared memory, walks
// its block's chunk list and writes its output and counters once. Simplices
// share only their block's pair list, so nothing is carried between CTAs.
// On top of that it is built as K1 is (flood.cu), with K1's own staging
// and inner loop (flood_common.cuh):
//  - Compaction: an admitted sub-chunk is staged once, its in-ball
//    witnesses at the front of each segment, and every computed tile of
//    the unit runs over the in-ball count only.
//  - One barrier per computed unit. Each warp publishes its max of a
//    computed tile's running mins (wmax, per tile and warp), and the
//    staging barrier that every unit needs anyway makes them visible; tests
//    2 and 3 take the max over a tile's warps. wmax is double-buffered: a
//    unit's tests read the published buffer while its computed tiles write
//    the other, and the tiles it does not compute are copied across, so no
//    thread's test can see a max its unit is still changing. The tests need
//    the maxima after the last computed unit, so the first ball candidate
//    after a computed unit is staged before it is tested; a candidate that
//    is staged and then rejected costs its staging and barrier and is not
//    counted.
//  - Pipelined staging: the next ball candidate's raw witnesses are fetched
//    with cp.async while the current unit computes, into a double-buffered
//    staged tile.
//  - Longest work-list first: CTA i runs simplex sim_order[i] (the caller
//    orders the blocks by work-list length, K1's order, and keeps each
//    block's simplices together), so long lists do not land in the last
//    wave. The counters are per simplex, so the order changes no output.
//  - Tile groups: a CTA holds 256 threads in groups of rt / 4 that share
//    the staged sub-chunk (G = 2 groups at rt 512; at 1-8 coordinates the
//    caller's tiles hold 128 samples, and a CTA has up to 8 groups of a
//    warp, as many as the simplex has tiles, at least 2: tile_groups); a
//    unit's computed tiles go to the groups in turn. A group's warps own a
//    tile's running mins for the unit, so the groups need no barrier among
//    themselves. With one group the longest simplices run their tiles one
//    after another (on an H100, 10.9 against 8.4 ms at 100k x 300 with tiles
//    of 512, about 1 % slower at 1M x 1k); four groups of 512 were no faster
//    (PERF.md). Tiles of 128 in two groups of a warp made the tool 1.3x
//    slower at 100k x 300 than tiles of 512 (PERF.md).
//
// What bounds it: fp32 instruction issue, as K1: 7 per (sample, in-ball
// witness) pair of the computed tiles, the pairs of a walk in one pass (no
// fewer than K1's), in the same inner loop (SASS). Bytes are far below: a
// computed tile's samples are read from L2, the witnesses once per admitted
// unit. What stays between the kernel and that floor is the walk of the
// list, the per-unit tests, staging, barrier waits and the tail of the last
// wave: without the launch order the longest simplices finish last and the
// kernel takes about 1.2x as long. Measured times beside the floor: PERF.md.
//
// 9 and more coordinates: one runtime-width instance, flood_stats_wide,
// with K1's wide forms (flood_common.cuh): the same tests, counters and
// launch order, rt / 2 threads a CTA that compute a unit's tiles one after
// another on the unit's compacted witnesses (each tile's samples staged in
// turn), the running mins in `out` and the tile maxima double-buffered in
// shared memory as above. Each d2 is summed as K1's wide instance sums it
// (one FMA a coordinate), so its output equals K1's bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flood_common.cuh"

namespace {

using flood::NSEG;
using flood::SUB;
constexpr int SPT = 4;  // samples per thread
constexpr int G = 2;    // tile groups a CTA at rt 512
constexpr int MAX_RT = 512;
constexpr int MAX_THREADS = G * MAX_RT / SPT;
constexpr int MAX_GROUP_WARPS = MAX_RT / SPT / 32;

// Tile groups of a CTA for tiles of rt samples and nr tiles a simplex: G
// at rt 512, and at smaller tiles as many more as keep the CTA's threads
// (256) where the simplex has the tiles to fill them.
int tile_groups(int nr, int rt) {
  const int most = MAX_THREADS / (rt / SPT);
  return most <= G ? most : (nr < G ? G : (nr < most ? nr : most));
}

template <int DIM>
__global__ void __launch_bounds__(MAX_THREADS) flood_stats_kernel(
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
    const int *__restrict__ sim_order,    // (S,) simplex of each CTA
    float *__restrict__ out,              // (S, NR, RT) min d^2
    long long *__restrict__ stats,        // (S, 3)
    int nr, int rt, int bs, int spc) {
  // mins: the simplex's running mins (nr, rt); wmax: two buffers of
  // (nr, MAX_GROUP_WARPS), per tile and group warp that warp's max of the
  // tile's running mins
  extern __shared__ __align__(16) float dyn[];
  float *mins = dyn;
  float *wmax = dyn + nr * rt;
  // raw: each lane's own slots of the next sub-chunk (cp.async target), in
  // dynamic shared memory after wmax where it would not fit beside wsh
  // (raw_dynamic; nr * rt + 2 * nr * MAX_GROUP_WARPS floats keep it 16-byte
  // aligned); wsh: the staged tile, two buffers
  constexpr bool RAW_DYN = flood::raw_dynamic<DIM>();
  __shared__ __align__(16) float raw_static[RAW_DYN ? 4 : SUB * DIM];
  float *raw = RAW_DYN ? wmax + 2 * nr * MAX_GROUP_WARPS : raw_static;
  __shared__ flood::Staged<DIM> wsh[2][SUB];
  __shared__ int segcnt[2][NSEG];

  const int s = sim_order[blockIdx.x];
  const int b = s / bs;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const int TG = rt / SPT;  // threads of a tile group
  const int NG = T / TG;     // tile groups (tile_groups)
  const int g = tid / TG, gt = tid - g * TG;
  const int gw = gt >> 5, ngw = TG >> 5;  // warp in the group, its count
  const int c0 = blk_ptr[b], c1 = blk_ptr[b + 1];
  const size_t row0 = (size_t)s * nr;  // the simplex's first tile

  for (int i = tid; i < nr * rt; i += T) mins[i] = CUDART_INF_F;
  for (int i = tid; i < nr * MAX_GROUP_WARPS; i += T)
    wmax[i] = CUDART_INF_F;

  float c[DIM], slo[DIM], shi[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    c[d] = centers[(size_t)s * DIM + d];
    slo[d] = tile_lo[row0 * DIM + d];
    shi[d] = tile_hi[row0 * DIM + d];
  }
  for (int r = 1; r < nr; ++r) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      slo[d] = fminf(slo[d], tile_lo[(row0 + r) * DIM + d]);
      shi[d] = fmaxf(shi[d], tile_hi[(row0 + r) * DIM + d]);
    }
  }
  const float rad = radii[s];
  const float r2 = __fmul_rn(rad, rad);
  int units = 0, tiles = 0;  // per simplex: at most 4 x pairs (x nr)
  __syncthreads();

  // the list cursor and the next sub-chunk that passes test 1, with its pair
  int p = c0, q = 0;
  auto next_ball = [&](int &pair) -> int {
    while (p < c1) {
      const int sub = blk_chunks[p] * spc + q;
      pair = p;
      if (++q == spc) {
        q = 0;
        ++p;
      }
      if (flood::near2<DIM>(sub_lo, sub_hi, sub, c) <= r2) return sub;
    }
    return -1;
  };
  // wmax[buf] entries of tile r; buffer `cur` holds the published maxima
  int cur = 0;
  auto wmax_at = [&](int buf, int r) {
    return wmax + (buf * nr + r) * MAX_GROUP_WARPS;
  };
  // tile r's current max running min
  auto tile_max = [&](int r) {
    const float *m = wmax_at(cur, r);
    float v = m[0];
    for (int w = 1; w < ngw; ++w) v = fmaxf(v, m[w]);
    return v;
  };
  auto tile_pass = [&](int sub, int r) {  // test 3
    const size_t tile = row0 + r;
    return flood::gap2<DIM>(sub_lo, sub_hi, sub, c, tile_lo + tile * DIM,
                            tile_hi + tile * DIM) <=
           fminf(tile_max(r), ub2[tile]);
  };
  // test 2; the simplex's bound is taken once per pair, from published maxima
  float s_bound = 0.f;
  int bound_pair = -1;
  auto unit_pass = [&](int sub, int pair) {
    if (pair != bound_pair) {
      s_bound = tile_max(0);
      for (int r = 1; r < nr; ++r) s_bound = fmaxf(s_bound, tile_max(r));
      bound_pair = pair;
    }
    return flood::gap2<DIM>(sub_lo, sub_hi, sub, c, slo, shi) <= s_bound;
  };

  int wb = 0;             // the staging buffer no thread reads
  bool dirty = false;     // a unit computed since the last barrier
  bool fetched = false;   // cand's raw data is on its way
  int cand_pair = 0, nxt_pair = 0;
  int cand = next_ball(cand_pair);
  while (cand >= 0) {
    if (!dirty) {
      // the published maxima are current: test before staging
      bool any = unit_pass(cand, cand_pair);
      if (any) {
        ++units;
        any = false;
        for (int r = 0; r < nr && !any; ++r) any = tile_pass(cand, r);
      }
      if (!any) {
        cand = next_ball(cand_pair);
        fetched = false;
        continue;
      }
      if (!fetched)
        flood::fetch_raw<DIM>(raw, witnesses, cand, warp, nw, lane);
    }

    flood::stage_compacted<DIM>(raw, c, r2, wsh[wb], segcnt[wb], warp, nw,
                                lane);
    // fetch the next ball candidate while this one is tested and computed
    const int nxt = next_ball(nxt_pair);
    if (nxt >= 0) flood::fetch_raw<DIM>(raw, witnesses, nxt, warp, nw, lane);
    __syncthreads();  // publishes wsh[wb], segcnt[wb] and the last maxima

    bool admitted = true;
    if (dirty) {
      cur ^= 1;
      dirty = false;
      admitted = unit_pass(cand, cand_pair);
      if (admitted) ++units;
    }
    if (admitted) {
      int k = 0;  // computed tiles of this unit so far
      for (int r = 0; r < nr; ++r) {
        if (!tile_pass(cand, r)) {
          // carry the tile's maxima over to the buffer the next unit reads
          if (tid < ngw) wmax_at(cur ^ 1, r)[tid] = wmax_at(cur, r)[tid];
          continue;
        }
        if (k++ % NG != g) continue;
        const size_t tile = row0 + r;
        float x[SPT][DIM], acc[SPT];
#pragma unroll
        for (int kk = 0; kk < SPT; ++kk) {
          const int j = gt + kk * TG;
#pragma unroll
          for (int d = 0; d < DIM; ++d)
            x[kk][d] = samples[(tile * rt + j) * DIM + d];
          acc[kk] = mins[r * rt + j];
        }
        flood::min_over_staged<DIM, SPT>(wsh[wb], segcnt[wb], x, acc);
        float wm = acc[0];
#pragma unroll
        for (int kk = 0; kk < SPT; ++kk) {
          mins[r * rt + gt + kk * TG] = acc[kk];
          wm = fmaxf(wm, acc[kk]);
        }
        for (int off = 16; off > 0; off >>= 1)
          wm = fmaxf(wm, __shfl_xor_sync(flood::FULL, wm, off));
        if (lane == 0) wmax_at(cur ^ 1, r)[gw] = wm;
      }
      tiles += k;
      if (k > 0) {
        dirty = true;
        wb ^= 1;
      }
    }
    cand = nxt;
    cand_pair = nxt_pair;
    fetched = true;
  }
  flood::cp_async_wait_all();
  __syncthreads();  // every group's running mins written

  for (int i = tid; i < nr * rt; i += T) out[row0 * rt + i] = mins[i];
  if (tid == 0) {
    stats[3 * (size_t)s] = c1 - c0;
    stats[3 * (size_t)s + 1] = units;
    stats[3 * (size_t)s + 2] = tiles;
  }
}

template <int DIM>
cudaError_t launch(const float *samples, const float *witnesses,
                   const float *sub_lo, const float *sub_hi,
                   const float *centers, const float *radii,
                   const float *tile_lo, const float *tile_hi,
                   const float *ub2, const int *blk_ptr,
                   const int *blk_chunks, const int *sim_order, float *out,
                   long long *stats, int s_total, int nr, int rt, int bs,
                   int spc, cudaStream_t stream, long long *launched) {
  if (s_total == 0) return cudaSuccess;
  const size_t smem =
      ((size_t)nr * rt + 2 * (size_t)nr * MAX_GROUP_WARPS +
       (flood::raw_dynamic<DIM>() ? (size_t)SUB * DIM : 0)) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flood_stats_kernel<DIM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  flood_stats_kernel<DIM><<<(unsigned)s_total,
                            tile_groups(nr, rt) * (rt / SPT), smem,
                            stream>>>(
      samples, witnesses, sub_lo, sub_hi, centers, radii, tile_lo, tile_hi,
      ub2, blk_ptr, blk_chunks, sim_order, out, stats, nr, rt, bs, spc);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

// The runtime-width instance (9 and more coordinates); see the note at the
// top.
constexpr int WIDE_THREADS = MAX_RT / 2;

// Dynamic shared memory of flood_stats_wide: K1's wide forms without the
// raw buffer, then the simplex's sample box (2 * dim floats) and two
// buffers of tile maxima (2 * nr * WIDE_MAX_WARPS floats).
size_t stats_wide_smem(int dim, int nr) {
  return flood::wide_smem_bytes(dim, false) +
         (2 * (size_t)dim + 2 * (size_t)nr * flood::WIDE_MAX_WARPS) *
             sizeof(float);
}

__global__ void __launch_bounds__(WIDE_THREADS, 2) flood_stats_wide(
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
    const int *__restrict__ sim_order,    // (S,) simplex of each CTA
    float *__restrict__ out,              // (S, NR, RT) min d^2
    long long *__restrict__ stats,        // (S, 3)
    int nr, int rt, int bs, int spc, int dim) {
  // xs, ws (and idx past one slab): K1's wide staging; slo, shi: the
  // simplex's sample box; wmax: two buffers of (nr, WIDE_MAX_WARPS), per
  // tile and warp that warp's max of the tile's running mins
  using namespace flood;
  extern __shared__ __align__(16) float dyn[];
  const bool one = dim <= WIDE_KS;
  float *xs = dyn;
  float *ws = xs + (one ? dim : WIDE_KS) * WIDE_XS;
  unsigned short *idx =
      reinterpret_cast<unsigned short *>(ws + WIDE_KS * WIDE_STEP);
  float *slo = dyn + wide_smem_bytes(dim, false) / sizeof(float);
  float *shi = slo + dim;
  float *wmax = shi + dim;
  __shared__ int gcnt[WIDE_GROUPS];

  const int s = sim_order[blockIdx.x];
  const int b = s / bs;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const int xo = warp * WIDE_WARP_SAMPLES + 4 * (lane / WIDE_WL);
  const int wo = 4 * (lane % WIDE_WL);
  const int c0 = blk_ptr[b], c1 = blk_ptr[b + 1];
  const size_t row0 = (size_t)s * nr;  // the simplex's first tile
  const float *c = centers + (size_t)s * dim;

  for (int i = tid; i < 2 * nr * WIDE_MAX_WARPS; i += T)
    wmax[i] = CUDART_INF_F;
  for (int i = tid; i < nr * rt; i += T) out[row0 * rt + i] = CUDART_INF_F;
  for (int d = tid; d < dim; d += T) {
    float lo = tile_lo[row0 * dim + d], hi = tile_hi[row0 * dim + d];
    for (int r = 1; r < nr; ++r) {
      lo = fminf(lo, tile_lo[(row0 + r) * dim + d]);
      hi = fmaxf(hi, tile_hi[(row0 + r) * dim + d]);
    }
    slo[d] = lo;
    shi[d] = hi;
  }
  const float rad = radii[s];
  const float r2 = __fmul_rn(rad, rad);
  int units = 0, tiles = 0;
  int cur = 0;  // the wmax buffer that holds the published maxima
  __syncthreads();

  auto wmax_at = [&](int buf, int r) {
    return wmax + (buf * nr + r) * WIDE_MAX_WARPS;
  };
  auto tile_max = [&](int r) {  // tile r's current max running min
    const float *m = wmax_at(cur, r);
    float v = m[0];
    for (int w = 1; w < nw; ++w) v = fmaxf(v, m[w]);
    return v;
  };
  auto tile_pass = [&](int sub, int r) {  // test 3
    const size_t tile = row0 + r;
    return gap2_wide(sub_lo, sub_hi, sub, c, tile_lo + tile * dim,
                     tile_hi + tile * dim, dim) <=
           fminf(tile_max(r), ub2[tile]);
  };

  for (int p = c0; p < c1; ++p) {
    // test 2's bound, from the maxima at the start of the pair
    float s_bound = tile_max(0);
    for (int r = 1; r < nr; ++r) s_bound = fmaxf(s_bound, tile_max(r));
    for (int q = 0; q < spc; ++q) {
      const int sub = blk_chunks[p] * spc + q;
      if (!(near2_wide(sub_lo, sub_hi, sub, c, dim) <= r2))
        continue;  // test 1
      if (!(gap2_wide(sub_lo, sub_hi, sub, c, slo, shi, dim) <= s_bound))
        continue;  // test 2
      ++units;
      int k = 0;  // the unit's computed tiles
      for (int r = 0; r < nr; ++r) k += tile_pass(sub, r);
      if (k == 0) continue;
      tiles += k;
      const float *rows = witnesses + (size_t)sub * SUB * dim;
      const unsigned in_mask = wide_ball_test(rows, c, r2, dim, gcnt);
      __syncthreads();  // gcnt published; the last unit's readers are done
      const int m = wide_compact(rows, c, dim, in_mask, gcnt, one, ws, idx);
      __syncthreads();  // the staged unit published
      for (int r = 0; r < nr; ++r) {
        if (!tile_pass(sub, r)) {
          // carry the tile's maxima over to the buffer the next unit reads
          if (tid < nw) wmax_at(cur ^ 1, r)[tid] = wmax_at(cur, r)[tid];
          continue;
        }
        const float *xt = samples_t + (row0 + r) * dim * rt;
        float *o = out + (row0 + r) * rt + xo;
        const float4 lo4 = *reinterpret_cast<const float4 *>(o);
        const float4 hi4 = *reinterpret_cast<const float4 *>(o + 32);
        float mn[WIDE_TM] = {lo4.x, lo4.y, lo4.z, lo4.w,
                             hi4.x, hi4.y, hi4.z, hi4.w};
        if (one) {
          __syncthreads();  // the last tile's readers of xs are done
          wide_stage_samples(xs, xt, dim, rt);
          __syncthreads();
        }
        wide_min_over_unit(mn, xs, ws, idx, xt, witnesses, sub, c, rt, dim,
                           m, one, xo, wo);
        wide_lane_min(mn);
        if (lane % WIDE_WL == 0) {
          *reinterpret_cast<float4 *>(o) =
              make_float4(mn[0], mn[1], mn[2], mn[3]);
          *reinterpret_cast<float4 *>(o + 32) =
              make_float4(mn[4], mn[5], mn[6], mn[7]);
        }
        const float wm = wide_warp_max(mn);
        if (lane == 0) wmax_at(cur ^ 1, r)[warp] = wm;
      }
      __syncthreads();  // the other buffer is complete; no test reads cur
      cur ^= 1;
    }
  }
  if (tid == 0) {
    stats[3 * (size_t)s] = c1 - c0;
    stats[3 * (size_t)s + 1] = units;
    stats[3 * (size_t)s + 2] = tiles;
  }
}

cudaError_t launch_wide(const float *samples_t, const float *witnesses,
                        const float *sub_lo, const float *sub_hi,
                        const float *centers, const float *radii,
                        const float *tile_lo, const float *tile_hi,
                        const float *ub2, const int *blk_ptr,
                        const int *blk_chunks, const int *sim_order,
                        float *out, long long *stats, int s_total, int nr,
                        int rt, int bs, int spc, int dim,
                        cudaStream_t stream, long long *launched) {
  if (s_total == 0) return cudaSuccess;
  const size_t smem = stats_wide_smem(dim, nr);
  cudaError_t e = cudaFuncSetAttribute(
      flood_stats_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flood_stats_wide,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  flood_stats_wide<<<(unsigned)s_total, rt / 2, smem, stream>>>(
      samples_t, witnesses, sub_lo, sub_hi, centers, radii, tile_lo, tile_hi,
      ub2, blk_ptr, blk_chunks, sim_order, out, stats, nr, rt, bs, spc, dim);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

}  // namespace

extern "C" {

const char *flood_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int flood_stats_sub() { return SUB; }

// Dynamic shared memory of flood_stats_wide's CTA (the launch asks for it).
long long flood_stats_wide_smem_bytes(int dim, int nr) {
  return (long long)stats_wide_smem(dim, nr);
}

// Launch K3 on `stream`: one CTA per simplex row, CTA i on simplex
// sim_order[i] (a permutation of the rows). `rt` must be a multiple of 128
// and at most 512; `dim` at least 1; `samples` (S, NR, RT, dim) for 1-8
// coordinates and coordinate-major, (S, NR, dim, RT), for more; `witnesses`
// 16-byte aligned. The CTA's shared memory must hold, for 1-8 coordinates,
// the simplex's running mins and tile maxima, (nr * rt + 8 * nr) floats
// (and at DIM 8 the raw fetch buffer, SUB * 8 floats), and for more
// flood_stats_wide_smem_bytes: K1's wide staging without its raw buffer,
// the sample box and the tile maxima, (2 * dim + 16 * nr) floats more.
// *launched is set to the number of kernel launches enqueued without error
// (0 when there is no simplex). Returns 0 or the CUDA error.
int flood_stats_launch(const float *samples, const float *witnesses,
                       const float *sub_lo, const float *sub_hi,
                       const float *centers, const float *radii,
                       const float *tile_lo, const float *tile_hi,
                       const float *ub2, const int *blk_ptr,
                       const int *blk_chunks, const int *sim_order,
                       float *out, long long *stats, int s_total, int nr,
                       int rt, int dim, int bs, int subs_per_chunk,
                       void *stream, long long *launched) {
  *launched = 0;
  if (rt <= 0 || rt > MAX_RT || rt % 128 != 0 || nr <= 0 ||
      reinterpret_cast<uintptr_t>(witnesses) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLOOD_STATS_LAUNCH(D)                                               \
  launch<D>(samples, witnesses, sub_lo, sub_hi, centers, radii, tile_lo,    \
            tile_hi, ub2, blk_ptr, blk_chunks, sim_order, out, stats,       \
            s_total, nr, rt, bs, subs_per_chunk, st, launched)
  cudaError_t e;
  switch (dim) {
    case 1: e = FLOOD_STATS_LAUNCH(1); break;
    case 2: e = FLOOD_STATS_LAUNCH(2); break;
    case 3: e = FLOOD_STATS_LAUNCH(3); break;
    case 4: e = FLOOD_STATS_LAUNCH(4); break;
    case 5: e = FLOOD_STATS_LAUNCH(5); break;
    case 6: e = FLOOD_STATS_LAUNCH(6); break;
    case 7: e = FLOOD_STATS_LAUNCH(7); break;
    case 8: e = FLOOD_STATS_LAUNCH(8); break;
    default:
      e = dim < 1 ? cudaErrorInvalidValue
                  : launch_wide(samples, witnesses, sub_lo, sub_hi, centers,
                                radii, tile_lo, tile_hi, ub2, blk_ptr,
                                blk_chunks, sim_order, out, stats, s_total,
                                nr, rt, bs, subs_per_chunk, dim, st,
                                launched);
  }
#undef FLOOD_STATS_LAUNCH
  return static_cast<int>(e);
}

}  // extern "C"
