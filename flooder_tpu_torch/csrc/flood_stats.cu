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
// Three tests, on the running mins K1 also computes (so K3 decides as K1
// does; against the plain version see flood.cu's note on the tile test):
//  1. ball: the sub-chunk's box must meet the simplex's ball;
//  2. unit: the squared gap between the sub-chunk's box and the simplex's
//     sample box must not exceed the simplex's bound, the max of its running
//     mins over ALL of its samples, taken once at the start of each pair;
//  3. tile: the squared gap to the tile's sample box must not exceed
//     min(tile's current max running min, ub2), K1's own tile test.
// Since sample-box gap <= tile gap <= tile max <= simplex max at the start
// of the pair, every tile K1 computes passes test 2: K3 computes the same
// tiles as K1 and its output equals K1's bit for bit.
//
// Design: one CTA per simplex, because test 2 needs a max over all of a
// simplex's samples and K1's (block, tile) CTAs never see a whole simplex.
// The CTA keeps the simplex's nr x rt running mins and each tile's max in
// shared memory (20 KB at nr 10, rt 512), walks its block's chunk list,
// stages every unit with a computed tile in shared memory once (out-of-ball
// witnesses moved to 3e18), runs the admitted tiles one after another with
// the samples in registers, and writes its output and counters once. The
// simplices of a block share only their pair list, so nothing is carried
// between CTAs: no atomics, no aliased accumulator, no launch segments, no
// lane-masked counter rows, and the witnesses keep their (W, dim) layout.
//
// Arithmetic: K1's difference form, through the device functions K1 uses
// (flood_common.cuh), so K3 and K1 agree bit for bit; both are within an
// ulp or so of their plain PyTorch versions (the per-pair FMA), and every
// test is explicitly rounded as there (built with -fmad=false).
//
// What bounds it: fp32 instruction issue, as K1: 7 per (sample, witness)
// pair of the computed tiles, over all 512 witnesses of a staged sub-chunk
// (K3 does not compact them). Bytes are far below: the samples of a tile
// are read once per computed tile from L2, and the witnesses once per
// admitted unit.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flood_common.cuh"

namespace {

using flood::SUB;
using flood::sq_add;
constexpr int SPT = 4;  // samples per thread
constexpr int MAX_THREADS = 512 / SPT;

// Max over the block (every thread gets it). Ends in a barrier, so `red`
// may be reused right after.
__device__ __forceinline__ float block_max(float v, float *red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  float m = red[0];
  for (int w = 1; w < nwarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

template <int DIM>
__global__ void __launch_bounds__(MAX_THREADS) flood_stats_kernel(
    const float *__restrict__ samples,    // (S, NR, RT, DIM) ball-local
    const float *__restrict__ witnesses,  // (W, DIM) kd-ordered
    const float *__restrict__ sub_lo,     // (W / SUB, DIM) sub-chunk boxes
    const float *__restrict__ sub_hi,
    const float *__restrict__ centers,  // (S, DIM)
    const float *__restrict__ radii,    // (S,)
    const float *__restrict__ tile_lo,  // (S, NR, DIM) ball-local
    const float *__restrict__ tile_hi,
    const float *__restrict__ ub2,        // (S, NR)
    const int *__restrict__ blk_ptr,      // (n_blk + 1,) CSR offsets
    const int *__restrict__ blk_chunks,   // chunk ids, nearest first
    float *__restrict__ out,              // (S, NR, RT) min d^2
    long long *__restrict__ stats,        // (S, 3)
    int nr, int rt, int bs, int subs_per_chunk) {
  extern __shared__ float dyn[];
  float *mins = dyn;              // (NR, RT) running mins of this simplex
  float *tmax = dyn + nr * rt;    // (NR,) max of each tile's running mins
  __shared__ float4 wsh[SUB];
  __shared__ float red[32];
  const int s = blockIdx.x;
  const int b = s / bs;
  const int tid = threadIdx.x, T = blockDim.x;
  const int c0 = blk_ptr[b], c1 = blk_ptr[b + 1];
  const size_t row0 = (size_t)s * nr;  // the simplex's first tile

  for (int i = tid; i < nr * rt; i += T) mins[i] = CUDART_INF_F;
  for (int r = tid; r < nr; r += T) tmax[r] = CUDART_INF_F;

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
  long long units = 0, tiles = 0;
  __syncthreads();

  for (int p = c0; p < c1; ++p) {
    // test 2's bound, once per pair (the last write to tmax was followed
    // by a barrier)
    float s_bound = tmax[0];
    for (int r = 1; r < nr; ++r) s_bound = fmaxf(s_bound, tmax[r]);
    const int chunk = blk_chunks[p];
    for (int q = 0; q < subs_per_chunk; ++q) {
      const int sub = chunk * subs_per_chunk + q;
      float blo[DIM], bhi[DIM];
      float near2 = 0.f, sgap2 = 0.f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const float lo = sub_lo[(size_t)sub * DIM + d];
        const float hi = sub_hi[(size_t)sub * DIM + d];
        near2 = sq_add(near2, __fsub_rn(fminf(fmaxf(c[d], lo), hi), c[d]));
        blo[d] = __fsub_rn(lo, c[d]);
        bhi[d] = __fsub_rn(hi, c[d]);
        const float g = fmaxf(
            fmaxf(__fsub_rn(blo[d], shi[d]), __fsub_rn(slo[d], bhi[d])), 0.f);
        sgap2 = sq_add(sgap2, g);
      }
      // tests 1 and 2, uniform over the CTA
      if (!(near2 <= r2 && sgap2 <= s_bound)) continue;
      ++units;

      bool staged = false;
      for (int r = 0; r < nr; ++r) {
        const size_t tile = row0 + r;
        float gap2 = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          const float g = fmaxf(
              fmaxf(__fsub_rn(blo[d], tile_hi[tile * DIM + d]),
                    __fsub_rn(tile_lo[tile * DIM + d], bhi[d])),
              0.f);
          gap2 = sq_add(gap2, g);
        }
        // test 3, uniform: tmax[r] changes only after this tile's barrier
        if (!(gap2 <= fminf(tmax[r], ub2[tile]))) continue;
        ++tiles;

        if (!staged) {
          // the sub-chunk, ball-local, out-of-ball witnesses far away (the
          // barrier that ended the previous unit ordered its readers)
          for (int j = tid; j < SUB; j += T) {
            float4 yl;
            const bool in = flood::ball_local<DIM>(
                witnesses + ((size_t)sub * SUB + j) * DIM, c, r2, yl);
            wsh[j] = in ? yl : flood::masked<DIM>();
          }
          __syncthreads();
          staged = true;
        }

        float x[SPT][DIM], acc[SPT];
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          const int j = tid + k * T;
#pragma unroll
          for (int d = 0; d < DIM; ++d)
            x[k][d] = samples[(tile * rt + j) * DIM + d];
          acc[k] = mins[r * rt + j];
        }
#pragma unroll 4
        for (int w = 0; w < SUB; ++w) {
          const float4 yv = wsh[w];
#pragma unroll
          for (int k = 0; k < SPT; ++k)
            acc[k] = fminf(acc[k], flood::pair_d2<DIM>(yv, x[k]));
        }
        float pm = acc[0];
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          mins[r * rt + tid + k * T] = acc[k];
          pm = fmaxf(pm, acc[k]);
        }
        pm = block_max(pm, red);
        if (tid == 0) tmax[r] = pm;
      }
      // tmax visible to all, and every read of wsh done before the next
      // staging
      __syncthreads();
    }
  }

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
                   const int *blk_chunks, float *out, long long *stats,
                   int s_total, int nr, int rt, int bs, int subs_per_chunk,
                   cudaStream_t stream, long long *launched) {
  if (s_total == 0) return cudaSuccess;
  const size_t smem = ((size_t)nr * rt + nr) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flood_stats_kernel<DIM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  flood_stats_kernel<DIM><<<(unsigned)s_total, rt / SPT, smem, stream>>>(
      samples, witnesses, sub_lo, sub_hi, centers, radii, tile_lo, tile_hi,
      ub2, blk_ptr, blk_chunks, out, stats, nr, rt, bs, subs_per_chunk);
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

// Launch K3 on `stream`: one CTA per simplex row. `rt` must be a multiple
// of 128 and at most 512; `dim` 1..4; the simplex's running mins,
// (nr * rt + nr) floats, must fit the CTA's shared memory. *launched is set
// to the number of kernel launches enqueued without error (0 when there is
// no simplex). Returns 0 or the CUDA error.
int flood_stats_launch(const float *samples, const float *witnesses,
                       const float *sub_lo, const float *sub_hi,
                       const float *centers, const float *radii,
                       const float *tile_lo, const float *tile_hi,
                       const float *ub2, const int *blk_ptr,
                       const int *blk_chunks, float *out, long long *stats,
                       int s_total, int nr, int rt, int dim, int bs,
                       int subs_per_chunk, void *stream,
                       long long *launched) {
  *launched = 0;
  if (rt <= 0 || rt > SPT * MAX_THREADS || rt % 128 != 0 || nr <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dim) {
    case 1:
      e = launch<1>(samples, witnesses, sub_lo, sub_hi, centers, radii,
                    tile_lo, tile_hi, ub2, blk_ptr, blk_chunks, out, stats,
                    s_total, nr, rt, bs, subs_per_chunk, st, launched);
      break;
    case 2:
      e = launch<2>(samples, witnesses, sub_lo, sub_hi, centers, radii,
                    tile_lo, tile_hi, ub2, blk_ptr, blk_chunks, out, stats,
                    s_total, nr, rt, bs, subs_per_chunk, st, launched);
      break;
    case 3:
      e = launch<3>(samples, witnesses, sub_lo, sub_hi, centers, radii,
                    tile_lo, tile_hi, ub2, blk_ptr, blk_chunks, out, stats,
                    s_total, nr, rt, bs, subs_per_chunk, st, launched);
      break;
    case 4:
      e = launch<4>(samples, witnesses, sub_lo, sub_hi, centers, radii,
                    tile_lo, tile_hi, ub2, blk_ptr, blk_chunks, out, stats,
                    s_total, nr, rt, bs, subs_per_chunk, st, launched);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
