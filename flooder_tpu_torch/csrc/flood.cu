// Flood min-distances on Hopper (kernel K1 of the port).
//
// Replaces the Pallas TPU kernel flooder_tpu/ops/pallas_flood.py:333
// (`_flood_kernel`, launched by `_flood_pairs_call` at :503). For every
// sample point of every simplex it computes the squared distance to the
// nearest witness inside the simplex's bounding ball, over a work-list of
// (block of BS simplices, chunk of kd-ordered witnesses) pairs, each chunk
// taken as SUB-witness sub-chunks.
//
// Design: one CTA per (simplex block, sample tile). The CTA takes the
// block's simplices one after another; for each it keeps the running min
// of its tile's samples in registers (SPT samples per thread), walks the
// block's chunk list nearest-first (a per-block CSR built by the caller),
// stages every admitted sub-chunk in shared memory with out-of-ball
// witnesses moved to 3e18, and writes its output once. Nothing is carried
// between CTAs, so there are no atomics, no aliased accumulator and no
// launch segments (the TPU's sequential grid needed all three).
//
// Two lossless skips, both exact:
//  1. ball test: the sub-chunk's box must meet the simplex's ball;
//  2. tile test: the squared gap between the sub-chunk's box and the
//     tile's sample box must not exceed min(tile's current max running
//     min, ub2), where ub2 is the static nearest-vertex bound (+inf unless
//     the landmarks lie in the cloud). A sub-chunk farther than the tile's
//     current worst sample cannot lower any sample of the tile. This
//     per-tile bound is tighter than the TPU's per-simplex one.
//
// Arithmetic: the difference form, d2 += (y_i - x_i)^2 coordinate by
// coordinate in fp32, every operation explicitly rounded (no FMA, no
// tensor cores: the |x|^2 - 2x.y + |y|^2 form breaks the oracle tolerance,
// pallas_flood.py:51-56). 3 * (3e18)^2 ~ 2.7e37 stays finite in fp32, and
// outputs >= 1e30 mean "no witness in the ball".
//
// What bounds it: fp32 operations. Each in-ball (sample, witness) pair of
// an admitted unit costs 9 (3 sub, 3 mul, 2 add, 1 min); the witness is a
// shared-memory broadcast read once per SPT samples, and the inputs are
// read from device memory once per admitted unit, so bytes are far below
// the operations. The caller gets per-CTA counts of admitted units and of
// in-ball pairs, from which the bound is computed.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int SUB = 512;  // witnesses per sub-chunk
constexpr int SPT = 4;    // samples per thread
constexpr int MAX_THREADS = 512 / SPT;
constexpr float MASK = 3e18f;

__device__ __forceinline__ float sq_add(float acc, float diff) {
  return __fadd_rn(acc, __fmul_rn(diff, diff));
}

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

__device__ __forceinline__ float comp(const float4 &v, int d) {
  return d == 0 ? v.x : d == 1 ? v.y : d == 2 ? v.z : v.w;
}

template <int DIM>
__global__ void __launch_bounds__(MAX_THREADS) flood_min_kernel(
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
    long long *__restrict__ stats,        // (n_blk * NR, 2)
    int nr, int rt, int bs, int subs_per_chunk) {
  __shared__ float4 wsh[SUB];
  __shared__ float red[32];
  const int cta = blockIdx.x;
  const int b = cta / nr, r = cta - b * nr;
  const int tid = threadIdx.x, T = blockDim.x;
  const int c0 = blk_ptr[b], c1 = blk_ptr[b + 1];
  long long units = 0, inball = 0;

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

    for (int p = c0; p < c1; ++p) {
      const int chunk = blk_chunks[p];
      for (int q = 0; q < subs_per_chunk; ++q) {
        const int sub = chunk * subs_per_chunk + q;
        float lo[DIM], hi[DIM];
        float near2 = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          lo[d] = sub_lo[(size_t)sub * DIM + d];
          hi[d] = sub_hi[(size_t)sub * DIM + d];
          const float nd = __fsub_rn(fminf(fmaxf(c[d], lo[d]), hi[d]), c[d]);
          near2 = sq_add(near2, nd);
        }
        if (!(near2 <= r2)) continue;  // skip 1, uniform over the CTA

        float pm = acc[0];
#pragma unroll
        for (int k = 1; k < SPT; ++k) pm = fmaxf(pm, acc[k]);
        pm = block_max(pm, red);
        float gap2 = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          const float blo = __fsub_rn(lo[d], c[d]);
          const float bhi = __fsub_rn(hi[d], c[d]);
          const float g = fmaxf(
              fmaxf(__fsub_rn(blo, thi[d]), __fsub_rn(tlo[d], bhi)), 0.f);
          gap2 = sq_add(gap2, g);
        }
        if (!(gap2 <= fminf(pm, ub))) continue;  // skip 2, uniform

        // stage the sub-chunk, ball-local, out-of-ball witnesses far away
        // (the barrier inside block_max ordered the previous readers)
        int cnt = 0;
        for (int base = 0; base < SUB; base += T) {
          const int j = base + tid;
          int in = 0;
          if (j < SUB) {
            const float *y = witnesses + ((size_t)sub * SUB + j) * DIM;
            float yl[4] = {0.f, 0.f, 0.f, 0.f};
            float y2 = 0.f;
#pragma unroll
            for (int d = 0; d < DIM; ++d) {
              yl[d] = __fsub_rn(y[d], c[d]);
              y2 = d == 0 ? __fmul_rn(yl[d], yl[d]) : sq_add(y2, yl[d]);
            }
            in = y2 <= r2;
            if (!in) {
#pragma unroll
              for (int d = 0; d < DIM; ++d) yl[d] = MASK;
            }
            wsh[j] = make_float4(yl[0], yl[1], yl[2], yl[3]);
          }
          cnt += __syncthreads_count(in);
        }
        units += 1;
        inball += cnt;

#pragma unroll 4
        for (int w = 0; w < SUB; ++w) {
          const float4 yv = wsh[w];
#pragma unroll
          for (int k = 0; k < SPT; ++k) {
            float d2 = 0.f;
#pragma unroll
            for (int d = 0; d < DIM; ++d)
              d2 = sq_add(d2, __fsub_rn(comp(yv, d), x[k][d]));
            acc[k] = fminf(acc[k], d2);
          }
        }
        __syncthreads();  // all reads of wsh done before the next staging
      }
    }
#pragma unroll
    for (int k = 0; k < SPT; ++k) out[tile * rt + tid + k * T] = acc[k];
  }
  if (tid == 0) {
    stats[2 * (size_t)cta] = units;
    stats[2 * (size_t)cta + 1] = inball * rt;
  }
}

template <int DIM>
cudaError_t launch(const float *samples, const float *witnesses,
                   const float *sub_lo, const float *sub_hi,
                   const float *centers, const float *radii,
                   const float *tile_lo, const float *tile_hi,
                   const float *ub2, const int *blk_ptr,
                   const int *blk_chunks, float *out, long long *stats,
                   int n_blk, int nr, int rt, int bs, int subs_per_chunk,
                   cudaStream_t stream, long long *launched) {
  const long long ctas = (long long)n_blk * nr;
  if (ctas == 0) return cudaSuccess;
  flood_min_kernel<DIM><<<(unsigned)ctas, rt / SPT, 0, stream>>>(
      samples, witnesses, sub_lo, sub_hi, centers, radii, tile_lo, tile_hi,
      ub2, blk_ptr, blk_chunks, out, stats, nr, rt, bs, subs_per_chunk);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

}  // namespace

extern "C" {

const char *flooder_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int flood_sub() { return SUB; }

// Launch K1 on `stream`. `rt` must be a multiple of 128 and at most 512;
// `dim` 1..4. *launched is set to the number of kernel launches enqueued
// without error (0 when there is no CTA). Returns 0 or the CUDA launch
// error.
int flood_min_launch(const float *samples, const float *witnesses,
                     const float *sub_lo, const float *sub_hi,
                     const float *centers, const float *radii,
                     const float *tile_lo, const float *tile_hi,
                     const float *ub2, const int *blk_ptr,
                     const int *blk_chunks, float *out, long long *stats,
                     int n_blk, int nr, int rt, int dim, int bs,
                     int subs_per_chunk, void *stream,
                     long long *launched) {
  *launched = 0;
  if (rt <= 0 || rt > SPT * MAX_THREADS || rt % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dim) {
    case 1:
      e = launch<1>(samples, witnesses, sub_lo, sub_hi, centers, radii,
                    tile_lo, tile_hi, ub2, blk_ptr, blk_chunks, out, stats,
                    n_blk, nr, rt, bs, subs_per_chunk, s, launched);
      break;
    case 2:
      e = launch<2>(samples, witnesses, sub_lo, sub_hi, centers, radii,
                    tile_lo, tile_hi, ub2, blk_ptr, blk_chunks, out, stats,
                    n_blk, nr, rt, bs, subs_per_chunk, s, launched);
      break;
    case 3:
      e = launch<3>(samples, witnesses, sub_lo, sub_hi, centers, radii,
                    tile_lo, tile_hi, ub2, blk_ptr, blk_chunks, out, stats,
                    n_blk, nr, rt, bs, subs_per_chunk, s, launched);
      break;
    case 4:
      e = launch<4>(samples, witnesses, sub_lo, sub_hi, centers, radii,
                    tile_lo, tile_hi, ub2, blk_ptr, blk_chunks, out, stats,
                    n_blk, nr, rt, bs, subs_per_chunk, s, launched);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
