// What the flood kernels K1 (flood.cu) and K3 (flood_stats.cu) share: the
// arithmetic of every test and distance, and the staging of a sub-chunk.
// Both must compute every (sample, witness) distance the same way, so that
// K3's output equals K1's bit for bit and its computed tiles equal K1's
// admitted units; keeping the forms here makes that hold by construction.
//
// Arithmetic. The sources are built with -fmad=false: every multiply and
// add is rounded on its own, as in the plain PyTorch versions, unless an
// FMA is written out. The one FMA is in the per-pair distance, contracted
// to d2 = fma(dz, dz, fma(dy, dy, dx * dx)): 7 issued instructions per
// pair with the min (the inner loop of flood_min_kernel<3> in SASS),
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
// no barrier. Staging compacts each SEGW-witness segment: in-ball
// witnesses to the front (warp ballot + popc), out-of-ball ones (moved to
// MASK) behind them. The inner loop (min_over_staged) runs over the
// in-ball count rounded up to UNROLL, so padding slots hold out-of-ball
// witnesses, and a sub-chunk with none in the ball folds in the one value
// such a witness gives: min is exact, so the result is the min over all
// SUB witnesses bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace flood {

constexpr int SUB = 512;          // witnesses per sub-chunk
constexpr float MASK = 3e18f;     // out-of-ball witnesses move here
constexpr int SEGW = 128;         // witnesses per staging segment (4 a lane)
constexpr int NSEG = SUB / SEGW;  // segments per sub-chunk
constexpr int UNROLL = 4;         // inner-loop unroll; counts round up to it
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sq_add(float acc, float diff) {
  return __fadd_rn(acc, __fmul_rn(diff, diff));
}

__device__ __forceinline__ float comp(const float4 &v, int d) {
  return d == 0 ? v.x : d == 1 ? v.y : d == 2 ? v.z : v.w;
}

// Witness y in ball-local coordinates (y - c), and whether it lies in the
// ball (|y - c|^2 <= r2, summed in coordinate order). Components past DIM
// are 0.
template <int DIM>
__device__ __forceinline__ bool ball_local(const float *y, const float *c,
                                           float r2, float4 &yl) {
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  float y2 = 0.f;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    v[d] = __fsub_rn(y[d], c[d]);
    y2 = d == 0 ? __fmul_rn(v[d], v[d]) : sq_add(y2, v[d]);
  }
  yl = make_float4(v[0], v[1], v[2], v[3]);
  return y2 <= r2;
}

// The staged form of an out-of-ball witness.
template <int DIM>
__device__ __forceinline__ float4 masked() {
  return make_float4(MASK, DIM > 1 ? MASK : 0.f, DIM > 2 ? MASK : 0.f,
                     DIM > 3 ? MASK : 0.f);
}

// Squared distance from sample x to a staged witness y, coordinate order.
template <int DIM>
__device__ __forceinline__ float pair_d2(const float4 &y, const float *x) {
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

// Stage the sub-chunk that fetch_raw brought into `raw` into `dst` (SUB
// float4), ball-local and compacted per segment; segcnt[seg] is the
// segment's in-ball count. Readers need a barrier after it.
template <int DIM>
__device__ __forceinline__ void stage_compacted(const float *raw,
                                                const float *c, float r2,
                                                float4 *dst, int *segcnt,
                                                int warp, int nw, int lane) {
  cp_async_wait_all();
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int seg = warp; seg < NSEG; seg += nw) {
    const float *own = raw + (size_t)(seg * SEGW + 4 * lane) * DIM;
    float4 yl[4];
    bool in[4];
    int below = 0, cnt = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      in[i] = ball_local<DIM>(own + i * DIM, c, r2, yl[i]);
      const unsigned bal = __ballot_sync(FULL, in[i]);
      below += __popc(bal & lanes_below);
      cnt += __popc(bal);
    }
    float4 *seg_dst = dst + seg * SEGW;
    int nin = below, nout = 4 * lane - below;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // in-ball witnesses to the front, the others from the back
      const int pos = in[i] ? nin++ : SEGW - 1 - nout++;
      seg_dst[pos] = in[i] ? yl[i] : masked<DIM>();
    }
    if (lane == 0) segcnt[seg] = cnt;
  }
}

// acc[k] = min(acc[k], d2 from sample x[k] to every witness of a staged
// sub-chunk): the inner loop. Returns the sub-chunk's in-ball count.
template <int DIM, int SPT>
__device__ __forceinline__ int min_over_staged(const float4 *wsh,
                                               const int *segcnt,
                                               float (&x)[SPT][DIM],
                                               float (&acc)[SPT]) {
  int total = 0;
  for (int seg = 0; seg < NSEG; ++seg) {
    const int n = segcnt[seg];
    total += n;
    const int n_pad = (n + UNROLL - 1) / UNROLL * UNROLL;
    const float4 *ys = wsh + seg * SEGW;
#pragma unroll 4
    for (int w = 0; w < n_pad; ++w) {
      const float4 yv = ys[w];
#pragma unroll
      for (int k = 0; k < SPT; ++k)
        acc[k] = fminf(acc[k], pair_d2<DIM>(yv, x[k]));
    }
  }
  if (total == 0) {
    // every witness is out of the ball: they all give this value
    const float4 m = masked<DIM>();
#pragma unroll
    for (int k = 0; k < SPT; ++k)
      acc[k] = fminf(acc[k], pair_d2<DIM>(m, x[k]));
  }
  return total;
}

}  // namespace flood
