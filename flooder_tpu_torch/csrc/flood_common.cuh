// Arithmetic shared by the flood kernels K1 (flood.cu) and K3
// (flood_stats.cu). Both must compute every (sample, witness) distance the
// same way, so that K3's output equals K1's bit for bit and its computed
// tiles equal K1's admitted units; keeping the forms here makes that hold
// by construction.
//
// The sources are built with -fmad=false: every multiply and add is
// rounded on its own, as in the plain PyTorch versions, unless an FMA is
// written out. The one FMA is in the per-pair distance, contracted to
// d2 = fma(dz, dz, fma(dy, dy, dx * dx)): 7 issued instructions per pair
// with the min (the inner loop of flood_min_kernel<3> in SASS), against 9
// for the separately rounded form. It moves d2 by an ulp or so from the
// plain version (3.7e-9 at most on the main path's operands, against a 1e-6
// bar); the ball, box and tile tests are not contracted, and on every input
// checked the admitted units equal the plain version's. The expanded form
// |y|^2 - 2x.y + |x|^2 is never used: in fp32 its error is about
// eps * R^2 in d2, large next to small d2
// (flooder_tpu/ops/pallas_flood.py:51-56).

#pragma once

#include <cuda_runtime.h>

namespace flood {

constexpr int SUB = 512;  // witnesses per sub-chunk
constexpr float MASK = 3e18f;  // out-of-ball witnesses move here

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

}  // namespace flood
