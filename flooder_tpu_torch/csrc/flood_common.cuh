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
// no barrier. A staged witness is one float4 up to 4 coordinates and two
// (Staged8) for 5-8, with the components past DIM at 0; the template
// instances take 1-8 coordinates. Staging compacts each
// SEGW-witness segment: in-ball witnesses to the front (warp ballot +
// popc), out-of-ball ones (moved to MASK) behind them. The inner loop
// (min_over_staged) runs over the in-ball count rounded up to UNROLL, so
// padding slots hold out-of-ball witnesses, and a sub-chunk with none in
// the ball folds in the one value such a witness gives: min is exact, so
// the result is the min over all SUB witnesses bit for bit.
//
// Runtime width (9 and more coordinates; the *_wide forms at the end). A
// sample's or witness's coordinates no longer fit in registers, so a unit's
// witnesses are staged ball-local into dynamic shared memory, indexed by
// coordinate ((dim, piece) floats), in pieces of `piece` witnesses that fit
// beside the kernel's other buffers (wide_piece; the sub-chunk of SUB stays
// the unit of admission and counting). Samples are read from device memory
// in a coordinate-major copy, (S, NR, dim, RT), so that a warp's loads of
// one coordinate are contiguous; a tile's samples stay in L1 across a
// unit. Each thread keeps SPT samples x WIDE_W witnesses of partial sums in
// registers and walks the coordinates once for them. Every pair's d2 is
// summed in coordinate order with separately rounded operations, as the
// plain versions do (no FMA), so the wide instances equal their plain
// versions bit for bit, and K3's wide instance equals K1's.

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
// The wide instances sum the same terms in the same order with the same
// rounding as the plain versions (cuda_flood.py, cuda_flood_stats.py), so a
// masked d2 is the plain version's value bit for bit: finite (>= 8.1e37)
// up to 37 coordinates, and +inf from 38 on, where 38 * 9e36 passes
// FLT_MAX. Both sides then act alike on it: a unit with no in-ball witness
// folds in +inf (fminf leaves acc as it was, torch.minimum too); a tile
// whose samples met no in-ball witness keeps acc = +inf, so its max is
// +inf and the tile bound min(+inf, ub2) is ub2 on both sides; and the
// callers' _inf_masked maps every d2 >= 1e30, finite or not, to +inf.

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
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int seg = warp; seg < NSEG; seg += nw) {
    const float *own = raw + (size_t)(seg * SEGW + 4 * lane) * DIM;
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
    Staged<DIM> *seg_dst = dst + seg * SEGW;
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
__device__ __forceinline__ int min_over_staged(const Staged<DIM> *wsh,
                                               const int *segcnt,
                                               float (&x)[SPT][DIM],
                                               float (&acc)[SPT]) {
  int total = 0;
  for (int seg = 0; seg < NSEG; ++seg) {
    const int n = segcnt[seg];
    total += n;
    const int n_pad = (n + UNROLL - 1) / UNROLL * UNROLL;
    const Staged<DIM> *ys = wsh + seg * SEGW;
#pragma unroll 4
    for (int w = 0; w < n_pad; ++w) {
      const Staged<DIM> yv = ys[w];
#pragma unroll
      for (int k = 0; k < SPT; ++k)
        acc[k] = fminf(acc[k], pair_d2<DIM>(yv, x[k]));
    }
  }
  if (total == 0) {
    // every witness is out of the ball: they all give this value
    const Staged<DIM> m = masked<DIM>();
#pragma unroll
    for (int k = 0; k < SPT; ++k)
      acc[k] = fminf(acc[k], pair_d2<DIM>(m, x[k]));
  }
  return total;
}

// ---------------------------------------------------------------------------
// Runtime width: the forms of the wide instances (9 and more coordinates)
// ---------------------------------------------------------------------------

constexpr int WIDE_W = 8;  // witnesses a thread sums at once (register tile)
// Bytes of a staged piece that wide_piece aims at: 8 CTAs of 128 threads
// fill an SM, and 8 such pieces fit in its 228 KB of shared memory.
constexpr int WIDE_PIECE_BYTES = 24 * 1024;

// Witnesses staged at once at `dim` coordinates: a multiple of WIDE_W, at
// most SUB and at least WIDE_W (the CTA's shared memory then caps dim).
__host__ __device__ constexpr int wide_piece(int dim) {
  const int fit = WIDE_PIECE_BYTES / (4 * dim) / WIDE_W * WIDE_W;
  return fit < WIDE_W ? WIDE_W : fit > SUB ? SUB : fit;
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

// Stage witnesses [p0, p0 + n) of sub-chunk `sub` (n a multiple of WIDE_W)
// into ws, (dim, piece) floats: ball-local, the in-ball ones at the front
// and the out-of-ball ones, moved to MASK, at the back, so the slots from
// the in-ball count up to n hold masked witnesses. cnt[0] and cnt[1] count
// the front and the back and must be 0 on entry; the order within each part
// is arbitrary, which min does not see. Readers need a barrier after it.
__device__ __forceinline__ void stage_wide(const float *witnesses, int sub,
                                           int p0, int n, const float *c,
                                           float r2, int dim, float *ws,
                                           int piece, int *cnt) {
  for (int w = threadIdx.x; w < n; w += blockDim.x) {
    const float *y = witnesses + ((size_t)sub * SUB + p0 + w) * dim;
    float y2 = 0.f;
    for (int d = 0; d < dim; ++d) y2 = sq_add(y2, __fsub_rn(y[d], c[d]));
    const bool in = y2 <= r2;
    const int pos =
        in ? atomicAdd(&cnt[0], 1) : n - 1 - atomicAdd(&cnt[1], 1);
    for (int d = 0; d < dim; ++d)
      ws[(size_t)d * piece + pos] = in ? __fsub_rn(y[d], c[d]) : MASK;
  }
}

// acc[k] = min(acc[k], d2 from sample k to each of the first m_pad staged
// witnesses, m_pad a multiple of WIDE_W): xt[d * rt + j] is coordinate d of
// the tile's sample j, and this thread's samples are j = threadIdx.x +
// k * blockDim.x. Each d2 is summed in coordinate order, separately rounded.
template <int SPT>
__device__ __forceinline__ void min_over_piece_wide(
    const float *ws, int piece, int m_pad, const float *__restrict__ xt,
    int rt, int dim, float (&acc)[SPT]) {
  const int j0 = threadIdx.x, T = blockDim.x;
  for (int w0 = 0; w0 < m_pad; w0 += WIDE_W) {
    float d2[SPT][WIDE_W];
#pragma unroll
    for (int k = 0; k < SPT; ++k)
#pragma unroll
      for (int i = 0; i < WIDE_W; ++i) d2[k][i] = 0.f;
    for (int d = 0; d < dim; ++d) {
      const float4 *yv =
          reinterpret_cast<const float4 *>(ws + (size_t)d * piece + w0);
      const float4 ya = yv[0], yb = yv[1];
      const float y[WIDE_W] = {ya.x, ya.y, ya.z, ya.w,
                               yb.x, yb.y, yb.z, yb.w};
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const float x = __ldg(xt + (size_t)d * rt + j0 + k * T);
#pragma unroll
        for (int i = 0; i < WIDE_W; ++i)
          d2[k][i] = sq_add(d2[k][i], __fsub_rn(y[i], x));
      }
    }
#pragma unroll
    for (int k = 0; k < SPT; ++k)
#pragma unroll
      for (int i = 0; i < WIDE_W; ++i) acc[k] = fminf(acc[k], d2[k][i]);
  }
}

// Fold in the value every out-of-ball witness gives (a unit with no in-ball
// witness): the sum over d of (MASK - x[d])^2, in coordinate order.
template <int SPT>
__device__ __forceinline__ void fold_masked_wide(const float *__restrict__ xt,
                                                 int rt, int dim,
                                                 float (&acc)[SPT]) {
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const float *x = xt + threadIdx.x + k * blockDim.x;
    float m2 = 0.f;
    for (int d = 0; d < dim; ++d)
      m2 = sq_add(m2, __fsub_rn(MASK, __ldg(x + (size_t)d * rt)));
    acc[k] = fminf(acc[k], m2);
  }
}

}  // namespace flood
