// Exact greedy farthest-point sampling on Hopper (kernel K2 of the port).
//
// Replaces the Pallas TPU kernel flooder_tpu/ops/pallas_fps.py:66
// (`_fps_kernel`, launched by `_fps_call` at :219). It computes the same
// thing: over a Hilbert-sorted cloud cut into chunks of CHUNK points with
// bounding boxes, keep a running min d^2 per point and a max/argmax per
// chunk; each step folds the current landmark into the chunks it can lower
// (box lower bound^2 strictly below the chunk max, pallas_fps.py:147),
// then takes the global argmax with ties going to the lowest chunk, then
// the lowest lane (pallas_fps.py:176-205), i.e. the lowest sorted index.
//
// What bounds it on the card: the L-1 steps form a chain of dependent
// steps of a few microseconds of work each (the box skip leaves some ten
// chunks of the 1M cloud's 123 to fold per step), so the cost of getting
// from one step to the next sets the time, not bytes or operations. The
// design runs the whole loop as ONE persistent cooperative kernel: CTA g
// owns chunks g, g+G, ... (G co-resident CTAs, from the occupancy query),
// keeps its first chunk's running min d^2 and, up to 5 coordinates (in
// float), its points in shared memory, and per step folds the landmark into
// its chunks that pass the box test, publishes its chunks' (max, argmax) in
// one of two exchange buffers chosen by step parity, and meets the other
// CTAs at one grid barrier. After the barrier every CTA reduces all
// candidates with the same tie rule, so all agree on the next landmark
// without a second barrier; CTA 0 records it. The barrier is an arrival
// counter in device memory; a cooperative launch guarantees that every CTA
// is resident, and the launch fails (the caller raises) when the grid
// cannot be. What is left per step is a chain of device-memory round trips
// (the landmark's coordinates, the barrier's counter, the candidates) and
// block reductions, not work. The kernel is compiled per coordinate count,
// so a fold issues no instruction for absent coordinates, and per scalar
// type: float and double clouds of 1-8 coordinates. The double instance
// keeps the same loop, tie rule and skips; it caches its first chunk's
// points in shared memory only where they fit the same byte budget
// (MAX_CACHED_BYTES), i.e. up to 2 coordinates.
//
// Past 8 coordinates, one runtime-width instance per scalar type
// (fps_loop<T, WIDE>, `a.dim` coordinates): the same launch, loop, skip and
// tie rule, with the landmark's coordinates in shared memory (one more
// barrier a step) and every point read from device memory (an 8192-point
// chunk of 64 coordinates is 2 MB: no cache). Its folds stream the chunk's
// dim x 8192 coordinates, so past a few coordinates a visited chunk costs
// bytes more than the step's round trips.

// Arithmetic: every square and sum is an explicitly rounded multiply and
// add (no FMA contraction), so the box bound is a true lower bound of the
// computed point distances and results equal the plain PyTorch version's,
// in either type.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_DIM = 8;  // the widest fixed-width instance
constexpr int WIDE = 0;     // DIM of the runtime-width instance
constexpr int THREADS = 1024;
// A barrier wait that sees no progress for this many polls (seconds)
// traps instead of hanging the card.
constexpr unsigned long long SPIN_LIMIT = 1ull << 24;

// Explicitly rounded arithmetic and limits in either scalar type.
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float min_of(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double min_of(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float max_of(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double max_of(double a, double b) {
  return fmax(a, b);
}
template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() {
  return CUDART_INF_F;
}
template <>
__device__ __forceinline__ double pos_inf<double>() {
  return CUDART_INF;
}

// (value, index) max with the lower index winning a tie
template <typename T>
__device__ __forceinline__ void argmax_combine(T &v, int &i, T v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Block-wide argmax; thread 0 gets the result. Ends in a barrier, so the
// scratch may be reused right after.
template <typename T>
__device__ __forceinline__ void block_argmax(T &v, int &i, T *sv, int *si) {
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    T v2 = __shfl_down_sync(full, v, off);
    int i2 = __shfl_down_sync(full, i, off);
    argmax_combine(v, i, v2, i2);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    v = lane < nwarps ? sv[lane] : -pos_inf<T>();
    i = lane < nwarps ? si[lane] : INT32_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      T v2 = __shfl_down_sync(full, v, off);
      int i2 = __shfl_down_sync(full, i, off);
      argmax_combine(v, i, v2, i2);
    }
  }
  __syncthreads();
}

// Grid barrier over the CTAs of one cooperative launch: every CTA adds 1
// to a 64-bit arrival counter with release semantics and waits until it
// reaches `target` (G x the barrier's ordinal) with acquire semantics, as
// CUTLASS's GenericBarrier does. Writes before it are visible after it.
__device__ __forceinline__ void grid_sync(unsigned long long *bar,
                                          unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(bar)
                 : "memory");
    unsigned long long seen, polls = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                   : "=l"(seen)
                   : "l"(bar)
                   : "memory");
      if (++polls == SPIN_LIMIT) __trap();
    } while (seen < target);
  }
  __syncthreads();
}

// The kernel's operands (one struct, so that the cooperative launch passes
// one argument); T is the cloud's scalar type.
template <typename T>
struct FpsArgs {
  const T *pts;     // (dim, npad) sorted cloud
  int npad, chunk;
  const T *box_lo;  // (dim, nchunks)
  const T *box_hi;
  int nchunks;
  T *mind2;         // (npad,) running min d^2, +inf
  T *cmax;          // (nchunks,) chunk max, +inf
  int *cbest;       // (nchunks,) chunk argmax
  T *xv;            // (2, nchunks) exchange: max
  int *xi;          // (2, nchunks) exchange: argmax
  int *out;         // (n_samples,); out[0] = start
  int n_samples;
  unsigned long long *visits;
  unsigned long long *bar;  // (1,) zero
  int dim;                  // coordinates (read by the WIDE instance)
};

// Dynamic shared memory: the running min d^2 of the CTA's first chunk and,
// where the points and mins take at most MAX_CACHED_BYTES a point, that
// chunk's points (one CTA of THREADS fills an SM, so the SM's shared memory
// is the CTA's to use): float up to 5 coordinates, double up to 2, 192 KB
// a CTA at most. The WIDE instance keeps the landmark's `dim` coordinates
// after the mins instead.
constexpr int MAX_CACHED_BYTES = 24;

template <typename T, int DIM>
__host__ __device__ constexpr bool cached() {
  return DIM != WIDE && (DIM + 1) * sizeof(T) <= MAX_CACHED_BYTES;
}

template <typename T, int DIM>
size_t smem_bytes(int chunk, int dim) {
  return (size_t)chunk * sizeof(T) * (cached<T, DIM>() ? DIM + 1 : 1) +
         (DIM == WIDE ? (size_t)dim * sizeof(T) : 0);
}

// The squared lower bound of the distances from landmark lm to chunk c's
// box (the skip test), coordinate by coordinate.
template <typename T, int DIM>
__device__ __forceinline__ T box_lb2(const FpsArgs<T> &a, int c,
                                     const T *lm) {
  T lb2 = 0;
  auto term = [&](int d) {
    const T gd = max_of(
        max_of(sub_rn(__ldg(a.box_lo + d * a.nchunks + c), lm[d]),
               sub_rn(lm[d], __ldg(a.box_hi + d * a.nchunks + c))),
        T(0));
    lb2 = add_rn(lb2, mul_rn(gd, gd));
  };
  if constexpr (DIM == WIDE) {
    for (int d = 0; d < a.dim; ++d) term(d);
  } else {
#pragma unroll
    for (int d = 0; d < DIM; ++d) term(d);
  }
  return lb2;
}

// Fold the landmark into one chunk: points p[d * stride + j], running
// mins m[j], j < chunk; returns the chunk's (max, argmax) to thread 0.
template <typename T, int DIM>
__device__ __forceinline__ void fold(const T *p, int stride, T *m, int chunk,
                                     int base, const T *lm, int dim, T &best,
                                     int &bidx, T *sv, int *si) {
  best = -pos_inf<T>();
  bidx = INT32_MAX;
#pragma unroll 4
  for (int j = threadIdx.x; j < chunk; j += THREADS) {
    const T d0 = sub_rn(p[j], lm[0]);
    T d2 = mul_rn(d0, d0);
    if constexpr (DIM == WIDE) {
      for (int d = 1; d < dim; ++d) {
        const T diff = sub_rn(p[(size_t)d * stride + j], lm[d]);
        d2 = add_rn(d2, mul_rn(diff, diff));
      }
    } else {
#pragma unroll
      for (int d = 1; d < DIM; ++d) {
        const T diff = sub_rn(p[d * stride + j], lm[d]);
        d2 = add_rn(d2, mul_rn(diff, diff));
      }
    }
    const T mm = min_of(m[j], d2);
    m[j] = mm;
    if (mm > best) {  // indices grow within a thread: first max kept
      best = mm;
      bidx = base + j;
    }
  }
  block_argmax(best, bidx, sv, si);
}

template <typename T, int DIM>
__global__ void __launch_bounds__(THREADS) fps_loop(const FpsArgs<T> a) {
  constexpr bool CACHED = cached<T, DIM>();
  extern __shared__ __align__(16) unsigned char dyn_bytes[];
  T *mloc = reinterpret_cast<T *>(dyn_bytes);  // running min d^2 of chunk g
  T *ploc = mloc + a.chunk;  // its points, (DIM, chunk), if CACHED
  T *lm_sh = mloc + a.chunk;  // the landmark, (dim,), if WIDE
  __shared__ T sv[32];
  __shared__ int si[32];
  __shared__ int s_next;
  const int G = gridDim.x, g = blockIdx.x, tid = threadIdx.x;
  const T *own = a.pts + (size_t)g * a.chunk;
  for (int j = tid; j < a.chunk; j += THREADS) {
    mloc[j] = pos_inf<T>();
    if (CACHED) {
#pragma unroll
      for (int d = 0; d < DIM; ++d)
        ploc[d * a.chunk + j] = own[(size_t)d * a.npad + j];
    }
  }
  __syncthreads();

  unsigned long long visits = 0;  // thread 0's count of chunk visits
  int cur = a.out[0];
  for (int step = 1; step < a.n_samples; ++step) {
    T lm_reg[DIM == WIDE ? 1 : DIM];
    const T *lm = lm_reg;
    if constexpr (DIM == WIDE) {
      // lm_sh's readers of the last step are past its barriers
      for (int d = tid; d < a.dim; d += THREADS)
        lm_sh[d] = __ldg(a.pts + (size_t)d * a.npad + cur);
      __syncthreads();
      lm = lm_sh;
    } else {
#pragma unroll
      for (int d = 0; d < DIM; ++d)
        lm_reg[d] = __ldg(a.pts + (size_t)d * a.npad + cur);
    }
    const int par = step & 1;

    for (int c = g; c < a.nchunks; c += G) {
      const T lb2 = box_lb2<T, DIM>(a, c, lm);
      // this CTA alone writes cmax[c] / cbest[c] (thread 0, before a
      // barrier)
      T cm = __ldcg(a.cmax + c);
      int cb = __ldcg(a.cbest + c);
      // strict <: when the bound equals the chunk max no member can drop
      if (lb2 < cm) {  // uniform over the block
        const int base = c * a.chunk;
        T best;
        int bidx;
        if (c == g && CACHED)
          fold<T, DIM>(ploc, a.chunk, mloc, a.chunk, base, lm, a.dim, best,
                       bidx, sv, si);
        else if (c == g)
          fold<T, DIM>(own, a.npad, mloc, a.chunk, base, lm, a.dim, best,
                       bidx, sv, si);
        else
          fold<T, DIM>(a.pts + base, a.npad, a.mind2 + base, a.chunk, base,
                       lm, a.dim, best, bidx, sv, si);
        if (tid == 0) {
          cm = best;
          cb = bidx;
          a.cmax[c] = cm;
          a.cbest[c] = cb;
          ++visits;
        }
      }
      if (tid == 0) {
        __stcg(a.xv + par * a.nchunks + c, cm);
        __stcg(a.xi + par * a.nchunks + c, cb);
      }
    }

    grid_sync(a.bar, (unsigned long long)step * G);

    // every CTA: global argmax over the chunk maxima. A chunk's argmax is
    // its lowest lane and chunks hold increasing sorted indices, so the
    // lowest index on a tie is the lowest chunk, then the lowest lane.
    T best = -pos_inf<T>();
    int bidx = INT32_MAX;
    for (int c = tid; c < a.nchunks; c += THREADS)
      argmax_combine(best, bidx, __ldcg(a.xv + par * a.nchunks + c),
                     __ldcg(a.xi + par * a.nchunks + c));
    block_argmax(best, bidx, sv, si);
    if (tid == 0) {
      s_next = bidx;
      if (g == 0) a.out[step] = bidx;
    }
    __syncthreads();
    cur = s_next;
  }
  if (tid == 0 && visits) atomicAdd(a.visits, visits);  // instrumentation
}

// SMs x resident CTAs per SM for fps_loop<T, DIM> at `dim` coordinates
// (occupancy query, with the shared memory of that width).
template <typename T, int DIM>
cudaError_t coresident(int chunk, int dim, int *ctas) {
  int dev, sms, per_sm, coop;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fps_loop<T, DIM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<T, DIM>(chunk, dim));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fps_loop<T, DIM>, THREADS, smem_bytes<T, DIM>(chunk, dim));
  if (e == cudaSuccess) *ctas = sms * per_sm;
  return e;
}

template <typename T, int DIM>
cudaError_t run(FpsArgs<T> a, cudaStream_t stream, long long *launched) {
  int ctas = 0;
  cudaError_t e = coresident<T, DIM>(a.chunk, a.dim, &ctas);
  if (e != cudaSuccess) return e;
  if (ctas < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int G = a.nchunks < ctas ? a.nchunks : ctas;
  void *args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void *>(fps_loop<T, DIM>),
                                  dim3(G), dim3(THREADS), args,
                                  smem_bytes<T, DIM>(a.chunk, a.dim),
                                  stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

// The instance for `dim` coordinates: fixed-width up to MAX_DIM, WIDE past.
template <typename T>
struct ByDim {
  using CoresidentFn = cudaError_t (*)(int, int, int *);
  using RunFn = cudaError_t (*)(FpsArgs<T>, cudaStream_t, long long *);
  static constexpr CoresidentFn CORESIDENT[MAX_DIM + 1] = {
      coresident<T, WIDE>, coresident<T, 1>, coresident<T, 2>,
      coresident<T, 3>,    coresident<T, 4>, coresident<T, 5>,
      coresident<T, 6>,    coresident<T, 7>, coresident<T, 8>};
  static constexpr RunFn RUN[MAX_DIM + 1] = {
      run<T, WIDE>, run<T, 1>, run<T, 2>, run<T, 3>, run<T, 4>,
      run<T, 5>,    run<T, 6>, run<T, 7>, run<T, 8>};
  static int index(int dim) { return dim > MAX_DIM ? 0 : dim; }
};

template <typename T>
cudaError_t run_typed(const void *pts, int dim, int npad, int chunk,
                      const void *box_lo, const void *box_hi, int nchunks,
                      void *mind2, void *cmax, int *cbest, void *xv, int *xi,
                      int *out, int n_samples, unsigned long long *visits,
                      unsigned long long *bar, cudaStream_t stream,
                      long long *launched) {
  const FpsArgs<T> a{static_cast<const T *>(pts),
                     npad,
                     chunk,
                     static_cast<const T *>(box_lo),
                     static_cast<const T *>(box_hi),
                     nchunks,
                     static_cast<T *>(mind2),
                     static_cast<T *>(cmax),
                     cbest,
                     static_cast<T *>(xv),
                     xi,
                     out,
                     n_samples,
                     visits,
                     bar,
                     dim};
  return ByDim<T>::RUN[ByDim<T>::index(dim)](a, stream, launched);
}

}  // namespace

extern "C" {

const char *flooder_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The number of K2 CTAs the current device holds at once for `dim`
// coordinates (at least 1) of a float (`is_double` 0) or double (1) cloud
// and chunks of `chunk` points: SMs x resident blocks per SM (occupancy
// query, with that width's shared memory). Returns 0 or the CUDA error.
int fps_coresident_ctas(int dim, int is_double, int chunk, int *ctas) {
  *ctas = 0;
  if (dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      is_double
          ? ByDim<double>::CORESIDENT[ByDim<double>::index(dim)](chunk, dim,
                                                                 ctas)
          : ByDim<float>::CORESIDENT[ByDim<float>::index(dim)](chunk, dim,
                                                               ctas));
}

// Run steps 1..n_samples-1 of the greedy loop on `stream` as one
// cooperative launch of min(nchunks, co-resident CTAs) CTAs, for `dim`
// coordinates (at least 1; past MAX_DIM the WIDE instance). The point,
// box, running-min and exchange-max buffers are float (`is_double` 0) or
// double (1). The caller has set mind2 = cmax = +inf, out[0] = the sorted
// start index, *visits = 0 and *bar = 0. *launched is set to the number of
// kernel launches enqueued without error (0 for one sample). Returns 0 or
// the CUDA error; a grid that cannot be co-resident is an error, never run
// another way.
int fps_run(const void *pts, int dim, int is_double, int npad, int chunk,
            const void *box_lo, const void *box_hi, int nchunks, void *mind2,
            void *cmax, int *cbest, void *xv, int *xi, int *out,
            int n_samples, unsigned long long *visits,
            unsigned long long *bar, void *stream, long long *launched) {
  *launched = 0;
  if (dim < 1 || nchunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_samples < 2) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_double
          ? run_typed<double>(pts, dim, npad, chunk, box_lo, box_hi, nchunks,
                              mind2, cmax, cbest, xv, xi, out, n_samples,
                              visits, bar, st, launched)
          : run_typed<float>(pts, dim, npad, chunk, box_lo, box_hi, nchunks,
                             mind2, cmax, cbest, xv, xi, out, n_samples,
                             visits, bar, st, launched));
}

}  // extern "C"
