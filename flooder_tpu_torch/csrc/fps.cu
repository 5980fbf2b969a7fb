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
// steps, and each step is two launches (update, select) of a few
// microseconds of work, so launch latency sets the time, not bytes or
// operations (the chunk skip already makes the streamed bytes small).
// The design keeps the whole loop on the device with no host round trip:
// the host function below enqueues all 2(L-1) launches back to back on the
// caller's stream, counts them for the caller, and the selected index
// travels through device memory.
// Fusing the loop into one cooperative kernel or a CUDA graph is left for
// a later change.
//
// Arithmetic: every square and sum is an explicitly rounded multiply and
// add (no FMA contraction), so the box bound is a true lower bound of the
// computed point distances and results equal the plain PyTorch version's.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_DIM = 8;
constexpr int UPDATE_THREADS = 512;
constexpr int SELECT_THREADS = 1024;

// (value, index) max with the lower index winning a tie
__device__ __forceinline__ void argmax_combine(float &v, int &i, float v2,
                                               int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void block_argmax(float &v, int &i, float *sv,
                                             int *si) {
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    float v2 = __shfl_down_sync(full, v, off);
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
    v = lane < nwarps ? sv[lane] : -CUDART_INF_F;
    i = lane < nwarps ? si[lane] : INT32_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      float v2 = __shfl_down_sync(full, v, off);
      int i2 = __shfl_down_sync(full, i, off);
      argmax_combine(v, i, v2, i2);
    }
  }
}

// One block per chunk: fold the current landmark into the chunk if its
// box can lower it, and refresh the chunk's max/argmax.
__global__ void __launch_bounds__(UPDATE_THREADS)
    fps_update(const float *__restrict__ pts,  // (dim, npad) sorted cloud
               int dim, int npad, int chunk,
               const float *__restrict__ box_lo,  // (dim, nchunks)
               const float *__restrict__ box_hi, int nchunks,
               float *__restrict__ mind2,  // (npad,) running min d^2
               float *__restrict__ cmax,   // (nchunks,)
               int *__restrict__ cbest,    // (nchunks,) sorted index
               const int *__restrict__ cur,  // (1,) current landmark
               unsigned long long *__restrict__ visits) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const int c = blockIdx.x;
  const int lmi = *cur;
  float lm[MAX_DIM];
  float lb2 = 0.f;
#pragma unroll
  for (int d = 0; d < MAX_DIM; ++d) {
    if (d < dim) {
      lm[d] = pts[(size_t)d * npad + lmi];
      float g = fmaxf(fmaxf(__fsub_rn(box_lo[d * nchunks + c], lm[d]),
                            __fsub_rn(lm[d], box_hi[d * nchunks + c])),
                      0.f);
      lb2 = __fadd_rn(lb2, __fmul_rn(g, g));
    }
  }
  // strict <: when the bound equals the chunk max no member can drop
  if (!(lb2 < cmax[c])) return;  // uniform over the block

  float best = -CUDART_INF_F;
  int bidx = INT32_MAX;
  const int base = c * chunk;
  for (int j = threadIdx.x; j < chunk; j += blockDim.x) {
    const int i = base + j;
    float d2 = 0.f;
#pragma unroll
    for (int d = 0; d < MAX_DIM; ++d) {
      if (d < dim) {
        float diff = __fsub_rn(pts[(size_t)d * npad + i], lm[d]);
        d2 = d == 0 ? __fmul_rn(diff, diff)
                    : __fadd_rn(d2, __fmul_rn(diff, diff));
      }
    }
    const float m = fminf(mind2[i], d2);
    mind2[i] = m;
    if (m > best) {  // indices grow within a thread: first max kept
      best = m;
      bidx = i;
    }
  }
  block_argmax(best, bidx, sv, si);
  if (threadIdx.x == 0) {
    cmax[c] = best;
    cbest[c] = bidx;
    atomicAdd(visits, 1ull);  // instrumentation: chunk visits
  }
}

// One block: global argmax over the chunk maxima (lowest chunk on a tie,
// and each chunk's argmax is its lowest lane), record it, make it current.
__global__ void __launch_bounds__(SELECT_THREADS)
    fps_select(const float *__restrict__ cmax, const int *__restrict__ cbest,
               int nchunks, int step, int *__restrict__ out,
               int *__restrict__ cur) {
  __shared__ float sv[32];
  __shared__ int si[32];
  float best = -CUDART_INF_F;
  int bc = INT32_MAX;
  for (int c = threadIdx.x; c < nchunks; c += blockDim.x) {
    argmax_combine(best, bc, cmax[c], c);
  }
  block_argmax(best, bc, sv, si);
  if (threadIdx.x == 0) {
    const int idx = cbest[bc];
    out[step] = idx;
    *cur = idx;
  }
}

}  // namespace

extern "C" {

const char *flooder_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Run steps 1..n_samples-1 of the greedy loop on `stream`. The caller has
// set mind2 = cmax = +inf, out[0] = *cur = the sorted start index and
// *visits = 0. *launched is set to the number of kernel launches that were
// enqueued without error. Returns 0 or the first CUDA launch error.
int fps_run(const float *pts, int dim, int npad, int chunk,
            const float *box_lo, const float *box_hi, int nchunks,
            float *mind2, float *cmax, int *cbest, int *cur, int *out,
            int n_samples, unsigned long long *visits, void *stream,
            long long *launched) {
  *launched = 0;
  if (dim < 1 || dim > MAX_DIM) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int step = 1; step < n_samples; ++step) {
    fps_update<<<nchunks, UPDATE_THREADS, 0, s>>>(
        pts, dim, npad, chunk, box_lo, box_hi, nchunks, mind2, cmax, cbest,
        cur, visits);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launched;
    fps_select<<<1, SELECT_THREADS, 0, s>>>(cmax, cbest, nchunks, step, out,
                                            cur);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launched;
  }
  return 0;
}

}  // extern "C"
