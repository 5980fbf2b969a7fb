// Native CPU flood min-distance kernel.
//
// The portable XLA formulation of the masked min-reduction (ops/flood.py)
// executes at well under 1 GFLOP/s on CPU backends: the (B, R, C) masked
// select + min pipeline does not fuse, and the 1-D batch window admits
// many times the ball volume. This kernel is the CPU counterpart of the
// reference's native CPU path (reference core.py:197-199 delegates to
// scipy's C++ KDTree): per simplex it takes the sorted-axis window
// [center - r, center + r], filters witnesses by the bounding-ball test
// (reference compute_mask semantics, triton_kernels.py:99-158), and folds
// each surviving witness into the per-sample running minima with a
// SIMD-friendly inner loop over samples.
//
// Layout: samples are BALL-LOCAL and transposed (S, dim, R) so the inner
// loop vectorizes over R; witnesses are global coordinates sorted along
// `waxis` (the widest axis — reference core.py:140-144). Distances use
// the coordinate-difference form on ball-local coordinates, matching the
// XLA engine's accumulation exactly (same error model as the reference
// kernels, triton_kernels.py:37-41).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>

namespace {

template <typename T>
int64_t flood_min_dist_impl(
    int64_t n_simplices,
    int64_t n_samples,
    int64_t dim,
    int64_t n_witnesses,
    const T* samples_local,  // (S, dim, R) ball-local sample coordinates
    const T* centers,        // (S, dim)
    const T* radii,          // (S,)
    const T* witnesses,      // (W, dim) global, sorted along axis
    const T* waxis,          // (W,) the sorted coordinate
    int64_t axis,
    T* out)                  // (S, R) min distances (not squared)
{
    constexpr int64_t kMaxDim = 16;
    if (dim > kMaxDim) return -1;

    for (int64_t s = 0; s < n_simplices; ++s) {
        const T* c = centers + s * dim;
        const T r = radii[s];
        const T r2 = r * r;
        const T* x = samples_local + s * dim * n_samples;
        T* o = out + s * n_samples;
        for (int64_t j = 0; j < n_samples; ++j) {
            o[j] = std::numeric_limits<T>::infinity();
        }

        // sorted-axis window [c_axis - r, c_axis + r]
        const T* lo = std::lower_bound(waxis, waxis + n_witnesses,
                                       c[axis] - r);
        const T* hi = std::upper_bound(waxis, waxis + n_witnesses,
                                       c[axis] + r);
        const int64_t w0 = lo - waxis;
        const int64_t w1 = hi - waxis;

        for (int64_t w = w0; w < w1; ++w) {
            const T* y = witnesses + w * dim;
            // ball-local witness + mask (center-to-witness distance)
            T yl[kMaxDim];
            T y2 = 0;
            for (int64_t i = 0; i < dim; ++i) {
                yl[i] = y[i] - c[i];
                y2 += yl[i] * yl[i];
            }
            if (y2 > r2) continue;

            // fold into the per-sample running minima (vectorizes over j)
            if (dim == 2) {
                const T a0 = yl[0], a1 = yl[1];
                const T* x0 = x;
                const T* x1 = x + n_samples;
                for (int64_t j = 0; j < n_samples; ++j) {
                    const T d0 = x0[j] - a0;
                    const T d1 = x1[j] - a1;
                    const T d2 = d0 * d0 + d1 * d1;
                    o[j] = d2 < o[j] ? d2 : o[j];
                }
            } else if (dim == 3) {
                const T a0 = yl[0], a1 = yl[1], a2 = yl[2];
                const T* x0 = x;
                const T* x1 = x + n_samples;
                const T* x2 = x + 2 * n_samples;
                for (int64_t j = 0; j < n_samples; ++j) {
                    const T d0 = x0[j] - a0;
                    const T d1 = x1[j] - a1;
                    const T d2c = x2[j] - a2;
                    const T d2 = d0 * d0 + d1 * d1 + d2c * d2c;
                    o[j] = d2 < o[j] ? d2 : o[j];
                }
            } else {
                for (int64_t j = 0; j < n_samples; ++j) {
                    T d2 = 0;
                    for (int64_t i = 0; i < dim; ++i) {
                        const T d = x[i * n_samples + j] - yl[i];
                        d2 += d * d;
                    }
                    o[j] = d2 < o[j] ? d2 : o[j];
                }
            }
        }

        for (int64_t j = 0; j < n_samples; ++j) {
            o[j] = std::sqrt(o[j]);
        }
    }
    return 0;
}

}  // namespace

extern "C" {

int64_t flood_min_dist_f32(
    int64_t n_simplices, int64_t n_samples, int64_t dim,
    int64_t n_witnesses, const float* samples_local, const float* centers,
    const float* radii, const float* witnesses, const float* waxis,
    int64_t axis, float* out)
{
    return flood_min_dist_impl<float>(
        n_simplices, n_samples, dim, n_witnesses, samples_local, centers,
        radii, witnesses, waxis, axis, out);
}

int64_t flood_min_dist_f64(
    int64_t n_simplices, int64_t n_samples, int64_t dim,
    int64_t n_witnesses, const double* samples_local, const double* centers,
    const double* radii, const double* witnesses, const double* waxis,
    int64_t axis, double* out)
{
    return flood_min_dist_impl<double>(
        n_simplices, n_samples, dim, n_witnesses, samples_local, centers,
        radii, witnesses, waxis, axis, out);
}

}  // extern "C"
