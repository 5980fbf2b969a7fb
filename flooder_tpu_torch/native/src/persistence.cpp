// Persistent homology over Z/2 by boundary-matrix reduction.
//
// Native replacement for the persistence engine the reference obtains from
// the gudhi C++ wheel (reference cli.py:471-479, tests/test_flooder.py:55-75).
// Algorithm: column reduction in filtration order with the "twist"
// optimization (process dimensions top-down) and clearing (a column whose
// index became a pivot is a birth and reduces to zero, so it is skipped).
//
// The caller (flooder_tpu/topology/persistence.py) passes the boundary
// matrix as CSR over simplices already sorted by (filtration, dimension),
// so faces always precede cofaces.
//
// Build: see flooder_tpu/native/build.py (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

using Col = std::vector<int64_t>;

// Symmetric difference of two sorted columns (Z/2 column addition).
inline void add_into(const Col &a, const Col &b, Col &out) {
  out.clear();
  size_t i = 0, j = 0;
  while (i < a.size() && j < b.size()) {
    if (a[i] < b[j]) {
      out.push_back(a[i++]);
    } else if (a[i] > b[j]) {
      out.push_back(b[j++]);
    } else {
      ++i;
      ++j;
    }
  }
  while (i < a.size()) out.push_back(a[i++]);
  while (j < b.size()) out.push_back(b[j++]);
}

}  // namespace

extern "C" {

// Reduce the boundary matrix of a filtered complex.
//
//   n           number of simplices (columns), in filtration order
//   dims[i]     dimension of simplex i
//   offsets     CSR offsets (n+1) into `indices`
//   indices     facet ids of each simplex (any order within a column)
//   out_pairs   capacity 2*n int64: flattened (birth, death) pairs
//   out_ess     capacity n int64: essential (never-paired) simplex ids
//   out_counts  [0] = number of pairs, [1] = number of essentials
//
// Returns 0 on success.
int64_t flood_reduce(int64_t n, const int8_t *dims, const int64_t *offsets,
                     const int64_t *indices, int64_t *out_pairs,
                     int64_t *out_ess, int64_t *out_counts) {
  if (n == 0) {
    out_counts[0] = 0;
    out_counts[1] = 0;
    return 0;
  }

  int8_t maxdim = 0;
  for (int64_t i = 0; i < n; ++i)
    if (dims[i] > maxdim) maxdim = dims[i];

  // Column ids per dimension, in filtration order.
  std::vector<std::vector<int64_t>> by_dim(maxdim + 1);
  for (int64_t i = 0; i < n; ++i) by_dim[dims[i]].push_back(i);

  std::vector<int64_t> low_inv(n, -1);     // pivot row -> reduced column id
  std::vector<uint8_t> cleared(n, 0);      // birth columns known to vanish
  std::vector<uint8_t> is_death(n, 0);
  std::vector<Col> reduced(n);             // stored only for pivot columns

  int64_t npairs = 0;
  Col col, tmp;

  for (int d = maxdim; d >= 1; --d) {
    for (int64_t j : by_dim[d]) {
      if (cleared[j]) continue;
      col.assign(indices + offsets[j], indices + offsets[j + 1]);
      std::sort(col.begin(), col.end());
      while (!col.empty()) {
        int64_t low = col.back();
        int64_t k = low_inv[low];
        if (k < 0) break;
        add_into(col, reduced[k], tmp);
        col.swap(tmp);
      }
      if (!col.empty()) {
        int64_t low = col.back();
        low_inv[low] = j;
        cleared[low] = 1;  // clearing: `low` is a birth of dim d-1
        is_death[j] = 1;
        reduced[j].swap(col);
        out_pairs[2 * npairs] = low;
        out_pairs[2 * npairs + 1] = j;
        ++npairs;
      }
    }
  }

  int64_t ness = 0;
  for (int64_t i = 0; i < n; ++i) {
    bool is_birth = low_inv[i] >= 0 ? false : cleared[i];
    // births: pivots (cleared); deaths: is_death. Everything else essential.
    if (!cleared[i] && !is_death[i]) out_ess[ness++] = i;
    (void)is_birth;
  }

  out_counts[0] = npairs;
  out_counts[1] = ness;
  return 0;
}
}
