"""The port's host topology layer against flooder_tpu.topology: Delaunay
complexes, monotonicity repair and persistence diagrams on random 2-D and
3-D clouds, and the native reduction against its plain version."""

import numpy as np
import pytest

from flooder_tpu.topology import DelaunayComplex as DelaunayJ
from flooder_tpu_torch.native import build
from flooder_tpu_torch.topology import DelaunayComplex as DelaunayT
from flooder_tpu_torch.topology import SimplexTree
from flooder_tpu_torch.topology import simplex_tree as st_mod
from flooder_tpu_torch.topology.persistence import (
    _reduce_py,
    reduce_filtration,
)

# 6-D and 9-D: the face lattice of high-dimensional cells (every face
# level derived from the one above)
CLOUDS = [(2, 60, 0), (2, 150, 1), (3, 80, 2), (3, 140, 3), (6, 24, 4),
          (9, 16, 5)]


def _trees(dim, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, dim))
    tj = DelaunayJ(pts).create_simplex_tree()
    tt = DelaunayT(pts).create_simplex_tree()
    # the same random filtration on both, then the monotonicity repair
    for d in range(len(tj._verts)):
        vals = rng.random(tj._verts[d].shape[0])
        tj.assign_filtrations(d, tj._verts[d], vals)
        tt.assign_filtrations(d, tt._verts[d], vals)
    return tj, tt


@pytest.mark.parametrize("dim,n,seed", CLOUDS)
def test_delaunay_and_monotonicity_match(dim, n, seed):
    tj, tt = _trees(dim, n, seed)
    assert len(tj._verts) == len(tt._verts) == dim + 1
    for vj, vt in zip(tj._verts, tt._verts):
        np.testing.assert_array_equal(vt, vj)
    assert tt.make_filtration_non_decreasing() == (
        tj.make_filtration_non_decreasing()
    )
    for fj, ft in zip(tj._filt, tt._filt):
        np.testing.assert_array_equal(ft, fj)


@pytest.mark.parametrize("dim,n,seed", CLOUDS)
def test_persistence_diagrams_match(dim, n, seed):
    tj, tt = _trees(dim, n, seed)
    tj.make_filtration_non_decreasing()
    tt.make_filtration_non_decreasing()
    tj.compute_persistence()
    tt.compute_persistence()
    for d in range(dim + 1):
        a = tj.persistence_intervals_in_dimension(d)
        b = tt.persistence_intervals_in_dimension(d)
        np.testing.assert_array_equal(
            b[np.lexsort(b.T[::-1])], a[np.lexsort(a.T[::-1])]
        )
    assert tt.betti_numbers() == tj.betti_numbers()
    assert tt.persistence() == tj.persistence()


@pytest.mark.parametrize("dim,n,seed", CLOUDS[1:])
def test_native_reduction_equals_plain(dim, n, seed, monkeypatch):
    seen = []

    def record(dims, offsets, indices):
        seen.append((dims.copy(), offsets.copy(), indices.copy()))
        return reduce_filtration(dims, offsets, indices)

    monkeypatch.setattr(st_mod, "reduce_filtration", record)
    _, tt = _trees(dim, n, seed)
    tt.make_filtration_non_decreasing()
    tt.compute_persistence()
    (dims, offsets, indices), = seen
    pairs_n, ess_n = reduce_filtration(dims, offsets, indices)
    pairs_p, ess_p = _reduce_py(dims, offsets, indices)
    assert len(pairs_n) > 0
    assert sorted(map(tuple, pairs_n.tolist())) == sorted(
        map(tuple, pairs_p.tolist())
    )
    assert sorted(ess_n.tolist()) == sorted(ess_p.tolist())


def test_native_library_built_from_own_source():
    lib = build.load_persistence()
    pkg = build.PKG_DIR
    assert build.PERSISTENCE_SRC == pkg / "native" / "src" / "persistence.cpp"
    assert lib._name == str(build.PERSISTENCE_LIB)
    assert build.PERSISTENCE_LIB.parent == build.BUILD_DIR
    assert "flooder_tpu_torch" in build.BUILD_DIR.parts
    assert (
        build.PERSISTENCE_LIB.stat().st_mtime
        >= build.PERSISTENCE_SRC.stat().st_mtime
    )


def test_empty_and_insert_api():
    st = SimplexTree()
    st.insert([0, 1, 2], 1.0)
    st.assign_filtration([0, 1], 0.5)
    assert st.num_simplices() == 7
    assert st.filtration([0, 1]) == 0.5
    st.compute_persistence()
    assert st.betti_numbers()[0] == 1
