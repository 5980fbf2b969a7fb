"""Random mode at 600 samples a simplex, 5 patches of 128 in every pass:
the program held against ``RandomIntervals``, the plain reference, from
the host seed the harness gives it, and not from another seed. The same
check at 16 samples, one patch, is in ``test_fbench_reference.py``."""

import json

import numpy as np

from conftest import BENCH
from fbench import compare, generators, reference


def test_random_mode_in_patches_agrees_from_the_host_seed():
    import flooder_tpu_torch
    from flooder_tpu_torch.ops import cuda_flood

    num_rand = 600
    assert cuda_flood._tile_geometry(num_rand, 3)[:2] == (128, 5)
    cfg = json.loads((BENCH / "configs" / "cheese3d-10M-L1k-r20k.json")
                     .read_text())
    cfg["n_points"] = 2500
    cloud = generators.make_cloud(cfg, 2**31 + 5, 1, "cpu")
    sampling = {"mode": "random", "num_rand": num_rand, "host_seed": 4242}
    np.random.seed(4242)
    st = flooder_tpu_torch.flood_complex(
        cloud, 30, num_rand=num_rand, max_dimension=3,
        return_simplex_tree=True, device="cpu")
    values = {tuple(v): f for v, f in st.get_simplices()}
    ref = compare.ReferenceComplex(cloud, 30)
    assert ref.match(set(values)) == 0
    every = sorted(values)

    def worst(samp):
        bounds = reference.intervals(cloud, ref.landmarks, ref.cells,
                                     ref.levels, samp).values(every)
        return max(compare.relative_gap(values[s], lo, hi)
                   for s, (lo, hi) in zip(every, bounds))

    assert worst(sampling) <= compare.LIMITS["filtration_gap"]
    assert worst(dict(sampling, host_seed=4243)) > 3 * compare.LIMITS[
        "filtration_gap"]
