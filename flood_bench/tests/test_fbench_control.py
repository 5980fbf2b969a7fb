"""The control (the reference in bfloat16, in the program's place) fails
the comparison, where the program passes it, on the same clouds."""

import json

import numpy as np
import pytest

from conftest import BENCH
from fbench import compare, control, generators


@pytest.mark.parametrize("name", ["cheese3d-10M-L1k", "eight2d-40M-L2k"])
def test_the_control_fails_where_the_program_passes(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["n_points"] = 4000
    cloud = generators.make_cloud(cfg, 2**31 + 19, 1, "cpu")
    got = control.control_readings(cloud, 40, {"mode": "grid",
                                               "points_per_edge": 8}, 8,
                                   np.random.default_rng(1))
    assert got["filtration_gap"] > 3 * compare.LIMITS["filtration_gap"]
    assert not compare.verdict(dict(got, bad_answers=0))
