"""The port's generators are bit-identical to flooder_tpu's for a seed."""

import numpy as np
import pytest
import torch

import flooder_tpu as fj
import flooder_tpu_torch as ft

CASES = [
    ("generate_figure_eight_points_2d", dict(n=700, noise_std=0.01)),
    ("generate_figure_eight_points_2d",
     dict(n=300, noise_std=0.02, noise_kind="uniform")),
    ("generate_annulus_points_2d", dict(n=500, width=0.3)),
    ("generate_noisy_torus_points_3d", dict(n=800)),
    ("generate_swiss_cheese_points", dict(n=900, k=4)),
    ("generate_swiss_cheese_points",
     dict(n=400, rect_min=(0.0, 0.0), rect_max=(2.0, 1.0), k=2)),
]


@pytest.mark.parametrize("seed", [1, 42])
@pytest.mark.parametrize("name,kwargs", CASES)
def test_generators_bit_identical(name, kwargs, seed):
    want = getattr(fj, name)(seed=seed, **kwargs)
    got = getattr(ft, name)(seed=seed, device="cpu", **kwargs)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_grid_and_uniform_weights_identical():
    from flooder_tpu import core as core_j
    from flooder_tpu_torch import core as core_t

    for n, dim in [(10, 3), (12, 2), (5, 1)]:
        gj, vj, fj_ = core_j.generate_grid(n, dim)
        gt, vt, ft_ = core_t.generate_grid(n, dim, device="cpu")
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
        for a, b in zip(vj + fj_, vt + ft_):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for dim in (0, 2, 3):
        np.random.seed(5)
        wj = np.asarray(core_j.generate_uniform_weights(64, dim))
        np.random.seed(5)
        wt = core_t.generate_uniform_weights(64, dim, device="cpu").numpy()
        np.testing.assert_array_equal(wt, wj)
