"""Tests on the card: the reference's Philox noise against kernel K1's, and
each cell's control, at the cell's own sizes, failing its limits."""

import json

import pytest
import torch

from portbench import calibrate, core
from portbench.reference.philox import normals

CELLS = [w["name"] for w in json.loads((core.CHECKOUT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("offset", [0, 4096 * 3 + 2])
def test_k1_noise_is_the_reference_philox(card, offset):
    """K1 with zero parameters, momentum and gradient, learning rate and
    momentum 0 and a noise scale of 1 leaves the momentum at its normals."""
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat

    n, seed = 1_000_003, 0x9E3779B97F4A7C15 & (2 ** 63 - 1)
    p, v, g = (torch.zeros(n, device=card) for _ in range(3))
    scalars = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0], device=card)
    sghmc_update_flat(p, v, g, scalars, torch.tensor([seed], device=card), offset)
    expected = normals(seed, offset + n, card)[offset:]
    assert torch.allclose(v, expected, rtol=1e-5, atol=1e-5)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(card, cell):
    """The reference in the precision below the configuration's, in the
    program's place, fails one of the cell's limits, and the program passes
    them all, on one seed at the cell's own sizes."""
    limits = core.Registry().json("workloads", cell)["limits"]
    (reading,) = calibrate.readings(cell, [2 ** 31 + 11])
    assert all(reading["program"][k] <= v for k, v in limits.items()), reading
    assert any(reading["control"][k] > v for k, v in limits.items()), reading
