"""The port's ADC energy model (``repro_torch.core.energy``, the paper's
Sec. VI accounting) against the JAX package's ``repro.core.energy``: every
function equal, as floats, on a grid of design points, the paper's two
ResNet50 design points and ``paper_section6_comparison()``."""

import dataclasses
import itertools

import pytest
import torch

from repro.core import energy as J
from repro_torch.core import energy as T

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

GRID = list(itertools.product((1, 8, 32, 128), (4.0, 8.0, 12.5),
                              (1.0, 2.5, 8.0)))


def _points(tile, bits, gain):
    return (T.AmsDesignPoint(tile_width=tile, adc_bits=bits, gain=gain),
            J.AmsDesignPoint(tile_width=tile, adc_bits=bits, gain=gain))


@pytest.mark.parametrize("tile,bits,gain", GRID)
def test_functions_equal_jax(tile, bits, gain):
    t, j = _points(tile, bits, gain)
    assert T.adc_energy(t) == J.adc_energy(j)
    assert T.energy_per_mac(t) == J.energy_per_mac(j)
    rt, rj = _points(8, 12.5, 1.0)
    assert T.energy_ratio(t, rt) == J.energy_ratio(j, rj)
    assert T.energy_ratio(rt, t) == J.energy_ratio(rj, j)
    assert T.macs_per_cycle_ratio(t, rt) == J.macs_per_cycle_ratio(j, rj)


def test_design_points_and_section6_equal_jax():
    assert (dataclasses.astuple(T.REKHI_RESNET50)
            == dataclasses.astuple(J.REKHI_RESNET50))
    assert (dataclasses.astuple(T.ABFP_RESNET50)
            == dataclasses.astuple(J.ABFP_RESNET50))
    got, want = T.paper_section6_comparison(), J.paper_section6_comparison()
    assert got == want
    assert got["macs_per_cycle_gain"] == 16.0
    assert abs(got["adc_energy_reduction"] - 2 ** 4.5 / 8) < 1e-12
    assert [f.name for f in dataclasses.fields(T.AmsDesignPoint)] == \
        [f.name for f in dataclasses.fields(J.AmsDesignPoint)]


def test_exported_from_core_as_in_the_jax_package():
    import repro.core
    import repro_torch.core
    assert repro_torch.core.energy is T and repro.core.energy is J
    with pytest.raises(dataclasses.FrozenInstanceError):
        T.ABFP_RESNET50.gain = 1.0
