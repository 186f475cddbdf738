"""ADC energy model: the paper's Sec. VI system-level analysis.

A mixed-signal converter's power grows exponentially with its bit
precision (about 2^b) and linearly with its gain.  This module gives the
paper's comparison with Rekhi et al. [6]: at iso-accuracy on ResNet50,
ABFP at tile 128, gain 8 and 8 output bits against Rekhi's 12.5 ADC bits
at tile 8:

    energy ratio = 2^(12.5 - 8) / 8  ~= 2.83x less ADC energy
    throughput   = 128 / 8           =  16x   more MACs per cycle

Plain Python arithmetic, the JAX package's ``core/energy.py`` value for
value; nothing here touches a device.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AmsDesignPoint:
    """One AMS hardware design point of the Sec. VI energy accounting."""

    tile_width: int        # n: MACs per analog clock (dot-product length)
    adc_bits: float        # b_Y
    gain: float = 1.0


def adc_energy(point: AmsDesignPoint) -> float:
    """Relative ADC energy per conversion: 2^b * G (arbitrary units)."""
    return (2.0 ** point.adc_bits) * point.gain


def energy_per_mac(point: AmsDesignPoint) -> float:
    """One ADC conversion serves an n-long dot product."""
    return adc_energy(point) / point.tile_width


def energy_ratio(a: AmsDesignPoint, b: AmsDesignPoint) -> float:
    """ADC energy of design a relative to design b, per conversion (the
    paper's Sec. VI accounting)."""
    return adc_energy(a) / adc_energy(b)


def macs_per_cycle_ratio(a: AmsDesignPoint, b: AmsDesignPoint) -> float:
    """Throughput of design a over design b (MACs per analog clock)."""
    return a.tile_width / b.tile_width


REKHI_RESNET50 = AmsDesignPoint(tile_width=8, adc_bits=12.5, gain=1.0)
ABFP_RESNET50 = AmsDesignPoint(tile_width=128, adc_bits=8.0, gain=8.0)


def paper_section6_comparison() -> dict:
    """The paper's headline numbers: about 2.8x less ADC energy and 16x
    the MACs per cycle."""
    return {
        "adc_energy_reduction": energy_ratio(REKHI_RESNET50, ABFP_RESNET50),
        "macs_per_cycle_gain": macs_per_cycle_ratio(ABFP_RESNET50,
                                                    REKHI_RESNET50),
    }
