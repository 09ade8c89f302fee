"""External ground truth for the moist thermodynamics.

Every other physics gate in this framework compares two same-author
implementations (primaries vs physics/twins.py); this one anchors the saturation
vapor pressure - the quantity every moist process (surface evaporation,
saturation adjustment, WBF, rain evaporation) keys off - against
PUBLISHED laboratory/standard values from outside this repository:

* liquid: best-estimate values tabulated from the Sonntag (1990) /
  Murphy & Koop (2005, QJRMS 131, 1539) formulations, as reproduced in
  standard references (e.g. the WMO Guide to Meteorological Instruments,
  AMS Glossary).  Bolton (1980)'s fit (used by physics/thermo.py) is
  documented accurate to 0.1% for -30..35 C; we gate at 1%.
* ice: Goff-Gratch / Murphy-Koop values; the Tetens-type ice constants
  in thermo.esat_ice are a ~1-2% fit, gated at 2.5%.

The reference's analog is validating the ported physics against the
trusted serial Fortran (physics_standalone.py:87-146) - an independent
anchor rather than a twin.
"""
import numpy as np
import pytest

from geosongpu_tpu.physics.thermo import (EPS, esat_ice, esat_liquid,
                                          qsat)

# (T [K], es [Pa]) over LIQUID water - published best-estimate values
# (Sonntag 1990 / Murphy-Koop 2005 agree to <0.1% in this range):
#   -20 C supercooled: 125.4 Pa      0 C: 611.2 Pa
#    10 C: 1227.9 Pa                20 C: 2338.5 Pa
#    30 C: 4245.2 Pa
_LIQUID_TABLE = [
    (253.15, 125.4),
    (273.15, 611.2),
    (283.15, 1227.9),
    (293.15, 2338.5),
    (303.15, 4245.2),
]

# over ICE (Goff-Gratch / Murphy-Koop):
#   -40 C: 12.84 Pa   -30 C: 38.02 Pa   -20 C: 103.3 Pa
#   -10 C: 259.9 Pa     0 C: 611.2 Pa
_ICE_TABLE = [
    (233.15, 12.84),
    (243.15, 38.02),
    (253.15, 103.3),
    (263.15, 259.9),
    (273.15, 611.2),
]


@pytest.mark.parametrize("t,es_ref", _LIQUID_TABLE)
def test_esat_liquid_matches_published(t, es_ref):
    es = float(esat_liquid(np.float32(t)))
    assert abs(es - es_ref) / es_ref < 0.01, (t, es, es_ref)


@pytest.mark.parametrize("t,es_ref", _ICE_TABLE)
def test_esat_ice_matches_published(t, es_ref):
    es = float(esat_ice(np.float32(t)))
    assert abs(es - es_ref) / es_ref < 0.025, (t, es, es_ref)


def test_qsat_standard_point():
    """20 C at 1000 hPa: saturation mixing ratio ~14.7 g/kg (standard
    textbook value; e.g. Wallace & Hobbs Table / AMS Glossary)."""
    q = float(qsat(np.float32(293.15), np.float32(1.0e5)))
    q_ref = EPS * 2338.5 / (1.0e5 - (1.0 - EPS) * 2338.5)
    assert abs(q - 0.0147) < 0.0003, q
    assert abs(q - q_ref) / q_ref < 0.01


def test_esat_crossover_at_triple_point():
    """Liquid and ice saturation pressures must agree at the triple
    point (both ~611.7 Pa at 273.16 K) and diverge below, with
    supercooled liquid ABOVE ice everywhere (the WBF gradient)."""
    t0 = 273.16
    el = float(esat_liquid(np.float32(t0)))
    ei = float(esat_ice(np.float32(t0)))
    assert abs(el - ei) / el < 0.005
    for t in (263.15, 253.15, 243.15):
        assert float(esat_liquid(np.float32(t))) > float(
            esat_ice(np.float32(t))) * 1.05, t
