"""Moist thermodynamics helpers shared by the column kernels.

Standard formulations (Tetens/Bolton saturation vapor pressure, latent
heats); everything elementwise jnp so XLA fuses it into the kernels.
"""
from __future__ import annotations

import jax.numpy as jnp

RDGAS = 287.04
RVGAS = 461.50
EPS = RDGAS / RVGAS          # 0.622
CP_AIR = 1004.64
GRAV = 9.80665
HLV = 2.501e6                # latent heat vaporization [J/kg]
HLS = 2.836e6                # sublimation
T_ICE = 273.16


def esat_liquid(t: jnp.ndarray) -> jnp.ndarray:
    """Saturation vapor pressure over liquid [Pa] (Bolton 1980)."""
    tc = t - T_ICE
    return 611.2 * jnp.exp(17.67 * tc / (tc + 243.5))


def esat_ice(t: jnp.ndarray) -> jnp.ndarray:
    """Over ice (Murphy-Koop simplified)."""
    tc = t - T_ICE
    return 611.2 * jnp.exp(21.87 * tc / (tc + 265.5))


def qsat(t: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Saturation mixing ratio over liquid [kg/kg]."""
    es = esat_liquid(t)
    es = jnp.minimum(es, 0.9 * p)
    return EPS * es / (p - (1.0 - EPS) * es)


def qsat_ice(t: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    es = esat_ice(t)
    es = jnp.minimum(es, 0.9 * p)
    return EPS * es / (p - (1.0 - EPS) * es)


def dqsat_dt(t: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """d(qsat)/dT via Clausius-Clapeyron."""
    return qsat(t, p) * HLV / (RVGAS * t * t)


def t_virtual(t: jnp.ndarray, qv: jnp.ndarray,
              q_cond: jnp.ndarray | float = 0.0) -> jnp.ndarray:
    return t * (1.0 + (1.0 / EPS - 1.0) * qv - q_cond)
