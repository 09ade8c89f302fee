"""2-D flux-form transport operator (Lin & Rood 1996 directional splitting).

The JAX equivalent of gtFV3's FvTp2d stencil chain (the reference CI only
*configures* that external code - GTFV3_BACKEND=dace:gpu,
/root/reference/src/tcn/ci/pipeline/gtfv3_config.py:13; here we own it).

Scheme: each direction's flux is computed from the field fully advected in
the *other* direction (advective inner update), which restores the 2-D
cross terms of the splitting to 2nd order:

    q_i = inner y-advection of q   ->  fx = PPM_x(q_i) * (x mass/area flux)
    q_j = inner x-advection of q   ->  fy = PPM_y(q_j) * (y flux)

Cube-corner handling: the inner sweeps read the halo corner blocks, whose
ownership is direction-dependent (core/topology.py), so the caller passes
two padded copies of the field - `qx` (x-order corners, feeds the x inner
sweep) and `qy` (y-order corners, feeds the y inner sweep).  They differ
only on the 4 h x h corner blocks per face.

Mass consistency: when `mfx`/`mfy` (mass fluxes) are given, the returned
fluxes are PPM-value * mass-flux while the *inner updates* still use the
area fluxes - exactly FV3's recipe, which preserves q == const exactly
(PPM of a constant is the constant, so fx == mfx).

All arrays are padded [6, J, I, K]; only interior fluxes are valid (halo
width 3 is exactly sufficient, as in FV3).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from .ppm import ppm_flux

_AX_Y = 1  # j axis in [6, J, I, K]
_AX_X = 2  # i axis


class Fluxes2D(NamedTuple):
    fx: jnp.ndarray  # q-flux through W/E interfaces [6, J, I+1, K]
    fy: jnp.ndarray  # through S/N interfaces [6, J+1, I, K]


def ddx(iface: jnp.ndarray) -> jnp.ndarray:
    """Flux convergence along x: F[i] - F[i+1] per cell."""
    return iface[:, :, :-1] - iface[:, :, 1:]


def ddy(iface: jnp.ndarray) -> jnp.ndarray:
    return iface[:, :-1, :] - iface[:, 1:, :]


def fvtp2d(
    qx: jnp.ndarray,       # padded field, x-order corners [6, J, I, K]
    qy: jnp.ndarray,       # padded field, y-order corners (same off corners)
    crx: jnp.ndarray,      # Courant at x-interfaces [6, J, I+1, K]
    cry: jnp.ndarray,      # Courant at y-interfaces [6, J+1, I, K]
    xfx: jnp.ndarray,      # area flux (swept area) through x-interfaces
    yfx: jnp.ndarray,      # area flux through y-interfaces
    area: jnp.ndarray,     # padded cell areas [6, J, I] or [6, J, I, 1]
    hord: int = 8,
    mfx: Optional[jnp.ndarray] = None,  # mass flux to weight fx (default xfx)
    mfy: Optional[jnp.ndarray] = None,
    rax: Optional[jnp.ndarray] = None,  # precomputed 1/(area + ddx(xfx)):
    ray: Optional[jnp.ndarray] = None,  # shared across fields per substep
) -> Fluxes2D:
    if area.ndim == 3:
        area = area[..., None]

    # inner advective updates (full dt, mass-consistent denominator)
    fyy = ppm_flux(qy, cry, axis=_AX_Y, hord=hord) * yfx
    if ray is None:
        ray = 1.0 / (area + ddy(yfx))
    q_i = (qy * area + ddy(fyy)) * ray

    fxx = ppm_flux(qx, crx, axis=_AX_X, hord=hord) * xfx
    if rax is None:
        rax = 1.0 / (area + ddx(xfx))
    q_j = (qx * area + ddx(fxx)) * rax

    fx = ppm_flux(q_i, crx, axis=_AX_X, hord=hord) * (xfx if mfx is None else mfx)
    fy = ppm_flux(q_j, cry, axis=_AX_Y, hord=hord) * (yfx if mfy is None else mfy)
    return Fluxes2D(fx=fx, fy=fy)
