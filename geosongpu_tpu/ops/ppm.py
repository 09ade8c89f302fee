"""Piecewise-parabolic (PPM) finite-volume reconstruction & fluxes.

JAX replacement for the GT4Py/DaCe stencils of the external gtFV3
dycore the reference CI drives (SURVEY.md SS0; backend config
/root/reference/src/tcn/ci/pipeline/gtfv3_config.py:9-13).  Everything here
is pure jnp on *padded* arrays [6, J, I, K] (layout: face, y, x, vertical;
K minor so horizontal stencils vectorize across whole (x, K) tiles and XLA
fuses the shifts into one pass - no scalar loops, no dynamic shapes).

Conventions
-----------
* `hord=6`: unlimited 4th-order interface PPM (fast, for smooth fields).
* `hord=8`: monotone PPM (Colella-Woodward constraint, Lin 2004 flavor) -
  the default for tracers, mirroring gtFV3's monotone transport.
* Interface arrays have length N+1 along the flux axis; interface `i` sits
  between cells `i-1` and `i`.  Values are valid where the 2-cell-each-side
  stencil fits (interfaces [2, N-2] for edges, [3, N-3] for fluxes);
  outside, entries are finite junk that callers slice away - with halo
  width 3 the valid span is exactly the interior interfaces plus what the
  Lin-Rood inner update needs.
* Courant numbers are in upwind-cell grid units: c[i] = u[i] dt / dx_upwind.
"""
from __future__ import annotations

import jax.numpy as jnp


def _shift(a: jnp.ndarray, k: int, axis: int) -> jnp.ndarray:
    """a[i+k] along `axis` with edge replication (finite junk at borders)."""
    n = a.shape[axis]
    idx = [slice(None)] * a.ndim
    if k == 0:
        return a
    if k > 0:
        idx[axis] = slice(k, n)
        core = a[tuple(idx)]
        idx[axis] = slice(n - 1, n)
        pad = jnp.concatenate([a[tuple(idx)]] * k, axis=axis) if k > 1 else a[tuple(idx)]
        return jnp.concatenate([core, pad], axis=axis)
    k = -k
    idx[axis] = slice(0, n - k)
    core = a[tuple(idx)]
    idx[axis] = slice(0, 1)
    pad = jnp.concatenate([a[tuple(idx)]] * k, axis=axis) if k > 1 else a[tuple(idx)]
    return jnp.concatenate([pad, core], axis=axis)


def _edges_ord4(q: jnp.ndarray, axis: int) -> jnp.ndarray:
    """4th-order interface estimate al[i] = value at the left edge of cell i:
    al = 7/12 (q[i-1] + q[i]) - 1/12 (q[i-2] + q[i+1])."""
    qm1 = _shift(q, -1, axis)
    qm2 = _shift(q, -2, axis)
    qp1 = _shift(q, +1, axis)
    return (7.0 / 12.0) * (qm1 + q) - (1.0 / 12.0) * (qm2 + qp1)


def _ppm_coeffs(q: jnp.ndarray, axis: int, hord: int):
    """Per-cell parabola: left/right edge values aL, aR (with optional
    monotonic limiting) and curvature a6 = 6 (q - (aL+aR)/2)."""
    al = _edges_ord4(q, axis)
    aL = al
    aR = _shift(al, +1, axis)
    if hord == 8:
        # Colella-Woodward monotonicity
        extremum = (aR - q) * (q - aL) <= 0.0
        aL = jnp.where(extremum, q, aL)
        aR = jnp.where(extremum, q, aR)
        da = aR - aL
        a6 = 6.0 * (q - 0.5 * (aL + aR))
        aL = jnp.where(a6 * da > da * da, 3.0 * q - 2.0 * aR, aL)
        da = aR - aL
        a6 = 6.0 * (q - 0.5 * (aL + aR))
        aR = jnp.where(a6 * da < -da * da, 3.0 * q - 2.0 * aL, aR)
    a6 = 6.0 * (q - 0.5 * (aL + aR))
    return aL, aR, a6


def ppm_flux(q: jnp.ndarray, c: jnp.ndarray, axis: int, hord: int = 8) -> jnp.ndarray:
    """Upwind PPM interface value (time-averaged over the swept distance).

    q: padded cell means, length N along `axis`.
    c: Courant numbers at interfaces, length N+1 along `axis`.
    Returns the flux-mean value q_f at interfaces (length N+1); multiply by
    the interface mass/area flux to get a flux.
    """
    aL, aR, a6 = _ppm_coeffs(q, axis, hord)

    def iface(cell_arr, side):
        """cell array -> interface array: side='L' takes cell i-1, 'R' cell i."""
        n = cell_arr.shape[axis]
        idx = [slice(None)] * cell_arr.ndim
        if side == "L":
            idx[axis] = slice(0, 1)
            first = cell_arr[tuple(idx)]
            return jnp.concatenate([first, cell_arr], axis=axis)
        idx[axis] = slice(n - 1, n)
        last = cell_arr[tuple(idx)]
        return jnp.concatenate([cell_arr, last], axis=axis)

    # left (upwind for c>0) cell i-1 quantities at interface i
    aR_l = iface(aR, "L")
    daL = iface(aR - aL, "L")
    a6L = iface(a6, "L")
    # right (upwind for c<0) cell i quantities
    aL_r = iface(aL, "R")
    daR = iface(aR - aL, "R")
    a6R = iface(a6, "R")

    cpos = jnp.maximum(c, 0.0)
    cneg = jnp.maximum(-c, 0.0)
    f_pos = aR_l - 0.5 * cpos * (daL - (1.0 - (2.0 / 3.0) * cpos) * a6L)
    f_neg = aL_r + 0.5 * cneg * (daR + (1.0 - (2.0 / 3.0) * cneg) * a6R)
    return jnp.where(c >= 0.0, f_pos, f_neg)


def upwind_flux(q: jnp.ndarray, c: jnp.ndarray, axis: int) -> jnp.ndarray:
    """1st-order upwind interface value (used by the C-grid half step)."""

    def iface(cell_arr, side):
        n = cell_arr.shape[axis]
        idx = [slice(None)] * cell_arr.ndim
        if side == "L":
            idx[axis] = slice(0, 1)
            return jnp.concatenate([cell_arr[tuple(idx)], cell_arr], axis=axis)
        idx[axis] = slice(n - 1, n)
        return jnp.concatenate([cell_arr, cell_arr[tuple(idx)]], axis=axis)

    return jnp.where(c >= 0.0, iface(q, "L"), iface(q, "R"))
