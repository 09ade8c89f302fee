"""Nonhydrostatic vertical acoustic solver (FV3 riem_solver analog).

The reference's dycore contract carries `w` and `delz` for the
nonhydrostatic core (/root/reference/src/tcn/py_ftn_interface/example_def_dycore.yaml:49-51);
the solver itself lives in the external gtFV3.  This is the JAX
equivalent of that vertically-implicit "Riemann solver": it advances the
vertically-propagating acoustic/buoyancy dynamics of each column with a
backward-Euler (theta=1) scheme, which reduces to one tridiagonal solve
per column - a pair of `lax.scan`s over K, vectorized across all columns.

Column model (TOA -> surface index order, rigid lid and ground):
  interfaces carry w [.., K+1] (w[0] = w[K] = 0), layers carry
  delz > 0 (geometric thickness), delp (fixed mass), pt.
  p_k   = full gas-law pressure  rho R T = (delp/(g delz)) R T
  p'_k  = p_k - p_hydro_k        (nonhydrostatic perturbation)
  dw/dt|_iface = -g [p'_k - p'_{k-1}] / (rho_bar dz_bar g)  (pressure form)
  d(delz)/dt|_layer = w_iface_above - w_iface_below

Linearizing p(delz) with the adiabatic bulk modulus (dp/d delz =
-gamma p/delz) and eliminating delz^{n+1} yields the tridiagonal system in
w^{n+1} solved below (Thomas algorithm).  Implicit => unconditionally
stable for vertical sound waves, the property the FV3 scheme exists for.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.grid import GRAV, RDGAS, KAPPA
from ..ops.vertical import interfaces_from_delp

GAMMA = 1.0 / (1.0 - KAPPA)  # cp/cv


def _thomas(a, b, c, d):
    """Tridiagonal solve along the last axis (vectorized Thomas).

    a: sub-diagonal [.., M] (a[...,0] unused), b: diagonal [.., M],
    c: super-diagonal (c[...,-1] unused), d: rhs [.., M].
    """
    M = b.shape[-1]

    def fwd(carry, idx):
        cp_prev, dp_prev = carry
        ai = a[..., idx]
        bi = b[..., idx]
        ci = c[..., idx]
        di = d[..., idx]
        denom = bi - ai * cp_prev
        cp = ci / denom
        dp = (di - ai * dp_prev) / denom
        return (cp, dp), (cp, dp)

    init = (jnp.zeros_like(b[..., 0]), jnp.zeros_like(b[..., 0]))
    _, (cps, dps) = jax.lax.scan(fwd, init, jnp.arange(M))
    cps = jnp.moveaxis(cps, 0, -1)
    dps = jnp.moveaxis(dps, 0, -1)

    def bwd(carry, idx):
        x_next = carry
        x = dps[..., idx] - cps[..., idx] * x_next
        return x, x

    _, xs = jax.lax.scan(bwd, jnp.zeros_like(b[..., 0]),
                         jnp.arange(M - 1, -1, -1))
    xs = jnp.moveaxis(xs, 0, -1)[..., ::-1]
    return xs


def full_pressure(delp, delz, pt, ptop):
    """Gas-law pressure per layer from mass, thickness, and temperature
    (T = pt * pkz with pkz from the hydrostatic pe - adequate lineariz.)."""
    pe = interfaces_from_delp(delp, ptop)
    pk = (pe / 1.0e5) ** KAPPA
    peln = jnp.log(pe)
    pkz = (pk[..., 1:] - pk[..., :-1]) / (KAPPA * (peln[..., 1:] - peln[..., :-1]))
    t = pt * pkz
    rho = delp / (GRAV * jnp.maximum(delz, 1.0))
    p_full = rho * RDGAS * t
    p_mid_hydro = 0.5 * (pe[..., 1:] + pe[..., :-1])
    return p_full, p_mid_hydro, t


def vertical_acoustic_solve(w, delz, pt, delp, dt: float, ptop: float,
                            n_iter: int = 2
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One implicit vertical acoustic step (n_iter Newton linearizations).

    w:    [.., K+1] interface vertical velocity (w[...,0] and w[...,K]
          boundary values are overwritten with 0: rigid lid/ground)
    delz: [.., K] layer thickness (> 0)
    Returns (w', delz')."""
    w_in0 = w[..., 1:-1]
    zeros = jnp.zeros_like(w[..., :1])
    # Gas-law pressure at the substep-start thickness: the Newton anchor.
    # Re-evaluations during the iteration follow the ADIABAT through that
    # anchor, p*(z) = p0 (z0/z)^gamma, so the slope used in the matrix
    # (s = gamma p*/z*) is the true derivative dp*/d(delz) and the fixed
    # point is the adiabatic backward-Euler solution.  (Re-evaluating the
    # gas law with temperature frozen at the hydrostatic Exner would make
    # p* ~ 1/z* - an isothermal stiffness, ~18% slow sound speed.)
    p0, p_hyd, _t = full_pressure(delp, delz, pt, ptop)
    delz0 = jnp.maximum(delz, 1.0)
    z_star = delz
    w_new = w.at[..., 0].set(0.0).at[..., -1].set(0.0)  # n_iter=0: no-op
    for _ in range(n_iter):
        # linearize p'(delz) around z_star:
        #   p'_k(delz) ~= p*_k - s*_k (delz - z*_k),  s* = gamma p*/z* > 0
        # with delz_k^{n+1} = delz_k^n + dt (w_{i=k} - w_{i=k+1})
        # (i = k is the top interface of layer k)
        zs = jnp.maximum(z_star, 1.0)
        p_star = p0 * (delz0 / zs) ** GAMMA
        ptil = p_star - p_hyd - GAMMA * p_star / zs * (delz - z_star)
        rho = delp / (GRAV * zs)
        # interface means (interior interfaces 1..K-1)
        rho_i = 0.5 * (rho[..., :-1] + rho[..., 1:])
        dz_i = 0.5 * (z_star[..., :-1] + z_star[..., 1:])
        s = GAMMA * p_star / zs

        # tridiagonal for interior interface w (M = K-1 unknowns):
        # w_i - w_i^n = (dt/(rho_i dz_i)) [ p'_below - p'_above ]@n+1
        alpha = dt / (rho_i * dz_i)           # [.., K-1] at interior ifaces
        dt_s_up = dt * s[..., :-1]            # layer above iface i
        dt_s_dn = dt * s[..., 1:]             # layer below
        b = 1.0 + alpha * (dt_s_up + dt_s_dn)
        a = -alpha * dt_s_up                  # couples to w_{i-1}
        c = -alpha * dt_s_dn                  # couples to w_{i+1}
        # excess pressure in the layer below an interface pushes it up:
        rhs = w_in0 + alpha * (ptil[..., 1:] - ptil[..., :-1])
        x = _thomas(a, b, c, rhs)
        w_new = jnp.concatenate([zeros, x, zeros], axis=-1)
        z_star = delz + dt * (w_new[..., :-1] - w_new[..., 1:])

    return w_new, z_star


def hydrostatic_delz(delp, pt, ptop):
    """The delz profile in exact discrete hydrostatic balance (p' == 0):
    rho R T = p_mid  =>  delz = delp R T / (g p_mid)."""
    pe = interfaces_from_delp(delp, ptop)
    pk = (pe / 1.0e5) ** KAPPA
    peln = jnp.log(pe)
    pkz = (pk[..., 1:] - pk[..., :-1]) / (KAPPA * (peln[..., 1:] - peln[..., :-1]))
    t = pt * pkz
    p_mid = 0.5 * (pe[..., 1:] + pe[..., :-1])
    return delp * RDGAS * t / (GRAV * p_mid)
