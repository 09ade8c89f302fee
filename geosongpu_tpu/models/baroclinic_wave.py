"""Jablonowski-Williamson (2006) baroclinic-wave test case.

EXTERNAL-TRUTH workload: the initial condition and the expected outcomes
come from a publication, not from this repo - Jablonowski, C. and
Williamson, D. L. (2006), "A baroclinic instability test case for
atmospheric model dynamical cores", Q. J. R. Meteorol. Soc., 132,
2943-2975 (JW06).  This is the strongest trajectory-level substitute for
the reference's Fortran-vs-port comparison
(/root/reference/src/tcn/py_ftn_interface/templates/interface.f90.jinja2:111-167)
while no recorded GEOS savepoints exist: the dycore must
(a) HOLD the analytically balanced zonal state (JW06 section 3: a good
    core keeps the steady state for tens of days; discretization error
    shows up as spurious ps drift and wave growth), and
(b) grow the overlaid perturbation into the published baroclinic wave:
    surface-pressure minimum near-unchanged through day ~4, explosive
    deepening days 7-10 (JW06 Figs. 4-7: ps_min ~994 hPa at day 6,
    ~930-970 hPa at day 9 across the four tested cores and resolutions).

The analytic state is JW06 eqs. (2)-(7): eta-coordinate zonal jets
u = u0 cos^{3/2}(eta_v) sin^2(2 phi), a horizontally varying temperature
in thermal-wind balance with them, a balancing surface geopotential, and
a Gaussian zonal-wind perturbation centered at (20E, 40N).  All constants
use THIS repo's values (grid.RADIUS/OMEGA/GRAV/RDGAS) so the balance is
with respect to our sphere, as JW06 prescribes for each tested model.

Winds are projected onto the D-grid staggered points as covariant
components in the local chart basis (u = V . e1_hat at u-points), the
same convention the halo basis rotation documents (core/grid.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import DycoreConfig
from ..core.grid import (GRAV, KAPPA, OMEGA, RADIUS, RDGAS, Grid,
                         build_grid)
from ..dycore.sw import P00
from ..core.state import DycoreState
from ..core.vertical import hybrid_coordinate, sigma_coordinate
from ..core.topology import FACE_FRAMES, face_point
from ..dycore.fv_dynamics import DycoreContext, build_context, \
    fv_dynamics_step
from .step import HoistedStep

# JW06 Table 1 parameters
ETA0 = 0.252
ETA_T = 0.2
U0 = 35.0
T0 = 288.0
GAMMA = 0.005          # lapse rate [K/m]
DELTA_T = 4.8e5        # empirical stratosphere temperature amplitude [K]
UP = 1.0               # perturbation amplitude [m/s]
PERT_LON = np.pi / 9.0     # 20 E
PERT_LAT = 2.0 * np.pi / 9.0   # 40 N
P0 = 1.0e5


def _t_mean(eta):
    """Horizontal-mean temperature profile, JW06 eqs. (4)-(5)."""
    t = T0 * eta ** (RDGAS * GAMMA / GRAV)
    return np.where(eta < ETA_T, t + DELTA_T * (ETA_T - eta) ** 5, t)


def _u_zonal(eta, lat):
    """Balanced zonal wind, JW06 eq. (2)."""
    eta_v = (eta - ETA0) * np.pi / 2.0
    return U0 * np.cos(eta_v) ** 1.5 * np.sin(2.0 * lat) ** 2


def _temperature(eta, lat):
    """Balanced temperature, JW06 eq. (6)."""
    eta_v = (eta - ETA0) * np.pi / 2.0
    a = RADIUS
    br1 = (-2.0 * np.sin(lat) ** 6 * (np.cos(lat) ** 2 + 1.0 / 3.0)
           + 10.0 / 63.0)
    br2 = (8.0 / 5.0 * np.cos(lat) ** 3 * (np.sin(lat) ** 2 + 2.0 / 3.0)
           - np.pi / 4.0)
    return (_t_mean(eta)
            + 0.75 * (eta * np.pi * U0 / RDGAS) * np.sin(eta_v)
            * np.sqrt(np.cos(eta_v))
            * (br1 * 2.0 * U0 * np.cos(eta_v) ** 1.5 + br2 * a * OMEGA))


def _phi_surface(lat):
    """Balancing surface geopotential, JW06 eq. (7)."""
    eta_vs = (1.0 - ETA0) * np.pi / 2.0
    a = RADIUS
    br1 = (-2.0 * np.sin(lat) ** 6 * (np.cos(lat) ** 2 + 1.0 / 3.0)
           + 10.0 / 63.0)
    br2 = (8.0 / 5.0 * np.cos(lat) ** 3 * (np.sin(lat) ** 2 + 2.0 / 3.0)
           - np.pi / 4.0)
    return U0 * np.cos(eta_vs) ** 1.5 * (
        br1 * U0 * np.cos(eta_vs) ** 1.5 + br2 * a * OMEGA)


def _u_perturbation(lat, lon):
    """Gaussian zonal-wind perturbation, JW06 eq. (8)."""
    rr = RADIUS / 10.0
    cosd = (np.sin(PERT_LAT) * np.sin(lat)
            + np.cos(PERT_LAT) * np.cos(lat) * np.cos(lon - PERT_LON))
    r = RADIUS * np.arccos(np.clip(cosd, -1.0, 1.0))
    return UP * np.exp(-((r / rr) ** 2))


def _basis_at(f, q):
    """Unit chart tangents (e1, e2) of face f at unit points q [..., 3]
    (same construction as core/grid.build_grid)."""
    _, a_, b_ = FACE_FRAMES[f]
    e1 = a_ - np.sum(a_ * q, -1, keepdims=True) * q
    e2 = b_ - np.sum(b_ * q, -1, keepdims=True) * q
    e1 = e1 / np.linalg.norm(e1, axis=-1, keepdims=True)
    e2 = e2 / np.linalg.norm(e2, axis=-1, keepdims=True)
    return e1, e2


def _east_north(q):
    """Unit east/north vectors at unit points q [..., 3]."""
    x, y, z = q[..., 0], q[..., 1], q[..., 2]
    lam = np.arctan2(y, x)
    phi = np.arcsin(np.clip(z, -1.0, 1.0))
    east = np.stack([-np.sin(lam), np.cos(lam),
                     np.zeros_like(lam)], axis=-1)
    north = np.stack([-np.sin(phi) * np.cos(lam),
                      -np.sin(phi) * np.sin(lam),
                      np.cos(phi)], axis=-1)
    return east, north, phi, lam


def _stag_points(n: int):
    """Unit positions of the D-grid staggered points - the TRUE flux
    points the metrics are evaluated at (geodesic edge midpoints, same
    construction as core/grid.build_grid): u-points [6, n+1, n, 3] on
    S/N cell edges and v-points [6, n, n+1, 3] on W/E edges."""
    s = np.linspace(-np.pi / 4, np.pi / 4, n + 1)
    corners = np.zeros((6, n + 1, n + 1, 3))
    for f in range(6):
        SJ, SI = np.meshgrid(s, s, indexing="ij")
        corners[f] = face_point(f, SI, SJ)
    upts = corners[:, :, :-1] + corners[:, :, 1:]
    upts /= np.linalg.norm(upts, axis=-1, keepdims=True)
    vpts = corners[:, :-1, :] + corners[:, 1:, :]
    vpts /= np.linalg.norm(vpts, axis=-1, keepdims=True)
    return upts, vpts


def jw_initial_state(config: DycoreConfig, grid: Grid, ak: np.ndarray,
                     bk: np.ndarray, perturb: bool = True) -> DycoreState:
    """Build the JW06 analytic initial state on the cubed sphere."""
    n, nz = config.npx, config.npz
    f32 = jnp.float32

    ps = np.full((6, n, n), P0)
    pe = ak[None, None, None, :] + bk[None, None, None, :] * ps[..., None]
    p_mid = 0.5 * (pe[..., 1:] + pe[..., :-1])
    eta = p_mid / P0

    # cell-center latitudes/longitudes (interior part of the padded grid)
    h = grid.h
    lat_c = np.asarray(grid.lat)[:, h:h + n, h:h + n][..., None]
    lon_c = np.asarray(grid.lon)[:, h:h + n, h:h + n][..., None]

    T = _temperature(eta, lat_c)
    # discrete Exner (same form as the dycore's _hydrostatic_fields) so
    # T = pt * pkz holds in the model's own discretization
    pk = (pe / P00) ** KAPPA
    peln = np.log(pe)
    pkz = (pk[..., 1:] - pk[..., :-1]) / (
        KAPPA * (peln[..., 1:] - peln[..., :-1]))
    pt = T / pkz

    delp = pe[..., 1:] - pe[..., :-1]

    # --- staggered winds -------------------------------------------------
    upts, vpts = _stag_points(n)

    def project(points, which):
        e1, e2 = _basis_at_points(points)
        east, north, phi, lam = _east_north(points)
        uz = _u_zonal(eta_of(points), phi[..., None])
        if perturb:
            uz = uz + _u_perturbation(phi[..., None], lam[..., None])
        # physical V = uz * east (JW06 has no meridional wind)
        tang = e1 if which == "u" else e2
        dot = np.sum(tang * east, axis=-1)[..., None]
        return uz * dot

    def _basis_at_points(points):
        e1 = np.zeros_like(points)
        e2 = np.zeros_like(points)
        for f in range(6):
            a, b = _basis_at(f, points[f])
            e1[f], e2[f] = a, b
        return e1, e2

    def eta_of(points):
        # eta depends only on the vertical (ps uniform)
        return eta[0, 0, 0][None, None, None, :]

    u = project(upts, "u")
    v = project(vpts, "v")

    phis = _phi_surface(lat_c[..., 0])

    zeros = jnp.zeros((6, n, n, nz), f32)
    q = jnp.zeros((6, n, n, nz, config.ntracers), f32)
    return DycoreState(
        u=jnp.asarray(u, f32), v=jnp.asarray(v, f32),
        delp=jnp.asarray(delp, f32), pt=jnp.asarray(pt, f32),
        q=q, w=zeros, delz=zeros,
        phis=jnp.asarray(phis, f32),
        ps=jnp.asarray(ps, f32),
        omga=zeros,
        ua=zeros, va=zeros,
        mfx=jnp.zeros((6, n, n + 1, nz), f32),
        mfy=jnp.zeros((6, n + 1, n, nz), f32),
    ), np.asarray(phis)


@dataclass(frozen=True)
class BaroclinicWaveModel:
    config: DycoreConfig
    grid: Grid
    ctx: DycoreContext
    step_fn: HoistedStep
    _init_builder: Callable

    def init(self, perturb: bool = True) -> DycoreState:
        return self._init_builder(perturb)

    def run(self, state: DycoreState, steps: int) -> DycoreState:
        """`steps` model steps as one jitted scan (HoistedStep.run)."""
        return self.step_fn.run(state, steps)

    def run_with_history(self, state: DycoreState, steps: int):
        def body(s, _):
            s2 = self.step_fn(s)
            return s2, {"ps_min": jnp.min(s2.ps),
                        "ps_max": jnp.max(s2.ps)}

        return jax.lax.scan(body, state, None, length=steps)


def build_model(config: DycoreConfig) -> BaroclinicWaveModel:
    grid = build_grid(config.npx, config.halo)
    if config.vertical == "sigma":
        ak, bk = sigma_coordinate(config.npz, config.ptop)
    else:
        ak, bk = hybrid_coordinate(config.npz, config.ptop)

    # first build once (unperturbed) for the phis that the context needs
    _, phis = jw_initial_state(config, grid, np.asarray(ak),
                               np.asarray(bk), perturb=False)
    ctx = build_context(config, grid, ak, bk, phis=phis)

    def init_builder(perturb: bool):
        st, _ = jw_initial_state(config, grid, np.asarray(ak),
                                 np.asarray(bk), perturb=perturb)
        return st

    def step(state: DycoreState, ctx_) -> DycoreState:
        from ..parallel.halo import symmetrize_shared_edges

        state = fv_dynamics_step(state, ctx_)
        if config.edge_symmetrize:
            u, v = symmetrize_shared_edges(state.u, state.v)
            state = dataclasses.replace(state, u=u, v=v)
        return state

    return BaroclinicWaveModel(
        config=config, grid=grid, ctx=ctx,
        step_fn=HoistedStep(step, ctx), _init_builder=init_builder,
    )
