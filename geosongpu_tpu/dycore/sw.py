"""C/D-grid finite-volume layer dynamics (the shallow-water core).

JAX re-design of the gtFV3 c_sw/d_sw pair the reference CI exists to
validate (SURVEY.md SS0; state contract
/root/reference/src/tcn/py_ftn_interface/example_def_dycore.yaml:46-70).

One acoustic substep is the Lin-Rood two-grid scheme:

  c_sw (dt/2, C-grid): interpolate D-winds to C-grid normal winds; advance
      delp/pt a half step with 1st-order upwind fluxes; update the C-grid
      winds with vorticity, kinetic-energy and hydrostatic-PGF terms - all
      *compact* on the C-grid (cell-center gradients straddle interfaces).
      Result: time-centered advective winds uc*, vc*.

  d_sw (dt, D-grid): monotone-PPM mass/pt/tracer fluxes with Lin-Rood 2-D
      inner updates, driven by uc*/vc*; vector-invariant D-grid wind update
      where the transverse advective wind sits exactly *at* the D-point
      (vc* lives on y-interfaces = u-points), KE at corners from the
      centered winds, hydrostatic PGF from the *updated* delp/pt (the
      backward half of the forward-backward gravity-wave coupling), and
      2nd-order divergence damping on the corner-dual divergence.

Deviations from FV3 (round 1, documented): vorticity lives at cell centers
(primal circulation; validated in tests/test_halo_ops.py); its flux is
PPM-upwinded with the advective winds (essential: 2-pt averaging is
nonlinearly unstable after ~10 simulated days of eddy growth).  Advective
winds and fluxes use the full non-orthogonal metric (normal projection
with cosa/sina); the *momentum* update's KE term still uses the
locally-orthogonal approximation.

Everything is elementwise/stencil math on [6, J, I, K] padded arrays that
XLA fuses; the halo gathers at the top of the substep are the only
non-local ops.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..core.grid import CP_AIR, GRAV, KAPPA, RDGAS, Grid
from ..ops.fvtp2d import ddx, ddy, fvtp2d
from ..ops.ppm import ppm_flux, upwind_flux
from ..core.topology import NFACES
from ..parallel.halo import HaloOps
from ..ops.vertical import interfaces_from_delp, rcumsum_k

P00 = 1.0e5


class PaddedMetrics(NamedTuple):
    """Device-resident padded grid arrays used every substep.

    Reciprocals (r*) are precomputed: dividing a [*, K] field by a
    [*, 1] metric broadcasts into a full-size divide (several times the
    cost of a multiply)."""

    area: jnp.ndarray    # [6, N, N, 1]
    rarea: jnp.ndarray
    dx: jnp.ndarray      # [6, N+1, N, 1] x-edge lengths (u-point rows)
    dy: jnp.ndarray      # [6, N, N+1, 1]
    dxc: jnp.ndarray     # [6, N, N+1, 1] center dist across x-interfaces
    dyc: jnp.ndarray     # [6, N+1, N, 1]
    fcor: jnp.ndarray    # [6, N, N, 1] Coriolis at centers
    rarea_c: jnp.ndarray  # [6, N+1, N+1, 1] 1/(dual corner-cell area)
    cosa_i: jnp.ndarray  # [6, N, N+1, 1] axis-angle cos at x-interfaces
    rsina_i: jnp.ndarray
    cosa_j: jnp.ndarray  # [6, N+1, N, 1] at y-interfaces
    rsina_j: jnp.ndarray
    rdx: jnp.ndarray     # 1/dx
    rdy: jnp.ndarray
    rdxc: jnp.ndarray
    rdyc: jnp.ndarray
    cosa_c: jnp.ndarray   # [6, N, N, 1] center non-orthogonality
    rsin2_c: jnp.ndarray
    cosa_cn: jnp.ndarray  # [6, N+1, N+1, 1] corner non-orthogonality
    rsin2_cn: jnp.ndarray
    phis: jnp.ndarray     # [6, N, N, 1] surface geopotential (terrain)
    # geometry-exact center->corner interpolation (grid.corner_dw): weight
    # deltas w_k - 1/4 of the min-norm linear-exact interpolation of the 4
    # surrounding centers onto the TRUE corner point.  Applied as
    #   avg4 + sum_k dw_k (a_k - avg4)
    # which is bit-exactly avg4 on uniform fields (well-balancedness
    # preserved) and linear-exact otherwise - zero in the symmetric face
    # interior, O(1) across face-edge metric kinks and at the 8 three-cell
    # cube corners (FV3's one-sided a2b/fill_corners role as static data)
    dw00: jnp.ndarray     # [6, N+1, N+1, 1] delta for cell (j-1, i-1)
    dw01: jnp.ndarray
    dw10: jnp.ndarray
    dw11: jnp.ndarray
    # halo wind-basis correction (grid.dr11...): halo cells store the
    # neighbor's relabeled covariant components; stencils averaging them
    # with interior values mix bases across the face-edge kink (measured
    # 0.4-2.5 m/s C-grid wind error on the balanced jet; the dominant
    # face-edge imbalance).  Applied once on the A-grid winds as
    #   ua += dr11 ua + r12 va ;  va += r21 ua + dr22 va
    # (identity deltas are exact zeros in the interior -> interior values
    # bit-preserved).  FV3's d2a2c_vect Cartesian edge treatment, as four
    # static fields.
    dr11: jnp.ndarray     # [6, N, N, 1]
    r12: jnp.ndarray
    r21: jnp.ndarray
    dr22: jnp.ndarray
    # halo A-grid resampling deltas (grid.jwm...): re-attach rotated halo
    # samples to OUR extended-chart gridpoints (they sit shifted along the
    # edge otherwise - an O(1) mass-flux-divergence error at edge cells)
    jwm: jnp.ndarray      # [6, N, N, 1]
    jwp: jnp.ndarray
    iwm: jnp.ndarray
    iwp: jnp.ndarray
    # extended-chart center spacings (grid.dxc_c): reciprocals, for the
    # C-grid gradients of chart-resampled fields; == rdxc/rdyc interior
    rdxc_c: jnp.ndarray   # [6, N, N+1, 1]
    rdyc_c: jnp.ndarray   # [6, N+1, N, 1]
    # damping-divergence blend mask [6, N+1, N+1, 1] (1.0 on the face-edge
    # corner rows/cols and cube-corner disks): the raw corner-dual contour
    # reads staggered halos whose samples sit at the neighbor's shifted
    # positions in the neighbor's basis - a smooth solid-body flow shows
    # ~2e-4 1/s spurious divergence there (5 orders above interior).
    # Inside the mask the operator blends to the corner-interpolated
    # (corner_dw, linear-exact) cell divergence of the chart-consistent
    # advective winds: measured <= 6e-6 on the same flow, fully local
    # (no exchange - the exchange+resample alternative is
    # damping_normal_fields).
    # The D-grid checkerboard mode is invisible to the cell form, but
    # only on these O(N) bands; the dual form keeps controlling it
    # everywhere else.
    div_blend: jnp.ndarray


def padded_metrics(grid: Grid, phis=None,
                   chart_cosa: bool = False) -> PaddedMetrics:
    """phis: optional UNPADDED surface geopotential [6, n, n] (terrain);
    padded here via the scalar gather table.  None = flat.

    chart_cosa: evaluate the basis-angle metrics at the CHART gridpoints
    inside the cube-corner regions (where the fills deliver chart
    samples under DycoreConfig.chart_corners) instead of at the gathered
    true sample positions; bit-identical everywhere else."""
    a = lambda x: jnp.asarray(x)[..., None]
    r = lambda x: (1.0 / jnp.asarray(x))[..., None]
    import numpy as np
    if phis is None:
        phis_pad = np.zeros(grid.area.shape, np.float32)
    else:
        flat = np.asarray(phis, np.float32).reshape(-1)
        phis_pad = flat[grid.spec.gidx_x]
    cosa_i, rsina_i = grid.cosa_i, grid.rsina_i
    cosa_j, rsina_j = grid.cosa_j, grid.rsina_j
    cosa_c, rsin2_c = grid.cosa_c, grid.rsin2_c
    cosa_cn, rsin2_cn = grid.cosa_cn, grid.rsin2_cn
    corner_dw = grid.corner_dw
    if chart_cosa:
        from ..core.chart_corners import chart_cosa_overrides

        ov = chart_cosa_overrides(grid.n, grid.h)

        def blend(name, base, base_r, power):
            # blend only inside the mask so every other slot keeps the
            # ORIGINAL bits (rsina was computed from f64 cosa upstream)
            vals, mask = ov[name]
            rs = 1.0 / np.maximum(1.0 - vals ** 2, 0.25) ** (0.5 * power)
            return (np.where(mask, vals, base).astype(np.float32),
                    np.where(mask, rs, base_r).astype(np.float32))
        cosa_i, rsina_i = blend("cosa_i", cosa_i, rsina_i, 1)
        cosa_j, rsina_j = blend("cosa_j", cosa_j, rsina_j, 1)
        cosa_c, rsin2_c = blend("cosa_c", cosa_c, rsin2_c, 2)
        cosa_cn, rsin2_cn = blend("cosa_cn", cosa_cn, rsin2_cn, 2)
        from ..core.chart_corners import chart_corner_dw

        corner_dw = chart_corner_dw(grid.n, grid.h)
    ap = jnp.pad(jnp.asarray(grid.area), ((0, 0), (1, 1), (1, 1)), mode="edge")
    area_c = 0.25 * (ap[:, :-1, :-1] + ap[:, :-1, 1:] + ap[:, 1:, :-1] + ap[:, 1:, 1:])
    # damping-divergence blend mask (see the field docstring)
    n_, h_ = grid.n, grid.h
    Nc = n_ + 2 * h_ + 1
    iy, ix = np.meshgrid(np.arange(Nc), np.arange(Nc), indexing="ij")
    de_ = np.minimum.reduce([np.abs(iy - h_), np.abs(iy - h_ - n_),
                             np.abs(ix - h_), np.abs(ix - h_ - n_)])
    cd_ = np.minimum.reduce([
        np.hypot(iy - h_, ix - h_), np.hypot(iy - h_, ix - h_ - n_),
        np.hypot(iy - h_ - n_, ix - h_),
        np.hypot(iy - h_ - n_, ix - h_ - n_)])
    div_blend = np.broadcast_to(
        ((de_ <= 1) | (cd_ <= 4.0)).astype(np.float32)[None],
        (NFACES, Nc, Nc)).copy()
    return PaddedMetrics(
        area=a(grid.area),
        rarea=a(grid.rarea),
        dx=a(grid.dx),
        dy=a(grid.dy),
        dxc=a(grid.dxc),
        dyc=a(grid.dyc),
        fcor=a(grid.fcor),
        rarea_c=(1.0 / area_c)[..., None],
        cosa_i=a(cosa_i),
        rsina_i=a(rsina_i),
        cosa_j=a(cosa_j),
        rsina_j=a(rsina_j),
        rdx=r(grid.dx),
        rdy=r(grid.dy),
        rdxc=r(grid.dxc),
        rdyc=r(grid.dyc),
        cosa_c=a(cosa_c),
        rsin2_c=a(rsin2_c),
        cosa_cn=a(cosa_cn),
        rsin2_cn=a(rsin2_cn),
        phis=a(phis_pad),
        dw00=a(corner_dw[0]), dw01=a(corner_dw[1]),
        dw10=a(corner_dw[2]), dw11=a(corner_dw[3]),
        dr11=a(grid.dr11), r12=a(grid.r12),
        r21=a(grid.r21), dr22=a(grid.dr22),
        jwm=a(grid.jwm), jwp=a(grid.jwp),
        iwm=a(grid.iwm), iwp=a(grid.iwp),
        rdxc_c=r(grid.dxc_c), rdyc_c=r(grid.dyc_c),
        div_blend=a(div_blend),
    )


class SWState(NamedTuple):
    """Padded prognostic fields for one substep."""

    pu: jnp.ndarray     # [6, N+1, N, K] D-grid u
    pv: jnp.ndarray     # [6, N, N+1, K]
    pd_x: jnp.ndarray   # [6, N, N, K] delp (x-corner fill)
    pd_y: jnp.ndarray
    pt_x: jnp.ndarray
    pt_y: jnp.ndarray
    pq_x: Optional[jnp.ndarray]  # tracers [6, N, N, K, T]
    pq_y: Optional[jnp.ndarray]
    # nonhydrostatic prognostics (None in hydrostatic mode)
    pw_x: Optional[jnp.ndarray] = None   # vertical velocity [6, N, N, K]
    pw_y: Optional[jnp.ndarray] = None
    pz_x: Optional[jnp.ndarray] = None   # layer thickness delz > 0
    pz_y: Optional[jnp.ndarray] = None


def fill_substep(ops: HaloOps, u, v, delp, pt, q, w=None, delz=None,
                 chart=None) -> SWState:
    """chart: optional ChartCornerTables.  When given, scalar fills are
    resampled onto the chart gridpoints in the cube-corner L-regions -
    after which the x- and y-order fills agree (their strips were always
    identical), so ONE exchange serves both stencil directions: half the
    scalar halo traffic, and the transport's ddx/ddy mixing reads one
    consistent field (the corner-chimera fix)."""
    pu, pv = ops.fill_dgrid(u, v)

    def fx(a):
        if a is None:
            return None
        out = ops.fill(a, "x")
        if chart is not None:
            out = chart.apply_scalar(out, "x")
        return out

    def fy(a, same):
        if a is None:
            return None
        if chart is not None:
            return same  # corrected x-fill == corrected y-fill
        return ops.fill(a, "y")

    pd_x = fx(delp)
    pt_x = fx(pt)
    pq_x = fx(q)
    pw_x = fx(w)
    pz_x = fx(delz)
    return SWState(
        pu=pu,
        pv=pv,
        pd_x=pd_x,
        pd_y=fy(delp, pd_x),
        pt_x=pt_x,
        pt_y=fy(pt, pt_x),
        pq_x=pq_x,
        pq_y=fy(q, pq_x),
        pw_x=pw_x,
        pw_y=fy(w, pw_x),
        pz_x=pz_x,
        pz_y=fy(delz, pz_x),
    )


# --------------------------------------------------------------------------
# staggering helpers (padded arrays)
# --------------------------------------------------------------------------

def _avg_u_to_center(pu):
    return 0.5 * (pu[:, :-1, :] + pu[:, 1:, :])


def _avg_v_to_center(pv):
    return 0.5 * (pv[:, :, :-1] + pv[:, :, 1:])


def _center_to_xiface(a):
    mid = 0.5 * (a[:, :, :-1] + a[:, :, 1:])
    return jnp.concatenate([a[:, :, :1], mid, a[:, :, -1:]], axis=2)


def _center_to_yiface(a):
    mid = 0.5 * (a[:, :-1, :] + a[:, 1:, :])
    return jnp.concatenate([a[:, :1, :], mid, a[:, -1:, :]], axis=1)


def _pad_edge(a, axis: int, before: int = 1, after: int = 1):
    """Edge-replication pad via explicit concat (values identical to
    jnp.pad's edge mode)."""
    idx0 = [slice(None)] * a.ndim
    idx0[axis] = slice(0, 1)
    idx1 = [slice(None)] * a.ndim
    idx1[axis] = slice(a.shape[axis] - 1, a.shape[axis])
    parts = [a[tuple(idx0)]] * before + [a] + [a[tuple(idx1)]] * after
    return jnp.concatenate(parts, axis=axis)


def _center_to_corner(a):
    ap = _pad_edge(_pad_edge(a, 1), 2)
    return 0.25 * (ap[:, :-1, :-1] + ap[:, :-1, 1:] + ap[:, 1:, :-1] + ap[:, 1:, 1:])


def _resample_to_chart(a, m: PaddedMetrics):
    """Re-attach halo cell-center samples to OUR extended-chart gridpoints
    (3-point Lagrange along the off-grid coordinate; identity - exact
    zeros - in the interior).  Written in deviation form
    a + wm (a[-1] - a) + wp (a[+1] - a), which equals the Lagrange
    combination exactly (w0 = 1 - wm - wp) while staying BIT-ZERO on
    uniform fields - the well-balanced rest state is preserved exactly.
    See PaddedMetrics.jwm / grid.Grid.jwm."""
    am = _pad_edge(a, 1, before=1, after=0)[:, :-1]
    ap = _pad_edge(a, 1, before=0, after=1)[:, 1:]
    a = a + (m.jwm * (am - a) + m.jwp * (ap - a))
    am = _pad_edge(a, 2, before=1, after=0)[:, :, :-1]
    ap = _pad_edge(a, 2, before=0, after=1)[:, :, 1:]
    return a + (m.iwm * (am - a) + m.iwp * (ap - a))


def _center_to_corner_w(a, m: PaddedMetrics):
    """Geometry-exact center -> corner interpolation: the plain 4-point
    average plus the precomputed linear-exactness correction
    sum_k dw_k (a_k - avg4) (see PaddedMetrics.dw00).  Bit-exactly the
    plain average on uniform fields (each a_k - avg4 is exactly zero in
    f32), so the well-balanced rest state stays bit-zero; linear-exact at
    the TRUE corner position across face-edge kinks and cube corners."""
    ap = _pad_edge(_pad_edge(a, 1), 2)
    a00, a01 = ap[:, :-1, :-1], ap[:, :-1, 1:]
    a10, a11 = ap[:, 1:, :-1], ap[:, 1:, 1:]
    avg4 = 0.25 * (a00 + a01 + a10 + a11)
    return avg4 + (m.dw00 * (a00 - avg4) + m.dw01 * (a01 - avg4)
                   + m.dw10 * (a10 - avg4) + m.dw11 * (a11 - avg4))


class StagResample(NamedTuple):
    """Staggered-halo chart resample weights (grid.Grid.su_*/sv_*), each
    [6, R, C, 1]; built by stag_resample_tables."""

    su_jwm: jnp.ndarray
    su_jwp: jnp.ndarray
    su_iwm: jnp.ndarray
    su_iwp: jnp.ndarray
    sv_jwm: jnp.ndarray
    sv_jwp: jnp.ndarray
    sv_iwm: jnp.ndarray
    sv_iwp: jnp.ndarray
    # cube-corner disk mask on the padded corner grid [6, N+1, N+1, 1]
    # (face-global so subtile sharding slices it like the metrics;
    # interior blocks see all-False)
    corner_disk: jnp.ndarray


def stag_resample_tables(grid: Grid, radius: float = 4.0) -> StagResample:
    f = lambda a: jnp.asarray(a)[..., None]
    n, h = grid.n, grid.h
    N = n + 2 * h
    iy, ix = np.meshgrid(np.arange(N + 1), np.arange(N + 1),
                         indexing="ij")
    cd = np.minimum.reduce([
        np.hypot(iy - h, ix - h), np.hypot(iy - h, ix - h - n),
        np.hypot(iy - h - n, ix - h), np.hypot(iy - h - n, ix - h - n)])
    disk = np.broadcast_to((cd <= radius)[None], (6, N + 1, N + 1)).copy()
    return StagResample(
        su_jwm=f(grid.su_jwm), su_jwp=f(grid.su_jwp),
        su_iwm=f(grid.su_iwm), su_iwp=f(grid.su_iwp),
        sv_jwm=f(grid.sv_jwm), sv_jwp=f(grid.sv_jwp),
        sv_iwm=f(grid.sv_iwm), sv_iwp=f(grid.sv_iwp),
        corner_disk=f(disk))


def _strip_chart_resample(a, jwm, jwp, iwm, iwp, b: int):
    """Band-confined two-pass chart resample (deviation form) of a scalar
    field on any grid: j-resample on the W/E column bands (width b), then
    i-resample on the S/N row bands consuming the y-resampled corner
    values - the same support structure as a_grid_winds' strip path
    (j-weights live on W/E bands, i-weights on S/N).  One masked-select
    full pass; values outside the frame are untouched bit-exactly.

    The outermost LOCAL rows/cols are forced to identity: a centered
    3-point stencil has no neighbors there.  On the full face the
    weights are already zero at those positions; on a subtile BLOCK they
    may not be (the block edge sits mid-face), and resampling against
    the edge-replicated pad read garbage - those cells sit outside the
    1-ring the damping operator consumes, so identity is safe and keeps
    the consumed ring bit-identical to the single-device path."""
    Ny, Nx = a.shape[1], a.shape[2]
    rmask = np.ones((1, Ny, 1, 1), np.float32)
    rmask[:, 0] = rmask[:, -1] = 0.0
    cmask = np.ones((1, 1, Nx, 1), np.float32)
    cmask[:, :, 0] = cmask[:, :, -1] = 0.0
    rmask, cmask = jnp.asarray(rmask), jnp.asarray(cmask)
    jwm, jwp = jwm * rmask, jwp * rmask
    iwm, iwp = iwm * cmask, iwp * cmask
    parts = []
    for c0, c1 in ((0, b), (Nx - b, Nx)):
        s = a[:, :, c0:c1]
        sy = _resample_y_strip(s, jwm[:, :, c0:c1], jwp[:, :, c0:c1])
        parts.append(jnp.pad(sy[:, b:Ny - b],
                             ((0, 0), (b, b), (c0, Nx - c1), (0, 0))))
        if c0 == 0:
            yW = sy
        else:
            yE = sy
    for r0, r1 in ((0, b), (Ny - b, Ny)):
        s = a[:, r0:r1]
        s = jnp.concatenate([yW[:, r0:r1], s[:, :, b:Nx - b],
                             yE[:, r0:r1]], axis=2)
        sx = _resample_x_strip(s, iwm[:, r0:r1], iwp[:, r0:r1])
        parts.append(jnp.pad(sx, ((0, 0), (r0, Ny - r1), (0, 0), (0, 0))))
    frame = np.zeros((1, Ny, Nx, 1), bool)
    frame[:, :b] = frame[:, Ny - b:] = True
    frame[:, :, :b] = frame[:, :, Nx - b:] = True
    return jnp.where(jnp.asarray(frame), sum(parts[1:], parts[0]), a)


def damping_normal_fields(pu, pv, ua, va, m: PaddedMetrics, ops: HaloOps,
                          tabs: Optional[StagResample]):
    """Chart-consistent normal-velocity fields for the corner-dual
    damping divergence.

    The raw padded pu/pv halos are the neighbor's covariant components at
    the neighbor's staggered positions; projecting them with OUR chart
    metrics makes a smooth solid-body flow look divergent along face
    edges (measured ~2e-4 1/s, 5 orders above interior - the spurious
    damping force this injected was exposed by the JW06 balanced state,
    which it destroyed at +40 hPa/day).  Fix, in the round-3 style:
    (1) transverse components from the chart-corrected A-grid winds,
    (2) the normal fields nu = (u - cosa v) rsina / nv = (v - cosa u)
        rsina computed on each face's own interior (owner side),
    (3) halos exchanged as the tangential-type pair they are
        (fill_dgrid sign tables),
    (4) halo samples re-attached to our chart's staggered gridpoints by
        the static 3-point resample (grid.su_*/sv_*).
    Solid-body edge divergence error drops 30x to the smooth
    discretization level; the 8 corner disks stay approximate (bounded,
    chart-corner machinery does not cover staggered points).

    Returns (p_nu [6, N+1, N, K], p_nv [6, N, N+1, K])."""
    h, ny, nx = ops.h, ops.ny, ops.nx
    vu = _center_to_yiface(va)
    uv = _center_to_xiface(ua)
    nu = (pu - m.cosa_j * vu) * m.rsina_j
    nv = (pv - m.cosa_i * uv) * m.rsina_i
    p_nu, p_nv = ops.fill_dgrid(nu[:, h:h + ny + 1, h:h + nx],
                                nv[:, h:h + ny, h:h + nx + 1])
    if tabs is not None:
        p_nu = _strip_chart_resample(p_nu, tabs.su_jwm, tabs.su_jwp,
                                     tabs.su_iwm, tabs.su_iwp, h)
        p_nv = _strip_chart_resample(p_nv, tabs.sv_jwm, tabs.sv_jwp,
                                     tabs.sv_iwm, tabs.sv_iwp, h)
    return p_nu, p_nv


def damping_divergence(pu, pv, ua, va, uct, vct, m: PaddedMetrics,
                       ops: HaloOps, tabs: Optional[StagResample],
                       corner_blend: bool = True):
    """Padded corner-grid divergence for the damping operator, computed
    chart-consistently everywhere:

    * face interiors and edges: the metric-exact corner-dual contour of
      the exchanged+resampled normal fields (damping_normal_fields);
    * the 8 cube-corner disks: the 1-D staggered resample cannot fix the
      two-owner corner blocks (solid-body residual 1.4e-4 1/s there), so
      the disks take the corner-interpolated (corner_dw, linear-exact at
      the true corner point) cell divergence of the chart-consistent
      advective winds uct/vct instead.  The D-grid checkerboard mode is
      invisible to that form, but only on 8 disks of ~4-cell radius -
      the dual form keeps controlling it everywhere else.

    Returns div_c [F, N(+1), N(+1), K]."""
    p_nu, p_nv = damping_normal_fields(pu, pv, ua, va, m, ops, tabs)
    uf = p_nu * m.dyc
    vf = p_nv * m.dxc
    du = uf[:, :, 1:] - uf[:, :, :-1]
    dv = vf[:, 1:, :] - vf[:, :-1, :]
    div_core = (du[:, 1:-1, :] + dv[:, :, 1:-1]) \
        * m.rarea_c[:, 1:-1, 1:-1]
    div_c = _pad_edge(_pad_edge(div_core, 1), 2)
    if corner_blend:
        # ddx/ddy are flux CONVERGENCES (F[i] - F[i+1]); negate for the
        # divergence
        div_cell = -(ddx(uct * m.dy) + ddy(vct * m.dx)) * m.rarea
        div_a = _center_to_corner_w(div_cell, m)
        div_c = jnp.where(tabs.corner_disk, div_a, div_c)
    return div_c


def _vorticity_abs(pu, pv, m: PaddedMetrics):
    """Absolute vorticity at cell centers (primal-cell circulation)."""
    circ = (pu[:, :-1, :] * m.dx[:, :-1, :]
            + pv[:, :, 1:] * m.dy[:, :, 1:]
            - pu[:, 1:, :] * m.dx[:, 1:, :]
            - pv[:, :, :-1] * m.dy[:, :, :-1])
    return circ * m.rarea + m.fcor


def _hydrostatic_fields(delp, pt, ptop):
    """pe -> Exner pkz and layer-mid geopotential (flat terrain)."""
    pe = interfaces_from_delp(delp, ptop)
    pk_iface = (pe / P00) ** KAPPA
    peln = jnp.log(pe)
    pkz = (pk_iface[..., 1:] - pk_iface[..., :-1]) / (
        KAPPA * (peln[..., 1:] - peln[..., :-1]))
    dphi = CP_AIR * pt * (pk_iface[..., 1:] - pk_iface[..., :-1])
    phi_below_incl = rcumsum_k(dphi)
    phi_mid = phi_below_incl - 0.5 * dphi
    return pkz, phi_mid


# --------------------------------------------------------------------------
# c_sw: half-step -> time-centered C-grid winds
# --------------------------------------------------------------------------

# support-layout cache for the strip-form A-grid correction: keyed by the
# id of the metric array so each PaddedMetrics is probed once per process
_AGRID_SUPPORT_CACHE: dict = {}


def _agrid_strip_ok(m: PaddedMetrics) -> bool:
    """True when every A-grid halo correction field has the band-confined
    support the strip path assumes: all 8 fields zero outside the h-wide
    frame, jwm/jwp confined to the W/E column bands, iwm/iwp to the S/N
    row bands (h inferred as (padded - interior)/2 is not available here,
    so the frame width is probed from the fields themselves).  Falls back
    to the full-array path under tracing (sharded shard_map bodies) or
    any support violation."""
    key = id(m.dr11)
    hit = _AGRID_SUPPORT_CACHE.get(key)
    if hit is not None:
        return hit
    try:
        fields = {}
        for name in ("dr11", "r12", "r21", "dr22",
                     "jwm", "jwp", "iwm", "iwp"):
            a = np.asarray(getattr(m, name))
            fields[name] = a[..., 0] if a.ndim == 4 else a
    except Exception:          # traced values (shard_map body): full path
        _AGRID_SUPPORT_CACHE[key] = False
        return False
    Ny, Nx = fields["dr11"].shape[1:3]
    b = _agrid_band(m)
    ok = True
    for name, a in fields.items():
        if (a[:, b:Ny - b, b:Nx - b] != 0.0).any():
            ok = False
        if name in ("jwm", "jwp") and (a[:, :, b:Nx - b] != 0.0).any():
            ok = False
        if name in ("iwm", "iwp") and (a[:, b:Ny - b, :] != 0.0).any():
            ok = False
    _AGRID_SUPPORT_CACHE[key] = ok
    return ok


def _agrid_band(m: PaddedMetrics) -> int:
    """Frame width of the halo corrections == the halo width h: the jwm
    field is nonzero exactly on the W/E halo column bands, so h is the
    run of leading nonzero columns."""
    a = np.asarray(m.jwm)
    a = a[..., 0] if a.ndim == 4 else a
    col_any = a.any(axis=(0, 1))
    if col_any.all() or not col_any[0]:
        return 3
    return int(np.argmin(col_any))


def _rot(ua, va, dr11, r12, r21, dr22):
    return (ua + (dr11 * ua + r12 * va),
            va + (r21 * ua + dr22 * va))


def _resample_y_strip(a, jwm, jwp):
    """y-direction chart resample on a full-height column strip (the
    deviation form of _resample_to_chart's first pass)."""
    am = _pad_edge(a, 1, before=1, after=0)[:, :-1]
    ap = _pad_edge(a, 1, before=0, after=1)[:, 1:]
    return a + (jwm * (am - a) + jwp * (ap - a))


def _resample_x_strip(a, iwm, iwp):
    am = _pad_edge(a, 2, before=1, after=0)[:, :, :-1]
    ap = _pad_edge(a, 2, before=0, after=1)[:, :, 1:]
    return a + (iwm * (am - a) + iwp * (ap - a))


def a_grid_winds(pu, pv, m: PaddedMetrics):
    """Chart-consistent A-grid winds from the padded D-grid fills.

    Averaging, then the halo treatment: re-express halo components in OUR
    extended chart (see PaddedMetrics.dr11; exact zeros in the interior
    keep interior values bit-identical), then resample them onto our
    extended-chart gridpoints (PaddedMetrics.jwm): halo samples sit
    shifted along the edge otherwise, an O(h) wind error at the shared
    interface that becomes an O(1) mass-flux-divergence error at edge
    cells.  The cube-corner L-regions (where this per-cell machinery
    cannot be exact - the chimera) are overwritten by the chart
    reconstruction in the substep glue (core/chart_corners.apply_agrid)
    when DycoreConfig.chart_corners is on.

    Every correction is supported only on the h-wide halo frame, so the
    hot path computes them on thin strips and adds the zero-padded deltas
    in ONE fused full-array pass instead of the full-array rotation +
    two-direction resample chain; the strip form leaves two passes per
    field (the average and the delta add).  Bit-identical to the full chain: the
    corrections it skips are exact f32 zeros (support asserted per
    metrics set, with a full-array fallback)."""
    ua = _avg_u_to_center(pu)
    va = _avg_v_to_center(pv)
    if not _agrid_strip_ok(m):
        ua, va = _rot(ua, va, m.dr11, m.r12, m.r21, m.dr22)
        ua = _resample_to_chart(ua, m)
        va = _resample_to_chart(va, m)
        return ua, va

    b = _agrid_band(m)
    Ny, Nx = ua.shape[1], ua.shape[2]

    def met(name, sl):
        a = getattr(m, name)
        return a[(slice(None),) + sl]

    parts_u, parts_v = [], []
    # --- W/E column strips: rotation + y-resample (full height) ----------
    for c0, c1 in ((0, b), (Nx - b, Nx)):
        sl = (slice(None), slice(c0, c1))
        u_s, v_s = ua[:, :, c0:c1], va[:, :, c0:c1]
        ur, vr = _rot(u_s, v_s, met("dr11", sl), met("r12", sl),
                      met("r21", sl), met("dr22", sl))
        uy = _resample_y_strip(ur, met("jwm", sl), met("jwp", sl))
        vy = _resample_y_strip(vr, met("jwm", sl), met("jwp", sl))
        # middle rows take the y-resampled values; T/B rows are covered by
        # the row strips below (which consume these corner values)
        pad = ((0, 0), (b, b), (c0, Nx - c1), (0, 0))
        parts_u.append(jnp.pad(uy[:, b:Ny - b], pad))
        parts_v.append(jnp.pad(vy[:, b:Ny - b], pad))
        if c0 == 0:
            uyW, vyW = uy, vy
        else:
            uyE, vyE = uy, vy
    # --- S/N row strips: rotation, splice in the y-resampled corners,
    # then x-resample (full width) ---------------------------------------
    for r0, r1 in ((0, b), (Ny - b, Ny)):
        sl = (slice(r0, r1),)
        u_s, v_s = ua[:, r0:r1], va[:, r0:r1]
        ur, vr = _rot(u_s, v_s, met("dr11", sl), met("r12", sl),
                      met("r21", sl), met("dr22", sl))
        # y-resample affects only the W/E corner columns of this strip
        ur = jnp.concatenate([uyW[:, r0:r1], ur[:, :, b:Nx - b],
                              uyE[:, r0:r1]], axis=2)
        vr = jnp.concatenate([vyW[:, r0:r1], vr[:, :, b:Nx - b],
                              vyE[:, r0:r1]], axis=2)
        ux = _resample_x_strip(ur, met("iwm", sl), met("iwp", sl))
        vx = _resample_x_strip(vr, met("iwm", sl), met("iwp", sl))
        pad = ((0, 0), (r0, Ny - r1), (0, 0), (0, 0))
        parts_u.append(jnp.pad(ux, pad))
        parts_v.append(jnp.pad(vx, pad))
    # masked-select assembly: the four zero-padded pieces have disjoint
    # support covering exactly the frame, so summing them and selecting
    # by the static frame mask reproduces the full-path values BIT-exactly
    # (a delta-add form a + (corr - a) re-rounds and was measured 6e-5
    # relative off)
    frame = np.zeros((1, Ny, Nx, 1), bool)
    frame[:, :b] = frame[:, Ny - b:] = True
    frame[:, :, :b] = frame[:, :, Nx - b:] = True
    mask = jnp.asarray(frame)
    out_u = jnp.where(mask, sum(parts_u[1:], parts_u[0]), ua)
    out_v = jnp.where(mask, sum(parts_v[1:], parts_v[0]), va)
    return out_u, out_v


def c_sw_part1(s: SWState, m: PaddedMetrics, dt2: float, ua, va):
    """C-grid winds (projected onto interface normals), half-step upwind
    mass/pt update, center KE and absolute vorticity.  Purely horizontal
    (no vertical coupling); the hydrostatic integrals of (delp_h, pt_h) and the A-grid winds
    (a_grid_winds + the corner chart reconstruction) happen outside."""
    uc = _center_to_xiface(ua)              # [6, N, N+1, K]
    vc = _center_to_yiface(va)              # [6, N+1, N, K]
    # transverse coordinate components at the interfaces
    va_i = _center_to_xiface(va)
    ua_j = _center_to_yiface(ua)
    uc = (uc - m.cosa_i * va_i) * m.rsina_i
    vc = (vc - m.cosa_j * ua_j) * m.rsina_j

    # half-step upwind mass/pt update
    crx = uc * dt2 * m.rdxc
    cry = vc * dt2 * m.rdyc
    fx_m = upwind_flux(s.pd_x, crx, axis=2) * uc * dt2 * m.dy
    fy_m = upwind_flux(s.pd_y, cry, axis=1) * vc * dt2 * m.dx
    delp_h = s.pd_x + (ddx(fx_m) + ddy(fy_m)) * m.rarea
    fx_t = upwind_flux(s.pt_x, crx, axis=2) * fx_m
    fy_t = upwind_flux(s.pt_y, cry, axis=1) * fy_m
    pt_h = (s.pt_x * s.pd_x + (ddx(fx_t) + ddy(fy_t)) * m.rarea) / delp_h

    # contravariant KE: |V|^2 = rsin2 (u^2 + v^2 - 2 cosa u v) from the
    # covariant center winds (locally-orthogonal form dropped the cosa
    # cross term - an O(sin 9 deg) error near face corners)
    ke = 0.5 * m.rsin2_c * (ua * ua + va * va - 2.0 * m.cosa_c * ua * va)
    vort = _vorticity_abs(s.pu, s.pv, m)
    return uc, vc, delp_h, pt_h, ke, vort


def c_sw_part2(uc, vc, pt_h, pkz, phi, ke, vort, m: PaddedMetrics,
               dt2: float):
    """Interface wind update from the half-updated PGF -> time-centered
    advective winds (uc*, vc*).  Horizontal only.

    All cell-centered inputs are first resampled onto the extended-chart
    gridpoints and differenced with the CHART spacings (rdxc_c/rdyc_c):
    without this, the gradient at a shared-edge interface runs along the
    kinked physical center chord (the edge normal) while every other
    interface differences along the chart's xi/eta line - a flat O(1)
    imbalance at face edges that does not converge with resolution
    (measured in scripts/edge_probe.py; interior bits unchanged)."""
    pt_h = _resample_to_chart(pt_h, m)
    pkz = _resample_to_chart(pkz, m)
    phi = _resample_to_chart(phi, m)
    ke = _resample_to_chart(ke, m)
    vort = _resample_to_chart(vort, m)
    # x-interface update (interior interfaces [1, N-1]; edges left unchanged)
    ptx = 0.5 * (pt_h[:, :, :-1] + pt_h[:, :, 1:])
    gx = ((phi[:, :, 1:] - phi[:, :, :-1])
          + CP_AIR * ptx * (pkz[:, :, 1:] - pkz[:, :, :-1])) * m.rdxc_c[:, :, 1:-1]
    kex = (ke[:, :, 1:] - ke[:, :, :-1]) * m.rdxc_c[:, :, 1:-1]
    vortx = 0.5 * (vort[:, :, :-1] + vort[:, :, 1:])
    # vc at the x-interface: average 4 surrounding y-interface values
    vcx = 0.25 * (vc[:, :-1, :-1] + vc[:, :-1, 1:]
                  + vc[:, 1:, :-1] + vc[:, 1:, 1:])
    # concat-assembled update (values identical to .at[].add, without a
    # scatter)
    uc_t = jnp.concatenate(
        [uc[:, :, :1],
         uc[:, :, 1:-1] + dt2 * (vortx * vcx - kex - gx),
         uc[:, :, -1:]], axis=2)

    # y-interface update
    pty = 0.5 * (pt_h[:, :-1, :] + pt_h[:, 1:, :])
    gy = ((phi[:, 1:, :] - phi[:, :-1, :])
          + CP_AIR * pty * (pkz[:, 1:, :] - pkz[:, :-1, :])) * m.rdyc_c[:, 1:-1, :]
    key = (ke[:, 1:, :] - ke[:, :-1, :]) * m.rdyc_c[:, 1:-1, :]
    vorty = 0.5 * (vort[:, :-1, :] + vort[:, 1:, :])
    ucy = 0.25 * (uc[:, :-1, :-1] + uc[:, :-1, 1:]
                  + uc[:, 1:, :-1] + uc[:, 1:, 1:])
    vc_t = jnp.concatenate(
        [vc[:, :1, :],
         vc[:, 1:-1, :] + dt2 * (-vorty * ucy - key - gy),
         vc[:, -1:, :]], axis=1)

    return uc_t, vc_t


def c_sw(s: SWState, m: PaddedMetrics, dt2: float, ptop: float,
         chart=None):
    """Returns (uc*, vc*): advective *normal* winds at t + dt/2 on the
    C-grid.  The interpolated coordinate components are projected onto the
    interface normals ((V.e1 - cosa V.e2) / sina), which makes the fluxes
    metrically consistent on the non-orthogonal gnomonic grid (FV3's
    ut/vt contravariant conversion).

    chart: optional ChartCornerTables - overwrites the cube-corner
    L-regions of the A-grid winds with the chart reconstruction."""
    ua, va = a_grid_winds(s.pu, s.pv, m)
    if chart is not None:
        ua, va = chart.apply_agrid(ua, va, s.pu, s.pv)
    uc, vc, delp_h, pt_h, ke, vort = c_sw_part1(s, m, dt2, ua, va)
    if chart is not None:
        # the corner-block circulation closes over two different owner
        # cells (raw pu row + raw pv col) - resample the center vorticity
        # one-sidedly from the valid slots (the PPM vorticity flux at
        # corner interfaces reads these; measured flat 2.3e-6 without)
        vort = chart.apply_scalar(vort, "derived")
    # backward PGF from half-updated fields; compact C-grid gradients;
    # phis adds the terrain contribution (zero for flat experiments)
    pkz, phi = _hydrostatic_fields(delp_h, pt_h, ptop)
    uct, vct = c_sw_part2(uc, vc, pt_h, pkz, phi + m.phis, ke, vort, m,
                          dt2)
    return uct, vct, vort, ua, va


# --------------------------------------------------------------------------
# d_sw: full substep
# --------------------------------------------------------------------------

class SubstepOut(NamedTuple):
    u: jnp.ndarray        # interior D-grid u [6, n+1, n, K]
    v: jnp.ndarray
    delp: jnp.ndarray     # interior [6, n, n, K]
    pt: jnp.ndarray
    q: Optional[jnp.ndarray]
    w: Optional[jnp.ndarray]     # interior, horizontally advected (NH mode)
    delz: Optional[jnp.ndarray]
    mfx: jnp.ndarray      # interior x mass fluxes
    mfy: jnp.ndarray
    uc: jnp.ndarray       # interior time-centered C-grid winds
    vc: jnp.ndarray
    # padded per-substep transport quantities, for accumulated-flux tracer
    # advection over the remap interval (FV3's z_tracer mode).  Only the
    # advective winds and mass fluxes are carried: the Courant/area-flux
    # factors are uct/vct times STATIC metrics, so accumulating uct/vct
    # and multiplying once per remap interval gives the same accumulated
    # factors (f32 reassociation only) at 2 fewer full-array
    # accumulations per substep
    uct_pad: jnp.ndarray  # [6, N, N+1, K]
    vct_pad: jnp.ndarray  # [6, N+1, N, K]
    mfx_pad: jnp.ndarray
    mfy_pad: jnp.ndarray
    # mid-substep x-order refills of the NEW state (computed for the
    # backward PGF anyway) - fv_dynamics reuses them as the next
    # substep's padded transport inputs instead of re-exchanging the
    # same interiors (they are the same function of the same data)
    pd_fill: Optional[jnp.ndarray] = None
    pt_fill: Optional[jnp.ndarray] = None
    pz_fill: Optional[jnp.ndarray] = None


def transport_part(s: SWState, m: PaddedMetrics, crx, cry, xfx, yfx,
                   hord: int, advect_tracers: bool, hord_tm: int = 0):
    """All PPM transport of one substep (horizontal only):
    mass, heat, NH w (mass-weighted) / delz (volume-weighted), tracers.

    Returns (delp_new, pt_new, w_adv, delz_adv, q_new, mf)."""
    # the inner-update denominators are shared by every transported field:
    # compute their reciprocals once (full-size divides dominate otherwise)
    hord_tm = hord_tm or hord
    rax = 1.0 / (m.area + ddx(xfx))
    ray = 1.0 / (m.area + ddy(yfx))
    mf = fvtp2d(s.pd_x, s.pd_y, crx, cry, xfx, yfx, m.area, hord=hord_tm,
                rax=rax, ray=ray)
    delp_new = s.pd_x + (ddx(mf.fx) + ddy(mf.fy)) * m.rarea
    rdelp_new = 1.0 / delp_new

    tf = fvtp2d(s.pt_x, s.pt_y, crx, cry, xfx, yfx, m.area, hord=hord_tm,
                mfx=mf.fx, mfy=mf.fy, rax=rax, ray=ray)
    pt_new = (s.pt_x * s.pd_x
              + (ddx(tf.fx) + ddy(tf.fy)) * m.rarea) * rdelp_new

    if s.pz_x is not None:
        wf = fvtp2d(s.pw_x, s.pw_y, crx, cry, xfx, yfx, m.area, hord=hord_tm,
                    mfx=mf.fx, mfy=mf.fy, rax=rax, ray=ray)
        w_adv = (s.pw_x * s.pd_x
                 + (ddx(wf.fx) + ddy(wf.fy)) * m.rarea) * rdelp_new
        zf = fvtp2d(s.pz_x, s.pz_y, crx, cry, xfx, yfx, m.area, hord=hord_tm,
                    rax=rax, ray=ray)
        delz_adv = jnp.maximum(
            s.pz_x + (ddx(zf.fx) + ddy(zf.fy)) * m.rarea, 1.0)
    else:
        w_adv = delz_adv = None

    if s.pq_x is not None and advect_tracers:
        T = s.pq_x.shape[-1]
        qs = []
        for t in range(T):
            qf = fvtp2d(s.pq_x[..., t], s.pq_y[..., t], crx, cry, xfx, yfx,
                        m.area, hord=hord, mfx=mf.fx, mfy=mf.fy,
                        rax=rax, ray=ray)
            qdp = s.pq_x[..., t] * s.pd_x + (ddx(qf.fx) + ddy(qf.fy)) * m.rarea
            qs.append(qdp * rdelp_new)
        q_new = jnp.stack(qs, axis=-1)
    else:
        q_new = None
    return delp_new, pt_new, w_adv, delz_adv, q_new, mf


def nh_perturbation_fields(delp_new, pt_new, delz_new, ptop: float):
    """Backward p' and phi' from the solved NH state (vertically coupled).

    The hydrostatic thickness MUST be the same discrete form as
    nh_solver.hydrostatic_delz (delp R T / p_mid) so that both
    perturbations are identically zero in discrete balance; the
    cp*theta*dpk form differs by the log-mean vs arithmetic-mean
    pressure and injects a spurious O((dlnp)^2) force on coarse
    vertical grids."""
    pe1 = interfaces_from_delp(delp_new, ptop)
    pk1 = (pe1 / P00) ** KAPPA
    peln1 = jnp.log(pe1)
    pkz1 = (pk1[..., 1:] - pk1[..., :-1]) / (
        KAPPA * (peln1[..., 1:] - peln1[..., :-1]))
    p_mid1 = 0.5 * (pe1[..., 1:] + pe1[..., :-1])
    t1 = pt_new * pkz1
    rho1 = delp_new / (GRAV * jnp.maximum(delz_new, 1.0))
    pprime = rho1 * RDGAS * t1 - p_mid1
    dphi_diff = GRAV * delz_new - RDGAS * t1 * delp_new / p_mid1
    phip_incl = rcumsum_k(dphi_diff)
    phiprime = phip_incl - 0.5 * dphi_diff
    return pprime, phiprime, rho1


def wind_part(s: SWState, m: PaddedMetrics, uct, vct, crx, cry,
              pt_new, pkz, phi_mid, nh_fields, dt: float, hord: int,
              d2_bg: float, hord_mt: int = 0, vort=None, div_c_in=None,
              vtx_damp: float = 0.0):
    """D-grid vector-invariant wind update (horizontal only).

    pkz/phi_mid: hydrostatic fields of the post-transport state (computed
    outside - vertically coupled).  nh_fields: optional
    (pprime, phiprime, rho1) cell-centered NH perturbations.
    The damping divergence: div_c_in, when given, is the glue-computed
    exchange+resample form (damping_divergence - dual structure
    everywhere except corner disks, full checkerboard control; chosen
    for npx <= 96).  Otherwise the local dual/cell blend over
    m.div_blend's edge bands (no exchange; chosen at large npx, where the
    checkerboard-blind bands are a vanishing fraction of the face).
    Both forms measure <= 6e-6 1/s spurious divergence on solid-body
    flow vs the raw contour's 2e-4 (tests/test_damping_divergence.py).
    Returns (u_new, v_new) padded."""
    phi_c = _center_to_corner_w(phi_mid, m)
    pkz_c = _center_to_corner_w(pkz, m)
    pt_c = _center_to_corner_w(pt_new, m)
    nonhydro = nh_fields is not None
    if nonhydro:
        pprime, phiprime, rho1 = nh_fields
        php_c = _center_to_corner_w(phiprime, m)
        pp_c = _center_to_corner_w(pprime, m)
        rho_c = _center_to_corner_w(rho1, m)

    # ---- KE (corners, centered winds) + vorticity + divergence ----------
    ub = 0.5 * (uct[:, :-1, :] + uct[:, 1:, :])   # corner [6, N-1, N+1, K]
    ub = _pad_edge(ub, 1)
    vb = 0.5 * (vct[:, :, :-1] + vct[:, :, 1:])   # corner [6, N+1, N-1, K]
    vb = _pad_edge(vb, 2)
    # |V|^2 from NORMAL components: rsin2 (ub^2 + vb^2 + 2 cosa ub vb)
    # (normal comps are sina x contravariant, hence the + cross term)
    ke_c = 0.5 * m.rsin2_cn * (ub * ub + vb * vb
                               + 2.0 * m.cosa_cn * ub * vb)

    # corrected center vorticity can be passed in (the chart-corner
    # one-sided resample, computed once in c_sw's glue); None = recompute
    vort_abs = vort if vort is not None \
        else _vorticity_abs(s.pu, s.pv, m)        # centers

    # metric-exact corner-dual divergence (flux form): project each
    # D-wind onto the dual-edge normal ((u - cosa v_t) / sina), weight by
    # the dual edge length (the center-to-center chord dxc/dyc), and
    # divide the contour sum by the dual-cell area - FV3's
    # divergence_corner.  The previous locally-orthogonal differences
    # were acceptable for a filter but this is a dynamics term fed by
    # exactly the corner neighborhoods the chart treatment fixed
    # (round-3 verdict item; same flux-form metric family as transport).
    upad, vpad = s.pu, s.pv
    if div_c_in is not None:
        div_c = div_c_in
    else:
        vmid = 0.5 * (vpad[:, :, :-1] + vpad[:, :, 1:])
        vu = _pad_edge(0.5 * (vmid[:, :-1, :] + vmid[:, 1:, :]), 1)
        uf = (upad - m.cosa_j * vu) * m.rsina_j * m.dyc
        umid = 0.5 * (upad[:, :-1, :] + upad[:, 1:, :])
        uv = _pad_edge(0.5 * (umid[:, :, :-1] + umid[:, :, 1:]), 2)
        vf = (vpad - m.cosa_i * uv) * m.rsina_i * m.dxc
        du = uf[:, :, 1:] - uf[:, :, :-1]
        dv = vf[:, 1:, :] - vf[:, :-1, :]
        div_core = (du[:, 1:-1, :] + dv[:, :, 1:-1]) \
            * m.rarea_c[:, 1:-1, 1:-1]
        div_dual = _pad_edge(_pad_edge(div_core, 1), 2)
        # ddx/ddy are flux CONVERGENCES (F[i]-F[i+1]); negate for div
        div_cell = -(ddx(uct * m.dy) + ddy(vct * m.dx)) * m.rarea
        div_a = _center_to_corner_w(div_cell, m)
        div_c = jnp.where(m.div_blend > 0.5, div_a, div_dual)

    # ---- D-grid wind update --------------------------------------------
    # vorticity flux with PPM-upwinded absolute vorticity (the 2-pt
    # average is not enstrophy-stable: eddies amplify nonlinearly after
    # ~10 simulated days; upwinding dissipates enstrophy at the grid
    # scale, FV3's hord_vt treatment)
    hord_mt = hord_mt or hord
    vort_u = ppm_flux(vort_abs, cry, axis=1, hord=hord_mt)
    dke_x = (ke_c[:, :, 1:] - ke_c[:, :, :-1]) * m.rdx
    pt_u = 0.5 * (pt_c[:, :, 1:] + pt_c[:, :, :-1])
    pgf_x = ((phi_c[:, :, 1:] - phi_c[:, :, :-1])
             + CP_AIR * pt_u * (pkz_c[:, :, 1:] - pkz_c[:, :, :-1])) * m.rdx
    if nonhydro:
        rho_u = jnp.maximum(0.5 * (rho_c[:, :, 1:] + rho_c[:, :, :-1]),
                            1.0e-8)
        pgf_x = pgf_x + ((php_c[:, :, 1:] - php_c[:, :, :-1])
                         + (pp_c[:, :, 1:] - pp_c[:, :, :-1]) / rho_u) * m.rdx
    damp_x = (d2_bg / dt) * m.dx  # x (dx^2/dx) folded: damp * ddiv / dx
    ddiv_x = damp_x * (div_c[:, :, 1:] - div_c[:, :, :-1])

    # ---- optional rotational damping (cfg.vtx_damp) ---------------------
    # The divergence damping above is only HALF the vector Laplacian:
    # nu lap(V) = nu grad(div) - nu curl(zeta k).  Rotational modes (jets,
    # coarse-grid equatorial superrotation) see no dissipation from it;
    # at c12-L20/dt=1200 the PPM-upwind vorticity flux alone lets
    # jet-scale energy grow to NaN after ~50 simulated days (round-5
    # ARCHITECTURE gap).  vtx_damp supplies the missing half on the
    # RELATIVE vorticity (damping f would inject a spurious -nu*beta
    # force):  du/dt -= nu dzeta/dy, dv/dt += nu dzeta/dx with
    # nu = vtx_damp * dx^2 / dt, mirroring the d2_bg discretization.
    # Orientation-safe: under a chart handedness flip both zeta and the
    # transverse derivative flip, leaving the force invariant.
    if vtx_damp > 0.0:
        zeta = vort_abs - m.fcor
        dvtx_u = (vtx_damp / dt) * m.dyc[:, 1:-1, :] * (
            zeta[:, 1:, :] - zeta[:, :-1, :])
        dvtx_v = (vtx_damp / dt) * m.dxc[:, :, 1:-1] * (
            zeta[:, :, 1:] - zeta[:, :, :-1])
    else:
        dvtx_u = dvtx_v = 0.0

    u_new = jnp.concatenate(
        [upad[:, :1, :],
         upad[:, 1:-1, :] + dt * (
             vort_u[:, 1:-1, :] * vct[:, 1:-1, :]
             - dke_x[:, 1:-1, :]
             - pgf_x[:, 1:-1, :]
             + ddiv_x[:, 1:-1, :]
             - dvtx_u),
         upad[:, -1:, :]], axis=1)

    # v-points
    vort_v = ppm_flux(vort_abs, crx, axis=2, hord=hord_mt)
    dke_y = (ke_c[:, 1:, :] - ke_c[:, :-1, :]) * m.rdy
    pt_v = 0.5 * (pt_c[:, 1:, :] + pt_c[:, :-1, :])
    pgf_y = ((phi_c[:, 1:, :] - phi_c[:, :-1, :])
             + CP_AIR * pt_v * (pkz_c[:, 1:, :] - pkz_c[:, :-1, :])) * m.rdy
    if nonhydro:
        rho_v = jnp.maximum(0.5 * (rho_c[:, 1:, :] + rho_c[:, :-1, :]),
                            1.0e-8)
        pgf_y = pgf_y + ((php_c[:, 1:, :] - php_c[:, :-1, :])
                         + (pp_c[:, 1:, :] - pp_c[:, :-1, :]) / rho_v) * m.rdy
    damp_y = (d2_bg / dt) * m.dy
    ddiv_y = damp_y * (div_c[:, 1:, :] - div_c[:, :-1, :])

    v_new = jnp.concatenate(
        [vpad[:, :, :1],
         vpad[:, :, 1:-1] + dt * (
             -vort_v[:, :, 1:-1] * uct[:, :, 1:-1]
             - dke_y[:, :, 1:-1]
             - pgf_y[:, :, 1:-1]
             + ddiv_y[:, :, 1:-1]
             + dvtx_v),
         vpad[:, :, -1:]], axis=2)
    return u_new, v_new


_CORE_MASK_CACHE: dict = {}


def _core_mask(shape, h: int, ny: int, nx: int, r: int):
    """Static mask of cells whose c_sw_part1 stencils stay inside the
    locally-valid interior (no exchanged halo dependency); staggered
    extents follow the output shape."""
    key = (shape[1], shape[2], h, ny, nx, r)
    hit = _CORE_MASK_CACHE.get(key)
    if hit is None:
        R, C = shape[1], shape[2]
        ey = ny + (R - (ny + 2 * h))    # ny or ny+1
        ex = nx + (C - (nx + 2 * h))
        mk = np.zeros((1, R, C, 1), bool)
        mk[:, h + r:h + ey - r, h + r:h + ex - r] = True
        _CORE_MASK_CACHE[key] = mk
        hit = mk
    # asarray fresh per trace: caching the device constant leaks a
    # shard_map-varying tracer across traces
    return jnp.asarray(hit)


def _c_sw_rim_split(s: SWState, rim_loc, m: PaddedMetrics, dt2: float,
                    ptop: float, chart, ops: HaloOps):
    """c_sw with the interior/rim kernel split (SURVEY 7.3): the CORE
    region of c_sw_part1 is computed from LOCAL (un-exchanged) winds -
    in the core every halo correction is an exact zero, so plain
    averaging equals a_grid_winds bit-exactly and no stencil reaches
    exchanged data - while the D-grid ppermute rounds are in flight;
    the rim bands come from the exchanged fills and the stitch is
    bit-identical to the unsplit chain (gated in tests/test_subtile.py).
    XLA's latency-hiding scheduler overlaps the exchange with the core
    compute because the core chain has NO dataflow edge to it."""
    pu_loc, pv_loc = rim_loc
    ua_c = _avg_u_to_center(pu_loc)
    va_c = _avg_v_to_center(pv_loc)
    s_loc = s._replace(pu=pu_loc, pv=pv_loc)
    core = c_sw_part1(s_loc, m, dt2, ua_c, va_c)

    ua, va = a_grid_winds(s.pu, s.pv, m)
    if chart is not None:
        ua, va = chart.apply_agrid(ua, va, s.pu, s.pv)
    rim = c_sw_part1(s, m, dt2, ua, va)

    h, ny, nx = ops.h, ops.ny, ops.nx
    outs = [jnp.where(_core_mask(c.shape, h, ny, nx, 3), c, x)
            for c, x in zip(core, rim)]
    uc, vc, delp_h, pt_h, ke, vort = outs
    if chart is not None:
        vort = chart.apply_scalar(vort, "derived")
    pkz, phi = _hydrostatic_fields(delp_h, pt_h, ptop)
    uct, vct = c_sw_part2(uc, vc, pt_h, pkz, phi + m.phis, ke, vort, m,
                          dt2)
    return uct, vct, vort, ua, va


def d_sw_substep(
    s: SWState,
    m: PaddedMetrics,
    ops: HaloOps,
    dt: float,
    ptop: float,
    hord: int = 8,
    d2_bg: float = 0.015,
    advect_tracers: bool = True,
    hord_mt: int = 0,
    hord_tm: int = 0,
    chart=None,
    rim_loc=None,
    stag_tabs: Optional[StagResample] = None,
    vtx_damp: float = 0.0,
) -> SubstepOut:
    """One forward-backward acoustic substep on padded fields.

    chart: optional ChartCornerTables (cube-corner chart consistency for
    the A-grid winds and the mid-substep refills).
    stag_tabs: when given, the damping divergence uses the
    exchange+resample formulation (see wind_part); None = in-kernel
    blend."""
    h, ny, nx = ops.h, ops.ny, ops.nx

    def refill(a):
        out = ops.fill(a, "x")
        if chart is not None:
            out = chart.apply_scalar(out, "x")
        return out
    islice = (slice(None), slice(h, h + ny), slice(h, h + nx))
    isliceu = (slice(None), slice(h, h + ny + 1), slice(h, h + nx))
    islicev = (slice(None), slice(h, h + ny), slice(h, h + nx + 1))

    # ---- time-centered advective winds ---------------------------------
    if rim_loc is not None:
        uct, vct, vort_c, ua, va = _c_sw_rim_split(
            s, rim_loc, m, 0.5 * dt, ptop, chart, ops)
    else:
        uct, vct, vort_c, ua, va = c_sw(s, m, 0.5 * dt, ptop, chart=chart)
    div_cg = damping_divergence(s.pu, s.pv, ua, va, uct, vct, m, ops,
                                stag_tabs) \
        if stag_tabs is not None else None

    crx = uct * dt * m.rdxc
    cry = vct * dt * m.rdyc
    xfx = uct * dt * m.dy
    yfx = vct * dt * m.dx

    # ---- transport + conservative updates ------------------------------
    delp_new, pt_new, w_adv, delz_adv, q_new, mf = transport_part(
        s, m, crx, cry, xfx, yfx, hord, advect_tracers, hord_tm=hord_tm)

    # ---- nonhydrostatic: the implicit vertical acoustic solve, then the
    # backward NH pressure force from the SOLVED fields (FV3 order:
    # d_sw transport -> riem_solver3 -> nh_p_grad with updated pk3/gz;
    # a lagged p' leaves an O(dt_acoustic) force error that visibly
    # detunes the NH run from the hydrostatic limit) ----------------------
    nonhydro = s.pz_x is not None
    # ---- re-fill the transported fields' halos before the backward PGF:
    # the transport stencil exhausts the inbound halo, so delp_new/pt_new
    # halo cells are invalid - the corner interpolation feeding the PGF
    # would read them, an O(1) error at on-edge corners whose x/y
    # difference then DIVERGES ~1/h with resolution (measured: the entire
    # edge-band imbalance at c48 sits in the first interior column,
    # 1.7e-4 vs 7e-6 one column in).  FV3 likewise halo-updates pk/gz
    # before its p_grad stage.
    delp_f = refill(delp_new[islice])
    pt_f = refill(pt_new[islice])
    if nonhydro:
        from .nh_solver import vertical_acoustic_solve

        zeros_if = jnp.zeros_like(w_adv[..., :1])
        w_if = jnp.concatenate(
            [zeros_if, 0.5 * (w_adv[..., :-1] + w_adv[..., 1:]), zeros_if],
            axis=-1)
        w_if, delz_new = vertical_acoustic_solve(
            w_if, delz_adv, pt_new, delp_new, dt, ptop)
        # clamp: under extreme forcing the linearized solve can overshoot
        # to nonpositive thickness, which would flip the sign of the phi'
        # force below and poison the carried state (matches the delz_adv
        # clamp above)
        delz_new = jnp.maximum(delz_new, 1.0)
        w_new = 0.5 * (w_if[..., :-1] + w_if[..., 1:])
        delz_f = refill(delz_new[islice])
        nh_fields = nh_perturbation_fields(delp_f, pt_f, delz_f, ptop)
    else:
        w_new = delz_new = None
        nh_fields = None

    # ---- hydrostatic PGF fields from updated mass/temperature (backward)
    pkz, phi_mid = _hydrostatic_fields(delp_f, pt_f, ptop)

    u_new, v_new = wind_part(s, m, uct, vct, crx, cry, pt_f, pkz,
                             phi_mid + m.phis, nh_fields, dt, hord, d2_bg,
                             hord_mt=hord_mt,
                             vort=vort_c if chart is not None else None,
                             div_c_in=div_cg, vtx_damp=vtx_damp)

    return SubstepOut(
        u=u_new[isliceu],
        v=v_new[islicev],
        delp=delp_new[islice],
        pt=pt_new[islice],
        q=None if q_new is None else q_new[islice],
        w=None if w_new is None else w_new[islice],
        delz=None if delz_new is None else delz_new[islice],
        mfx=mf.fx[:, h:h + ny, h:h + nx + 1],
        mfy=mf.fy[:, h:h + ny + 1, h:h + nx],
        uc=uct[:, h:h + ny, h:h + nx + 1],
        vc=vct[:, h:h + ny + 1, h:h + nx],
        uct_pad=uct,
        vct_pad=vct,
        mfx_pad=mf.fx,
        mfy_pad=mf.fy,
        pd_fill=delp_f,
        pt_fill=pt_f,
        pz_fill=delz_f if nonhydro else None,
    )
