"""Full hydrostatic FV dynamics step: acoustic substeps + vertical remap.

The in-repo equivalent of the external gtFV3 `fv_dynamics` the reference
CI validates/benchmarks per timestep (hot-loop contract in SURVEY.md SS3.3;
state vector /root/reference/src/tcn/py_ftn_interface/example_def_dycore.yaml:46-70).

Structure per model timestep `dt`:
    k_split x [ n_split x d_sw acoustic substep  ->  vertical remap ]
then diagnostics (ps, pe, pk, ua/va, omga) are refreshed.

Everything is one jit-traceable pure function over the DycoreState pytree;
substeps are unrolled Python loops (static n_split) so XLA fuses across
them.  D-grid winds are remapped on their own staggered columns (delp
averaged to the staggered points), as in FV3's Lagrangian_to_Eulerian.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import DycoreConfig
from ..core.grid import Grid, KAPPA
from ..core.state import DycoreState
from ..ops.remap import remap_field
from ..ops.vertical import cumsum_k, interfaces_from_delp
from ..parallel.halo import HaloOps, build_halo_ops
from .sw import (PaddedMetrics, SWState, d_sw_substep, fill_substep,
                 padded_metrics)


class DycoreContext(NamedTuple):
    """Static (trace-time constant) data for the dynamics."""

    ops: HaloOps
    metrics: PaddedMetrics
    ak: jnp.ndarray  # [K+1]
    bk: jnp.ndarray
    config: DycoreConfig
    # cube-corner chart reconstruction weights (core/chart_corners.py);
    # None when config.chart_corners is off
    chart: object = None
    # staggered-halo resample tables (sw.StagResample) - kept for the
    # exchange-based damping formulation (sw.damping_divergence, the
    # validated alternative to the in-kernel blend; see PaddedMetrics
    # .div_blend) and for future staggered-halo consumers
    stag: object = None


def build_context(config: DycoreConfig, grid: Grid, ak: np.ndarray,
                  bk: np.ndarray, phis: np.ndarray = None) -> DycoreContext:
    """phis: optional unpadded [6, n, n] surface geopotential (terrain in
    the PGF - both hydrostatic and NH regimes); None = flat."""
    chart = None
    if config.chart_corners:
        from ..core.chart_corners import build_chart_tables

        chart = build_chart_tables(config.npx, config.halo)
    from .sw import stag_resample_tables

    return DycoreContext(
        ops=build_halo_ops(config.npx, config.halo),
        metrics=padded_metrics(grid, phis=phis,
                               chart_cosa=config.chart_corners),
        ak=jnp.asarray(ak),
        bk=jnp.asarray(bk),
        config=config,
        chart=chart,
        stag=stag_resample_tables(grid),
    )


def _remap_winds(u, v, delp_padded, ak, bk, ptop, h, ny, nx, rm):
    """Remap D-grid winds on their own staggered columns."""
    # delp at u-points (average across the y-interface), interior + the
    # face-boundary interfaces (uses one halo row)
    dpu = 0.5 * (delp_padded[:, h - 1:h + ny, h:h + nx] +
                 delp_padded[:, h:h + ny + 1, h:h + nx])  # [6, ny+1, nx, K]
    pe1u = interfaces_from_delp(dpu, ptop)
    pe2u = ak + bk * pe1u[..., -1:]
    u_new = rm(u, pe1u, pe2u)

    dpv = 0.5 * (delp_padded[:, h:h + ny, h - 1:h + nx] +
                 delp_padded[:, h:h + ny, h:h + nx + 1])  # [6, ny, nx+1, K]
    pe1v = interfaces_from_delp(dpv, ptop)
    pe2v = ak + bk * pe1v[..., -1:]
    v_new = rm(v, pe1v, pe2v)
    return u_new, v_new


def _advect_tracers_accumulated(q, delp0, tacc, ops, m, hord, q_split,
                                dt, chart=None):
    """FV3 z_tracer mode: advect tracers once per remap interval with the
    time-accumulated Courant numbers / area fluxes / mass fluxes, split
    into `q_split` subcycles to keep the per-pass Courant < 1.  Exactly
    preserves q == const (fluxes reduce to the accumulated mass fluxes;
    the chart corner resample preserves constants exactly too).

    tacc carries (uct_acc, vct_acc, mfx_acc, mfy_acc); the Courant /
    area-flux factors are rebuilt here from the static metrics (one
    multiply per remap interval instead of four accumulated arrays)."""
    from ..ops.fvtp2d import ddx, ddy, fvtp2d

    if chart is not None:
        fx = lambda a: chart.apply_scalar(ops.fill(a, "x"), "x")
        fy = lambda a: fx(a)
    else:
        fx = lambda a: ops.fill(a, "x")
        fy = lambda a: ops.fill(a, "y")

    uacc, vacc, mfx, mfy = (a / q_split for a in tacc)
    h, ny, nx = ops.h, ops.ny, ops.nx
    islice = (slice(None), slice(h, h + ny), slice(h, h + nx))
    delp = delp0
    T = q.shape[-1]

    crx = uacc * dt * m.rdxc
    cry = vacc * dt * m.rdyc
    xfx = uacc * dt * m.dy
    yfx = vacc * dt * m.dx
    for _ in range(q_split):
        pd_x = fx(delp)
        delp_new = (pd_x + (ddx(mfx) + ddy(mfy)) * m.rarea)[islice]
        qs = []
        for t in range(T):
            qx = fx(q[..., t])
            qy = qx if chart is not None else ops.fill(q[..., t], "y")
            qf = fvtp2d(qx, qy, crx, cry, xfx, yfx, m.area, hord=hord,
                        mfx=mfx, mfy=mfy)
            qdp = (qx * pd_x + (ddx(qf.fx) + ddy(qf.fy)) * m.rarea)[islice]
            qs.append(qdp / delp_new)
        q = jnp.stack(qs, axis=-1)
        delp = delp_new
    return q


def fv_dynamics_step(state: DycoreState, ctx: DycoreContext) -> DycoreState:
    cfg = ctx.config
    ops, m = ctx.ops, ctx.metrics
    # block extents come from the filler (== cfg.npx single-device; the
    # per-device rectangle under subtile sharding, parallel/subtile.py)
    h, ny, nx = cfg.halo, ops.ny, ops.nx
    dt_acoustic = cfg.dt / (cfg.k_split * cfg.n_split)

    u, v = state.u, state.v
    delp, pt, q = state.delp, state.pt, state.q
    mfx_acc = jnp.zeros_like(state.mfx)
    mfy_acc = jnp.zeros_like(state.mfy)
    uc = vc = None

    has_q = q is not None and q.shape[-1] > 0
    if not has_q:
        q = None
    z_tracer = cfg.z_tracer and has_q  # accumulated-flux tracer transport
    substep_tracers = has_q and not z_tracer
    nonhydro = not cfg.hydrostatic

    if nonhydro:
        from .nh_solver import hydrostatic_delz

        # arm delz on the first step (init ships zeros): exact discrete
        # hydrostatic balance => p' == 0 until the dynamics perturbs it
        delz = jnp.where(state.delz > 1.0, state.delz,
                         hydrostatic_delz(delp, pt, cfg.ptop))
        w = state.w
    else:
        w = delz = None

    chart = ctx.chart
    # the interior/rim split needs the pipelined scalar pads
    rim_split = cfg.rim_split and cfg.overlap_fills
    # damping formulation (DycoreConfig.damping_exchange): exchange for
    # small grids (full checkerboard control - the blend's
    # checkerboard-blind bands cover most of a c12 face and let
    # grid-scale noise grow to NaN over ~50 days), in-kernel blend for
    # large (no staggered exchange glue)
    use_exchange = cfg.damping_exchange == "exchange" or (
        cfg.damping_exchange == "auto" and cfg.npx <= 96)
    stag_for_substep = ctx.stag if use_exchange else None

    def substep_fn(s, rim_loc=None):
        return d_sw_substep(
            s, m, ops, dt_acoustic, cfg.ptop, hord=cfg.hord,
            d2_bg=cfg.d2_bg, advect_tracers=substep_tracers,
            hord_mt=cfg.hord_mt, hord_tm=cfg.hord_tm, chart=chart,
            rim_loc=rim_loc, stag_tabs=stag_for_substep,
            vtx_damp=cfg.vtx_damp)

    zf = jnp.zeros((), jnp.float32)

    def scalar_fills(delp_, pt_, q_, w_, delz_):
        """Padded scalar fields for ONE substep (overlap-pipelined mode):
        issued as soon as their producers (the transport stage) are done,
        dataflow-independent of the wind update, so on a sharded mesh the
        ppermute exchanges overlap with wind_part compute under XLA's
        latency-hiding scheduler.  Under chart_corners the corrected
        x-fill serves both stencil directions (half the exchanges)."""
        if chart is not None:
            fx = lambda a: chart.apply_scalar(ops.fill(a, "x"), "x")
            fy = lambda a, same: same
        else:
            fx = lambda a: ops.fill(a, "x")
            fy = lambda a, same: ops.fill(a, "y")
        pd = fx(delp_)
        pt_p = fx(pt_)
        pq = fx(q_) if substep_tracers else zf
        pw = fx(w_) if nonhydro else zf
        pz = fx(delz_) if nonhydro else zf
        return (
            pd, fy(delp_, pd),
            pt_p, fy(pt_, pt_p),
            pq, fy(q_, pq) if substep_tracers else zf,
            pw, fy(w_, pw) if nonhydro else zf,
            pz, fy(delz_, pz) if nonhydro else zf,
        )

    def substep(carry, _):
        (u, v, delp, pt, q, w, delz, mfx_acc, mfy_acc, tacc, pads,
         _uc, _vc) = carry
        if cfg.overlap_fills:
            pu, pv = ops.fill_dgrid(u, v)
            if rim_split:
                # local-only padded winds for the interior/rim split: the
                # core chain consumes these (no exchange dependency)
                zpad = ((0, 0), (h, h), (h, h), (0, 0))
                rim_loc = (jnp.pad(u, zpad), jnp.pad(v, zpad))
            else:
                rim_loc = None
            s = SWState(
                pu=pu, pv=pv,
                pd_x=pads[0], pd_y=pads[1], pt_x=pads[2], pt_y=pads[3],
                pq_x=pads[4] if substep_tracers else None,
                pq_y=pads[5] if substep_tracers else None,
                pw_x=pads[6] if nonhydro else None,
                pw_y=pads[7] if nonhydro else None,
                pz_x=pads[8] if nonhydro else None,
                pz_y=pads[9] if nonhydro else None)
        else:
            rim_loc = None
            s = fill_substep(ops, u, v, delp, pt,
                             q if substep_tracers else None,
                             w=w if nonhydro else None,
                             delz=delz if nonhydro else None,
                             chart=chart)
        out = substep_fn(s, rim_loc)
        if nonhydro:
            # the implicit vertical acoustic solve runs inside
            # d_sw_substep (before the wind update, so the NH pressure
            # force is backward, from the solved fields)
            w2, delz2 = out.w, out.delz
        else:
            w2, delz2 = w, delz
        q2 = out.q if substep_tracers else q
        if z_tracer:
            tacc2 = tuple(
                a + b for a, b in zip(tacc, (out.uct_pad, out.vct_pad,
                                             out.mfx_pad, out.mfy_pad)))
            # the interior mass-flux diagnostic accumulators are SLICES
            # of the padded tacc sums - accumulating them separately
            # would repeat two full-array passes per substep
            macc2 = (mfx_acc, mfy_acc)
        else:
            tacc2 = tacc
            macc2 = (mfx_acc + out.mfx, mfy_acc + out.mfy)
        if cfg.overlap_fills:
            # reuse the substep's mid-step refills of delp/pt (/delz):
            # they are exactly fill(new interior, "x") - re-exchanging
            # would repeat the identical halo assembly.  Only w (NH) and
            # per-substep tracers still need a fresh exchange.
            if chart is not None:
                fx = lambda a: chart.apply_scalar(ops.fill(a, "x"), "x")
                fy = lambda a, same: same
            else:
                fx = lambda a: ops.fill(a, "x")
                fy = lambda a, same: ops.fill(a, "y")
            pq = fx(q2) if substep_tracers else zf
            pw = fx(w2) if nonhydro else zf
            pads2 = (
                out.pd_fill, fy(out.delp, out.pd_fill),
                out.pt_fill, fy(out.pt, out.pt_fill),
                pq, fy(q2, pq) if substep_tracers else zf,
                pw, fy(w2, pw) if nonhydro else zf,
                out.pz_fill if nonhydro else zf,
                fy(out.delz, out.pz_fill) if nonhydro else zf,
            )
        else:
            pads2 = pads
        # uc/vc ride the CARRY (only the final substep's values are
        # consumed): a scan OUTPUT would stack n_split full copies in
        # device memory
        return (out.u, out.v, out.delp, out.pt, q2,
                w2, delz2,
                macc2[0], macc2[1],
                tacc2, pads2, out.uc, out.vc), None

    Ny = ny + 2 * cfg.halo
    Nx = nx + 2 * cfg.halo
    K = cfg.npz
    F = delp.shape[0]  # 6 faces, or 1 inside a face-sharded shard_map

    def zero_tacc():
        zx = ops.zeros((F, Ny, Nx + 1, K))
        zy = ops.zeros((F, Ny + 1, Nx, K))
        return (zx, zy, zx, zy)

    for _ks in range(cfg.k_split):
        delp0 = delp  # tracer-interval start mass
        # scan over acoustic substeps: one compiled body instead of an
        # n_split-times unrolled HLO (shorter compiles)
        pads0 = scalar_fills(delp, pt, q if has_q else zf,
                             w if nonhydro else zf,
                             delz if nonhydro else zf) \
            if cfg.overlap_fills else (zf,) * 10
        carry = (u, v, delp, pt,
                 q if has_q else zf,
                 w if nonhydro else zf,
                 delz if nonhydro else zf,
                 mfx_acc, mfy_acc, zero_tacc(), pads0,
                 ops.zeros((F, ny, nx + 1, K)),
                 ops.zeros((F, ny + 1, nx, K)))
        carry, _ = jax.lax.scan(substep, carry, None,
                                length=cfg.n_split)
        (u, v, delp, pt, qq, ww, zz, mfx_acc, mfy_acc, tacc, pads,
         uc, vc) = carry
        if z_tracer:
            # interior mass-flux accumulators from the padded tacc sums
            mfx_acc = mfx_acc + tacc[2][:, h:h + ny, h:h + nx + 1]
            mfy_acc = mfy_acc + tacc[3][:, h:h + ny + 1, h:h + nx]
        if substep_tracers:
            q = qq
        if nonhydro:
            w, delz = ww, zz

        if z_tracer:
            q = _advect_tracers_accumulated(
                q, delp0, tacc, ops, m, cfg.hord, cfg.q_split,
                dt_acoustic, chart=chart)

        # ---- vertical remap back to the reference hybrid coordinate ----
        pe1 = interfaces_from_delp(delp, cfg.ptop)
        ps = pe1[..., -1]
        pe2 = ctx.ak + ctx.bk * ps[..., None]
        delp_new = pe2[..., 1:] - pe2[..., :-1]
        def rm(q, pe1_, pe2_):
            return remap_field(q, pe1_, pe2_, cfg.kord)

        # pt, tracers (and NH w / specific volume) share (pe1, pe2)
        fields = [pt]
        nq = 0 if q is None else q.shape[-1]
        fields += [q[..., t] for t in range(nq)]
        if nonhydro:
            # w remaps mass-weighted like any scalar; delz via its
            # per-unit-mass form (specific volume * g) so total column
            # height is conserved through the remap
            fields += [w, delz / jnp.maximum(delp, 1e-3)]
        out = [rm(f, pe1, pe2) for f in fields]
        pt = out[0]
        if q is not None:
            q = jnp.stack(out[1:1 + nq], axis=-1)
        if nonhydro:
            w = out[1 + nq]
            delz = out[2 + nq] * delp_new
        # in overlap mode the final substep's carried pd_x fill IS
        # fill(delp, "x") - reuse it instead of re-exchanging
        dpad = pads[0] if cfg.overlap_fills else ops.fill(delp, "x")
        u, v = _remap_winds(u, v, dpad, ctx.ak, ctx.bk, cfg.ptop, h, ny, nx,
                            rm)
        delp = delp_new

    # w/delz are prognosed in NH mode (advected in d_sw, implicit vertical
    # solve per acoustic substep, p' fed back into the horizontal PGF);
    # hydrostatic mode carries them passively.
    if nonhydro and cfg.w_sponge_p > 0.0:
        # model-top Rayleigh sponge on w (FV3's fast w damping role):
        # upward-propagating acoustic/gravity waves are absorbed instead
        # of reflecting off the rigid model top
        pe_s = interfaces_from_delp(delp, cfg.ptop)
        pm_s = 0.5 * (pe_s[..., 1:] + pe_s[..., :-1])
        fac = jnp.where(pm_s < cfg.w_sponge_p,
                        jnp.float32(np.exp(-cfg.dt / cfg.w_sponge_tau)),
                        1.0)
        w = w * fac
    w_out = w if nonhydro else state.w
    delz_out = delz if nonhydro else state.delz

    # ---- diagnostics ----------------------------------------------------
    pe = interfaces_from_delp(delp, cfg.ptop)
    ps = pe[..., -1]
    ua = 0.5 * (u[:, :-1, :] + u[:, 1:, :])
    va = 0.5 * (v[:, :, :-1] + v[:, :, 1:])
    # omga: hydrostatic pressure velocity diagnosed from the accumulated
    # mass-flux convergence - the Eulerian dp/dt at the hybrid layer
    # midpoint (the horizontal-advection part of the full Dp/Dt is not
    # included; adequate for the reference's diagnostic role)
    hs = cfg.halo
    conv = (((mfx_acc[:, :, :-1] - mfx_acc[:, :, 1:])
             + (mfy_acc[:, :-1, :] - mfy_acc[:, 1:, :]))
            * m.rarea[:, hs:hs + ny, hs:hs + nx] / cfg.dt)
    cum = cumsum_k(conv)
    omga = cum - 0.5 * conv

    return DycoreState(
        u=u, v=v, delp=delp, pt=pt,
        q=q if has_q else state.q,  # preserve an empty [..., 0] tracer dim
        w=w_out, delz=delz_out, phis=state.phis,
        ps=ps,
        omga=omga,
        ua=ua, va=va,
        mfx=mfx_acc, mfy=mfy_acc,
    )


def exner_mid(delp: jnp.ndarray, ptop: float) -> jnp.ndarray:
    """Layer-mean Exner function pkz (T = pt * pkz)."""
    pe = interfaces_from_delp(delp, ptop)
    pk = (pe / 1.0e5) ** KAPPA
    peln = jnp.log(pe)
    return (pk[..., 1:] - pk[..., :-1]) / (
        KAPPA * (peln[..., 1:] - peln[..., :-1]))
