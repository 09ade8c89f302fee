"""Hierarchical per-phase timing of the dycore step.

The reference mines a full component tree (DYN/MOIST/RADIATION/...) out of
GEOS logs and renders it as sunburst/Sankey plots
(/root/reference/src/tcn/benchmark/geos_log_parser.py:79-269,
benchmark/report.py:38-72).  This framework owns the model, so the tree
is MEASURED, not scraped: each phase runs as its own jitted function in a
chained loop (output feeds input, one device sync per repetition block) so
a phase's number is its pipelined device time, not the cost of a host
sync after every call.

Produces a PhaseTree: step -> {halo_fill, substep x n_split, remap, hs
forcing} with derived percentages, serialized into BenchmarkRecord.extra
and rendered by benchmark/plots.py as the sunburst analog.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp


def _chain_time(fn: Callable, args, inner: int = 30, reps: int = 5) -> float:
    """Median seconds per call; calls chained (out -> in), one sync per
    block of `inner` calls."""
    out = fn(*args)
    jax.block_until_ready(out)
    n_args = len(args)
    ts = []
    for _ in range(reps):
        cur = args
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*cur)
            cur = out if isinstance(out, tuple) and len(out) == n_args else args
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / inner)
    ts.sort()
    return ts[len(ts) // 2]


def _bind(fn: Callable, consts) -> Callable:
    """jit(fn)(*args, consts) as a function of args alone.  The arrays in
    `consts` ride as jit arguments: closed over, they would be baked into
    the HLO as constants, which XLA compiles slowly at large grids."""
    jitted = jax.jit(fn)
    return lambda *args: jitted(*args, consts)


# leaves whose time is already inside another leaf (the substep stage
# split, the NH solve inside the substep): reported, not accounted
_DETAIL_PREFIXES = ("substep: ", "nh vertical")


@dataclass
class PhaseTree:
    """Measured phase breakdown of one model step (seconds)."""

    full_step_s: float
    phases: Dict[str, float]  # leaf name -> s per STEP (already x n_split)

    @property
    def accounted_s(self) -> float:
        return sum(v for k, v in self.phases.items()
                   if not k.startswith(_DETAIL_PREFIXES))

    def to_dict(self) -> dict:
        tot = self.full_step_s
        return {
            "full_step_ms": 1e3 * tot,
            "phases_ms": {k: 1e3 * v for k, v in self.phases.items()},
            "phases_pct": {k: (100.0 * v / tot if tot else 0.0)
                           for k, v in self.phases.items()},
            "unaccounted_ms": 1e3 * max(0.0, tot - self.accounted_s),
        }

    def render(self) -> str:
        d = self.to_dict()
        lines = [f"step {d['full_step_ms']:.2f} ms"]
        for k, v in sorted(d["phases_ms"].items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:<22s} {v:8.2f} ms  {d['phases_pct'][k]:5.1f}%")
        lines.append(f"  {'(unaccounted)':<22s} {d['unaccounted_ms']:8.2f} ms")
        return "\n".join(lines)


def measure_phases(model, state, inner: int = 30,
                   forcing_fn: Optional[Callable] = None) -> PhaseTree:
    """Measure the phase tree of a dycore-driven model on the current
    backend.  Phases are timed as independent jitted functions with
    chained inputs; `substep` is scaled by n_split to per-step cost.

    The substep leaf is further split into its c_sw / transport / wind
    stages, and the tracer z_tracer pass and NH vertical solve get their own leaves -
    the reference's tree is multi-level
    (/root/reference/src/tcn/benchmark/geos_log_parser.py:79-269).

    forcing_fn(u, v, pt, delp) -> (u, v, pt): the model's column physics;
    defaults to Held-Suarez forcing."""
    from ..dycore.sw import (_hydrostatic_fields, c_sw, d_sw_substep,
                             fill_substep, transport_part, wind_part)
    from ..ops.remap import remap_field
    from ..physics.held_suarez import held_suarez_forcing

    cfg = model.config
    ops, m = model.ctx.ops, model.ctx.metrics
    dt_ac = cfg.dt / (cfg.k_split * cfg.n_split)

    full = _chain_time(lambda s: model.step_fn(s), (state,), inner=inner)

    def fill_then_slice(u, v, delp, pt, c):
        st = fill_substep(ops, u, v, delp, pt, None)
        h, n = ops.h, ops.n
        return (st.pu[:, h:h + n + 1, h:h + n],
                st.pv[:, h:h + n, h:h + n + 1],
                st.pd_x[:, h:h + n, h:h + n],
                st.pt_x[:, h:h + n, h:h + n])

    fill_t = _chain_time(_bind(fill_then_slice, None),
                         (state.u, state.v, state.delp, state.pt),
                         inner=inner)

    def one_substep(u, v, delp, pt, m):
        st = fill_substep(ops, u, v, delp, pt, None)
        o = d_sw_substep(st, m, ops, dt_ac, cfg.ptop, hord=cfg.hord,
                         d2_bg=cfg.d2_bg, advect_tracers=False,
                         hord_mt=cfg.hord_mt, hord_tm=cfg.hord_tm)
        return o.u, o.v, o.delp, o.pt

    sub_t = _chain_time(_bind(one_substep, m),
                        (state.u, state.v, state.delp, state.pt),
                        inner=inner)

    # ---- substep stage split --------------------------------------------
    stage_phases: Dict[str, float] = {}
    n_sub = cfg.k_split * cfg.n_split
    st0 = fill_substep(ops, state.u, state.v, state.delp, state.pt,
                       None)

    def stage_csw_pair(pu, pv, c):
        st0_, m_ = c
        return c_sw(st0_._replace(pu=pu, pv=pv), m_, 0.5 * dt_ac, cfg.ptop)

    # single-output variant: (uct, vct) shapes are transposed relative to
    # (pu, pv), so the chained-input trick would feed mismatched shapes -
    # time with fixed args instead
    csw_t = _chain_time(
        _bind(lambda pu, pv, c: stage_csw_pair(pu, pv, c)[0], (st0, m)),
        (st0.pu, st0.pv), inner=inner)
    uct, vct = _bind(stage_csw_pair, (st0, m))(st0.pu, st0.pv)[:2]
    fluxes = (uct * dt_ac * m.rdxc, vct * dt_ac * m.rdyc,
              uct * dt_ac * m.dy, vct * dt_ac * m.dx)

    def stage_transport(pdx, pdy, c):
        st0_, m_, (crx, cry, xfx, yfx) = c
        st = st0_._replace(pd_x=pdx, pd_y=pdy)
        dn, ptn, *_ = transport_part(st, m_, crx, cry, xfx, yfx,
                                     cfg.hord, False,
                                     hord_tm=cfg.hord_tm)
        return dn, ptn

    transport = _bind(stage_transport, (st0, m, fluxes))
    tr_t = _chain_time(transport, (st0.pd_x, st0.pd_y), inner=inner)
    delp_n, pt_n = transport(st0.pd_x, st0.pd_y)
    h_ = ops.h
    isl = (slice(None), slice(h_, h_ + ops.ny), slice(h_, h_ + ops.nx))

    def stage_wind(pu, pv, c):
        st0_, m_, (crx, cry, _, _), uct_, vct_, delp_n_, pt_n_ = c
        st = st0_._replace(pu=pu, pv=pv)
        # post-transport re-fill + hydrostatic fields belong to the
        # wind stage of the production substep (sw.d_sw_substep)
        dfp = ops.fill(delp_n_[isl], "x")
        ptf = ops.fill(pt_n_[isl], "x")
        pkz_n, phi_n = _hydrostatic_fields(dfp, ptf, cfg.ptop)
        return wind_part(st, m_, uct_, vct_, crx, cry, ptf, pkz_n,
                         phi_n, None, dt_ac, cfg.hord, cfg.d2_bg,
                         hord_mt=cfg.hord_mt)

    wind_t = _chain_time(
        _bind(stage_wind, (st0, m, fluxes, uct, vct, delp_n, pt_n)),
        (st0.pu, st0.pv), inner=inner)
    stage_phases = {
        "substep: c_sw (xN)": csw_t * n_sub,
        "substep: transport (xN)": tr_t * n_sub,
        "substep: wind_part (xN)": wind_t * n_sub,
    }

    # ---- tracer z_tracer pass + NH vertical solve -----------------------
    if cfg.z_tracer and cfg.ntracers and state.q is not None:
        from ..dycore.fv_dynamics import _advect_tracers_accumulated

        Ny = ops.ny + 2 * ops.h
        Nx = ops.nx + 2 * ops.h
        F, K = state.delp.shape[0], state.delp.shape[-1]

        def stage_tracer(q, c):
            delp, m_ = c
            tacc = (jnp.zeros((F, Ny, Nx + 1, K)),
                    jnp.zeros((F, Ny + 1, Nx, K)),
                    jnp.zeros((F, Ny, Nx + 1, K)),
                    jnp.zeros((F, Ny + 1, Nx, K)))
            return _advect_tracers_accumulated(q, delp, tacc, ops, m_,
                                               cfg.hord, cfg.q_split, dt_ac)

        stage_phases["tracer transport"] = _chain_time(
            _bind(stage_tracer, (state.delp, m)), (state.q,),
            inner=inner) * cfg.k_split

    if not cfg.hydrostatic:
        from ..dycore.nh_solver import vertical_acoustic_solve

        delz0 = jnp.maximum(jnp.abs(state.delz) + 1.0, 1.0)
        w_if0 = jnp.zeros(state.delp.shape[:-1]
                          + (state.delp.shape[-1] + 1,))

        def stage_nh(w_if, delz, c):
            pt, delp = c
            return vertical_acoustic_solve(w_if, delz, pt, delp, dt_ac,
                                           cfg.ptop)

        stage_phases["nh vertical solve (xN)"] = _chain_time(
            _bind(stage_nh, (state.pt, state.delp)), (w_if0, delz0),
            inner=inner) * n_sub

    pe1 = cfg.ptop + jnp.concatenate(
        [jnp.zeros_like(state.delp[..., :1]),
         jnp.cumsum(state.delp, axis=-1)], axis=-1)
    pe2 = model.ctx.ak + model.ctx.bk * pe1[..., -1:]

    def remap_one(pt, c):
        return remap_field(pt, c[0], c[1], cfg.kord)

    remap_t = _chain_time(_bind(remap_one, (pe1, pe2)), (state.pt,),
                          inner=inner)
    # per step: pt + tracers + w/delz (NH) + u and v staggered columns
    n_remaps = 1 + cfg.ntracers + (2 if not cfg.hydrostatic else 0) + 2

    if forcing_fn is None:
        def forcing_fn(u, v, pt, delp):
            return held_suarez_forcing(u, v, pt, delp, model.lats,
                                       cfg.ptop, cfg.dt)

    forcing_t = _chain_time(_bind(forcing_fn, state.delp),
                            (state.u, state.v, state.pt), inner=inner)

    phases = {
        "halo_fill (xN)": fill_t * n_sub,
        "substep-minus-fill (xN)": max(sub_t - fill_t, 0.0) * n_sub,
        "vertical remap": remap_t * n_remaps * cfg.k_split,
        "forcing/physics": forcing_t,
    }
    phases.update(stage_phases)
    return PhaseTree(full_step_s=full, phases=phases)
