"""Aquaplanet model driver: moist dynamics over a zonally-uniform ocean.

Counterpart of the reference's `geos_aq` experiment
(/root/reference/src/tcn/ci/data/experiments.yaml geos_aq +
src/tcn/ci/pipeline/aquaplanet.py, which drives GEOS's own gcm_run.j).
Here the moist model is in-repo: the hydrostatic FV dycore advects vapor /
cloud liquid / rain tracers, and the physics chain per step is

  surface fluxes (bulk formulas over prescribed SST(lat), APE 'Qobs')
  -> shallow-convective mixing (cup_gf_sh)
  -> GFDL-lite single-moment microphysics (saturation adjustment, rain,
     sedimentation, latent heating)
  -> Held-Suarez-style radiative relaxation (keeps the run bounded without
     a radiation scheme)

Tracer layout: q[..., 0] = qv, q[..., 1] = ql, q[..., 2] = qr.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp

from ..ops.vertical import interfaces_from_delp
import numpy as np

from ..core.config import DycoreConfig
from ..core.grid import Grid, build_grid
from ..core.state import DycoreState, init_state
from ..core.vertical import hybrid_coordinate, sigma_coordinate
from ..dycore.fv_dynamics import DycoreContext, build_context, exner_mid, \
    fv_dynamics_step
from ..physics import standalone as K
from ..physics.held_suarez import HSLatitudes, held_suarez_forcing, \
    hs_latitudes
from ..physics.thermo import CP_AIR, GRAV, HLV, RDGAS, qsat
from .step import HoistedStep


def sst_qobs(lat: jnp.ndarray) -> jnp.ndarray:
    """Aqua-Planet Experiment 'Qobs' SST profile [K]."""
    phi = jnp.clip(jnp.abs(lat), 0.0, jnp.pi / 3)
    x = jnp.sin(1.5 * phi) ** 2
    return 273.16 + 27.0 * (1.0 - 0.5 * (x + x * x))


@dataclass(frozen=True)
class AquaplanetModel:
    config: DycoreConfig
    grid: Grid
    ctx: DycoreContext
    lats: HSLatitudes
    step_fn: HoistedStep
    # the moist physics chain alone (surface fluxes -> shallow convection
    # -> microphysics -> radiative relaxation); exposed so the benchmark
    # phase tree can time it as its own leaf
    physics_fn: Callable[[DycoreState], DycoreState] = None

    def init(self, perturb: float = 1.0e-3, seed: int = 0) -> DycoreState:
        ak = np.asarray(self.ctx.ak)
        bk = np.asarray(self.ctx.bk)
        state = init_state(self.config, self.grid, ak, bk, perturb=perturb,
                           seed=seed)
        # moist init: 80% RH below sigma=0.8, dry aloft
        pkz = exner_mid(state.delp, self.config.ptop)
        t = state.pt * pkz
        pe = self.config.ptop + interfaces_from_delp(state.delp, 0.0)
        p_mid = 0.5 * (pe[..., 1:] + pe[..., :-1])
        sigma = p_mid / pe[..., -1:]
        qv0 = jnp.where(sigma > 0.5, 0.6 * qsat(t, p_mid), 1e-6)
        q = state.q.at[..., 0].set(qv0.astype(state.q.dtype))
        return dataclasses.replace(state, q=q)

    def run(self, state: DycoreState, steps: int) -> DycoreState:
        """`steps` model steps as one jitted scan (HoistedStep.run)."""
        return self.step_fn.run(state, steps)

    def run_with_history(self, state: DycoreState, steps: int):
        def body(s, _):
            s2 = self.step_fn(s)
            diag = {
                "ps_mean": jnp.mean(s2.ps),
                "umax": jnp.max(jnp.abs(s2.u)),
                "qv_mean": jnp.mean(s2.q[..., 0]),
                "precip_total": jnp.float32(0.0),
            }
            return s2, diag

        return jax.lax.scan(body, state, None, length=steps)


def build_model(config: DycoreConfig) -> AquaplanetModel:
    assert config.ntracers >= 3, "aquaplanet needs qv/ql/qr tracers"
    grid = build_grid(config.npx, config.halo)
    if config.vertical == "sigma":
        ak, bk = sigma_coordinate(config.npz, config.ptop)
    else:
        ak, bk = hybrid_coordinate(config.npz, config.ptop)
    ctx = build_context(config, grid, ak, bk)
    lats = hs_latitudes(grid)
    dt = config.dt

    def physics(state: DycoreState,
                lats_loc: HSLatitudes = lats) -> DycoreState:
        # lats_loc: the block-local latitudes under subtile sharding (the
        # SST profile derives from them, so it localizes for free; jit
        # constant-folds the single-device case)
        sst_loc = sst_qobs(lats_loc.lat_c)
        pkz = exner_mid(state.delp, config.ptop)
        t = state.pt * pkz
        pe = config.ptop + interfaces_from_delp(state.delp, 0.0)
        p_mid = 0.5 * (pe[..., 1:] + pe[..., :-1])
        # clean advection undershoots conservatively before physics
        qv = K.fill_q2_zero(state.q[..., 0], state.delp)
        ql = K.fill_q2_zero(state.q[..., 1], state.delp)
        qr = K.fill_q2_zero(state.q[..., 2], state.delp)

        # ---- surface fluxes (bulk, lowest layer) ------------------------
        cd = 1.2e-3
        wind = jnp.sqrt(state.ua[..., -1] ** 2 + state.va[..., -1] ** 2) + 1.0
        rho_s = p_mid[..., -1] / (RDGAS * t[..., -1])
        dp_bot = state.delp[..., -1]
        qs_sst = qsat(sst_loc, pe[..., -1])
        evap = cd * wind * rho_s * jnp.maximum(qs_sst - qv[..., -1], 0.0)
        shf = cd * wind * rho_s * CP_AIR * (sst_loc - t[..., -1])
        qv = qv.at[..., -1].add(evap * GRAV * dt / dp_bot)
        t = t.at[..., -1].add(shf * GRAV * dt / (CP_AIR * dp_bot))

        # ---- shallow convection -----------------------------------------
        t, qv = K.cup_gf_sh(t, qv, p_mid, state.delp, dt)

        # ---- microphysics ----------------------------------------------
        qi = jnp.zeros_like(ql)
        mp = K.gfdl_microphysics(t, qv, ql, qr, qi, p_mid, state.delp, dt)
        t, qv, ql, qr = mp.t, mp.qv, mp.ql, mp.qr

        # ---- radiative relaxation (HS-style, weak) ----------------------
        pt = t / pkz
        q = state.q.at[..., 0].set(qv).at[..., 1].set(ql).at[..., 2].set(qr)
        u, v, pt = held_suarez_forcing(state.u, state.v, pt, state.delp,
                                       lats_loc, config.ptop, dt)
        return dataclasses.replace(state, u=u, v=v, pt=pt, q=q)

    def step(state: DycoreState, ctx_lats) -> DycoreState:
        from ..parallel.halo import symmetrize_shared_edges

        ctx_, lats_ = ctx_lats
        state = fv_dynamics_step(state, ctx_)
        state = physics(state, lats_)
        if config.edge_symmetrize:
            u, v = symmetrize_shared_edges(state.u, state.v)
            state = dataclasses.replace(state, u=u, v=v)
        return state

    return AquaplanetModel(
        config=config,
        grid=grid,
        ctx=ctx,
        lats=lats,
        step_fn=HoistedStep(step, (ctx, lats)),
        physics_fn=physics,
    )
