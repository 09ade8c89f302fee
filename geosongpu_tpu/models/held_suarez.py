"""Held-Suarez model driver: the flagship end-to-end workload.

Counterpart of the reference's `geos_hs` experiment
(/root/reference/src/tcn/ci/data/experiments.yaml:8-17 +
src/tcn/ci/pipeline/held_suarez.py) with the model *in-repo* instead of
cloned+compiled Fortran: init -> jitted (dycore + HS forcing) step ->
lax.scan run loop, all one XLA program.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import DycoreConfig, ExperimentConfig
from ..core.grid import Grid, build_grid
from ..core.state import DycoreState, init_state
from ..core.vertical import hybrid_coordinate, sigma_coordinate
from ..dycore.fv_dynamics import DycoreContext, build_context, fv_dynamics_step
from ..physics.held_suarez import HSLatitudes, held_suarez_forcing, hs_latitudes
from .step import HoistedStep


@dataclass(frozen=True)
class HeldSuarezModel:
    config: DycoreConfig
    grid: Grid
    ctx: DycoreContext
    lats: HSLatitudes
    step_fn: HoistedStep
    # the HS forcing alone, (state, lats) -> state; the sharded stepper
    # (parallel/subtile.build_mesh_stepper) applies it per block
    physics_fn: Callable = None

    def init(self, perturb: float = 1.0e-3, seed: int = 0) -> DycoreState:
        ak = np.asarray(self.ctx.ak)
        bk = np.asarray(self.ctx.bk)
        return init_state(self.config, self.grid, ak, bk, perturb=perturb,
                          seed=seed)

    def run(self, state: DycoreState, steps: int) -> DycoreState:
        """Run `steps` model steps as one jitted scan, compiled once per
        count (an unjitted scan retraced on every call and leaked a fresh
        executable each time: 118 GB of host memory over a chunked
        400-day climatology run)."""
        return self.step_fn.run(state, steps)

    def run_with_history(self, state: DycoreState, steps: int,
                         every: int = 1):
        def body(s, _):
            s2 = self.step_fn(s)
            diag = {
                "ps_mean": jnp.mean(s2.ps),
                "ps_min": jnp.min(s2.ps),
                "ps_max": jnp.max(s2.ps),
                "umax": jnp.max(jnp.abs(s2.u)),
                "tmean": jnp.mean(s2.pt),
            }
            return s2, diag

        return jax.lax.scan(body, state, None, length=steps)


def build_model(config: DycoreConfig) -> HeldSuarezModel:
    grid = build_grid(config.npx, config.halo)
    if config.vertical == "sigma":
        ak, bk = sigma_coordinate(config.npz, config.ptop)
    else:
        ak, bk = hybrid_coordinate(config.npz, config.ptop)
    ctx = build_context(config, grid, ak, bk)
    lats = hs_latitudes(grid)

    def physics(state: DycoreState,
                lats_loc: HSLatitudes = lats) -> DycoreState:
        u, v, pt = held_suarez_forcing(
            state.u, state.v, state.pt, state.delp, lats_loc, config.ptop,
            config.dt)
        return dataclasses.replace(state, u=u, v=v, pt=pt)

    def step(state: DycoreState, ctx_lats) -> DycoreState:
        from ..parallel.halo import symmetrize_shared_edges

        ctx_, lats_ = ctx_lats
        state = physics(fv_dynamics_step(state, ctx_), lats_)
        if config.edge_symmetrize:
            u, v = symmetrize_shared_edges(state.u, state.v)
            state = dataclasses.replace(state, u=u, v=v)
        return state

    return HeldSuarezModel(
        config=config,
        grid=grid,
        ctx=ctx,
        lats=lats,
        step_fn=HoistedStep(step, (ctx, lats)),
        physics_fn=physics,
    )
