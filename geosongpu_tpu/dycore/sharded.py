"""Face-sharded model execution: the full dynamics step under shard_map.

This is the ppermute execution mode the reference's MPI-decomposed runs
map to (SURVEY.md SS2.10): one device owns one cube face, *only halo
strips* move between devices (lax.ppermute matching rounds from
parallel/shard_halo.py), and all stencil compute is face-local.  Contrast
with the GSPMD mode (parallel/mesh.py), where XLA partitions the global
program and typically all-gathers faces for the halo assembly.

The dycore code is reused unchanged: `fv_dynamics_step` only touches its
`ctx.ops` through the filler interface (fill / fill_dgrid / .n / .h), so a
ShardedFiller that swaps the concat-assembly for ppermute exchanges makes
the same function SPMD.  Equivalence with the single-device step is
asserted in tests on a 6-device mesh.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import DycoreConfig
from ..core.state import DycoreState
from ..parallel.shard_halo import (build_plan, build_stag_plan,
                                   shard_fill_dgrid, shard_halo_fill)
from .fv_dynamics import DycoreContext, fv_dynamics_step


class ShardedFiller:
    """Drop-in for HaloOps inside shard_map: arrays carry a leading
    face-block dim of 1; fills go through ppermute exchanges.  The x/y
    corner-table variants come out of one exchange (memoized per traced
    value within the step trace)."""

    def __init__(self, n: int, h: int, axis_name: str = "face"):
        self.n = n
        self.ny = n
        self.nx = n
        self.h = h
        self.axis_name = axis_name
        self._plan = build_plan(n, h)
        self._stag = build_stag_plan(n, h)
        self._memo = {}

    def fill(self, field: jax.Array, direction: str = "x") -> jax.Array:
        key = id(field)
        if key not in self._memo:
            px, py = shard_halo_fill(field[0], self._plan, self.axis_name)
            # keep a strong ref to `field` so its id cannot be recycled for
            # a different tracer within this trace
            self._memo[key] = (field, px[None], py[None])
        return self._memo[key][1 if direction == "x" else 2]

    def fill_dgrid(self, u: jax.Array, v: jax.Array):
        pu, pv = shard_fill_dgrid(u[0], v[0], self._stag, normal=False,
                                  axis_name=self.axis_name)
        return pu[None], pv[None]

    def fill_cgrid(self, uc: jax.Array, vc: jax.Array):
        pvc, puc = shard_fill_dgrid(vc[0], uc[0], self._stag, normal=True,
                                    axis_name=self.axis_name)
        return puc[None], pvc[None]

    def interior(self, padded: jax.Array) -> jax.Array:
        h, n = self.h, self.n
        return padded[:, h:h + n, h:h + n]

    def zeros(self, shape, dtype=jnp.float32) -> jax.Array:
        # mark face-varying so scan carries typecheck inside shard_map
        return jax.lax.pcast(jnp.zeros(shape, dtype), self.axis_name,
                             to="varying")


def face_mesh(devices=None) -> Mesh:
    devs = devices if devices is not None else jax.devices()
    if len(devs) < 6:
        raise ValueError("face-sharded mode needs >= 6 devices")
    return Mesh(np.asarray(devs[:6]), axis_names=("face",))


def build_sharded_step(ctx: DycoreContext, mesh: Optional[Mesh] = None):
    """Returns (step_fn, place_fn): `place_fn(state)` shards a DycoreState
    over the face mesh; `step_fn(state)` runs one dynamics step SPMD."""
    mesh = mesh or face_mesh()
    cfg = ctx.config

    chart_sh = None
    if ctx.chart is not None:
        from ..core.chart_corners import sharded_chart_for_faces

        chart_sh = sharded_chart_for_faces(ctx.chart, "face")

    def local_step(state_local: DycoreState, metrics_local, stag_local):
        filler = ShardedFiller(cfg.npx, cfg.halo)
        lctx = DycoreContext(ops=filler, metrics=metrics_local,
                             ak=ctx.ak, bk=ctx.bk, config=cfg,
                             chart=chart_sh, stag=stag_local)
        return fv_dynamics_step(state_local, lctx)

    spec = P("face")
    step_sm = shard_map(
        local_step, mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
    )

    metrics = ctx.metrics
    stag = ctx.stag

    @jax.jit
    def step(state: DycoreState) -> DycoreState:
        return step_sm(state, metrics, stag)

    def place(state: DycoreState) -> DycoreState:
        sh = NamedSharding(mesh, spec)
        return jax.tree.map(lambda x: jax.device_put(x, sh), state)

    return step, place
