"""Dycore state pytree.

Mirrors the FV3 state contract the reference bridges between GEOS Fortran and
the GPU dycore (/root/reference/src/tcn/py_ftn_interface/example_def_dycore.yaml:46-70:
u v w delz pt delp q ps pe pk peln pkz phis q_con omga ua va uc vc mfx mfy
cx cy diss_est), re-laid-out for XLA:

* array layout [face, j, i, k] - the vertical is the minor dimension
  so column physics/remap vectorize across it, horizontal stencils see
  (j, i) as (sublane-tiled) major dims;
* the struct is a registered JAX dataclass pytree, so the whole state flows
  through jit/scan/shard_map and checkpointing without glue code (the
  reference needed a generated CFFI bridge + dual CUDA streams for the same
  job, templates/data_conversion.py:59-171).

Prognostic in round 1 (hydrostatic): u, v, delp, pt, q.  w/delz are carried
for the nonhydrostatic extension; diagnostic fields (ps, pe, pk, peln, pkz,
omga, ua, va) are recomputed, not trusted.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields

import jax
import jax.numpy as jnp
import numpy as np

from .config import DycoreConfig
from .grid import Grid, KAPPA


@jax.tree_util.register_dataclass
@dataclass
class DycoreState:
    # prognostic
    u: jax.Array      # [6, n+1, n, nz] D-grid x-wind on S/N cell edges [m/s]
    v: jax.Array      # [6, n, n+1, nz] D-grid y-wind on W/E cell edges [m/s]
    delp: jax.Array   # [6, n, n, nz] layer pressure thickness [Pa]
    pt: jax.Array     # [6, n, n, nz] potential temperature [K]
    q: jax.Array      # [6, n, n, nz, ntracers] tracer mixing ratios
    # nonhydrostatic extension (passive in hydrostatic mode)
    w: jax.Array      # [6, n, n, nz] vertical velocity [m/s]
    delz: jax.Array   # [6, n, n, nz] layer geometric thickness [m]
    # surface / fixed
    phis: jax.Array   # [6, n, n] surface geopotential [m^2/s^2]
    # diagnostics (filled by the dycore; layout matches reference contract)
    ps: jax.Array     # [6, n, n] surface pressure [Pa]
    omga: jax.Array   # [6, n, n, nz] omega = dp/dt [Pa/s]
    ua: jax.Array     # [6, n, n, nz] A-grid x-wind
    va: jax.Array     # [6, n, n, nz] A-grid y-wind
    # accumulated mass fluxes / courant numbers over a remap interval
    mfx: jax.Array    # [6, n, n+1, nz] accumulated x mass flux
    mfy: jax.Array    # [6, n+1, n, nz] accumulated y mass flux

    @property
    def nz(self) -> int:
        return self.delp.shape[-1]


def init_state(config: DycoreConfig, grid: Grid, ak: np.ndarray, bk: np.ndarray,
               perturb: float = 0.0, seed: int = 0) -> DycoreState:
    """Isothermal resting atmosphere (T = 300 K) with optional random pt
    perturbation to break symmetry (the standard Held-Suarez spin-up).
    """
    n, nz = config.npx, config.npz
    h = grid.h
    f32 = jnp.float32
    p_ref = 1.0e5

    ps = jnp.full((6, n, n), p_ref, dtype=f32)
    pe = ak[None, None, None, :] + bk[None, None, None, :] * ps[..., None]  # [6,n,n,nz+1]
    delp = (pe[..., 1:] - pe[..., :-1]).astype(f32)
    # midlayer pressure & Exner
    p_mid = 0.5 * (pe[..., 1:] + pe[..., :-1])
    t0 = 300.0
    pt = (t0 * (p_ref / p_mid) ** KAPPA).astype(f32)  # theta for isothermal T=t0... (T=t0 at p_ref)
    # actually: pt = theta such that T = t0 everywhere: theta = t0*(p00/p)^kappa
    if perturb:
        key = jax.random.PRNGKey(seed)
        pt = pt + perturb * jax.random.normal(key, pt.shape, dtype=f32)

    z = jnp.zeros((6, n, n, nz), dtype=f32)
    state = DycoreState(
        u=jnp.zeros((6, n + 1, n, nz), dtype=f32),
        v=jnp.zeros((6, n, n + 1, nz), dtype=f32),
        delp=delp,
        pt=pt,
        q=jnp.zeros((6, n, n, nz, config.ntracers), dtype=f32),
        w=z,
        delz=z,
        phis=jnp.zeros((6, n, n), dtype=f32),
        ps=ps,
        omga=z,
        ua=z,
        va=z,
        mfx=jnp.zeros((6, n, n + 1, nz), dtype=f32),
        mfy=jnp.zeros((6, n + 1, n, nz), dtype=f32),
    )
    return state
