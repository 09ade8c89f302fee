"""Runtime halo exchange as XLA gathers.

The reference rides MPI point-to-point halo exchange living in the external
NDSL stack over OpenMPI/UCX/GDRCopy (SURVEY.md SS2.9 item 5,
/root/reference/sw_stack/discover/sles15/HISTORY.md).  Here the exchange is a
*data-parallel gather* with the static tables from core/topology.py:

* single device: one XLA gather, fused into the surrounding program;
* sharded (faces / subtiles on a mesh): the SPMD partitioner lowers the same
  gather to collectives; a `shard_map` + `ppermute` fast path for
  face-sharded meshes lives in parallel/mesh.py.

All functions are pure and jit-friendly; tables are closed over as constants.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.topology import NFACES, HaloSpec, halo_spec


@dataclass(frozen=True)
class _BlockRecipe:
    """One halo block as a gather-free transform: take a rectangle of a
    neighbor face, optionally transpose/flip, write into the padded dest.

    Every edge/corner strip of the cubed
    sphere is an *affine signed-permutation* image of a contiguous source
    rectangle, so slice+transpose+reverse (all fast, fusable ops) replace
    the gather entirely.  Recipes are derived from - and verified against -
    the gather tables at build time.
    """

    face: int          # destination face
    dj0: int
    dj1: int           # destination row range in the padded array
    di0: int
    di1: int
    g: int             # source face
    j0: int
    j1: int            # source rectangle (unpadded cell coords)
    i0: int
    i1: int
    transpose: bool
    flip0: bool
    flip1: bool


def _fit_recipe(f, dj0, dj1, di0, di1, sf, sj, si) -> _BlockRecipe:
    """Derive a block recipe from the gather tables over one dest block."""
    bf = sf[dj0:dj1, di0:di1]
    bj = sj[dj0:dj1, di0:di1].astype(int)
    bi = si[dj0:dj1, di0:di1].astype(int)
    g = int(bf[0, 0])
    assert (bf == g).all(), "halo block spans multiple source faces"
    R, C = bj.shape
    # steps along dest rows / cols in source (j, i)
    drj = int(bj[1, 0] - bj[0, 0]) if R > 1 else 0
    dri = int(bi[1, 0] - bi[0, 0]) if R > 1 else 0
    dcj = int(bj[0, 1] - bj[0, 0]) if C > 1 else 0
    dci = int(bi[0, 1] - bi[0, 0]) if C > 1 else 0
    # transpose when dest rows advance along source i
    if R > 1:
        transpose = drj == 0
    elif C > 1:
        transpose = dci == 0
    else:
        transpose = False
    j0, j1 = int(bj.min()), int(bj.max()) + 1
    i0, i1 = int(bi.min()), int(bi.max()) + 1
    if not transpose:
        flip0 = (drj < 0) if R > 1 else False
        flip1 = (dci < 0) if C > 1 else False
    else:
        flip0 = (dri < 0) if R > 1 else False
        flip1 = (dcj < 0) if C > 1 else False
    rec = _BlockRecipe(f, dj0, dj1, di0, di1, g, j0, j1, i0, i1,
                       transpose, flip0, flip1)
    # verify against the tables
    jj = np.arange(j0, j1)
    ii = np.arange(i0, i1)
    J, I = np.meshgrid(jj, ii, indexing="ij")
    if transpose:
        J, I = J.T, I.T
    if flip0:
        J, I = J[::-1], I[::-1]
    if flip1:
        J, I = J[:, ::-1], I[:, ::-1]
    assert J.shape == bj.shape, (J.shape, bj.shape)
    assert (J == bj).all() and (I == bi).all(), f"recipe mismatch {rec}"
    return rec


@dataclass(frozen=True)
class _StagRecipe:
    """Staggered-block recipe: like _BlockRecipe plus which source array
    (the neighbor's u or v) and the constant sign for tangential (D-grid)
    and normal (C-grid) components."""

    face: int
    dj0: int
    dj1: int
    di0: int
    di1: int
    g: int
    src_is_v: bool     # False: slice the u-like array, True: the v-like
    j0: int
    j1: int
    i0: int
    i1: int
    transpose: bool
    flip0: bool
    flip1: bool
    sgn_t: int
    sgn_n: int


def _fit_stag_block(f, dj0, dj1, di0, di1, idx, sgn_t, sgn_n, n):
    """Fit one staggered halo block from the concat-flat index tables."""
    u_count = NFACES * (n + 1) * n
    b = idx[dj0:dj1, di0:di1].astype(np.int64)
    st = sgn_t[dj0:dj1, di0:di1]
    sn = sgn_n[dj0:dj1, di0:di1]
    src_is_v = bool(b[0, 0] >= u_count)
    assert ((b >= u_count) == src_is_v).all(), "mixed u/v sources in block"
    assert (st == st[0, 0]).all() and (sn == sn[0, 0]).all(), "mixed signs"
    if src_is_v:
        rel = b - u_count
        g = rel // (n * (n + 1))
        rem = rel % (n * (n + 1))
        bj = rem // (n + 1)
        bi = rem % (n + 1)
    else:
        g = b // ((n + 1) * n)
        rem = b % ((n + 1) * n)
        bj = rem // n
        bi = rem % n
    gg = int(g[0, 0])
    assert (g == gg).all(), "block spans faces"
    R, C = bj.shape
    drj = int(bj[1, 0] - bj[0, 0]) if R > 1 else 0
    dci = int(bi[0, 1] - bi[0, 0]) if C > 1 else 0
    dri = int(bi[1, 0] - bi[0, 0]) if R > 1 else 0
    dcj = int(bj[0, 1] - bj[0, 0]) if C > 1 else 0
    if R > 1:
        transpose = drj == 0 and dri != 0
    elif C > 1:
        transpose = dci == 0 and dcj != 0
    else:
        transpose = False
    j0, j1 = int(bj.min()), int(bj.max()) + 1
    i0, i1 = int(bi.min()), int(bi.max()) + 1
    if not transpose:
        flip0 = (drj < 0) if R > 1 else False
        flip1 = (dci < 0) if C > 1 else False
    else:
        flip0 = (dri < 0) if R > 1 else False
        flip1 = (dcj < 0) if C > 1 else False
    rec = _StagRecipe(f, dj0, dj1, di0, di1, gg, src_is_v, j0, j1, i0, i1,
                      transpose, flip0, flip1, int(st[0, 0]), int(sn[0, 0]))
    jj = np.arange(j0, j1)
    ii = np.arange(i0, i1)
    J, I = np.meshgrid(jj, ii, indexing="ij")
    if transpose:
        J, I = J.T, I.T
    if flip0:
        J, I = J[::-1], I[::-1]
    if flip1:
        J, I = J[:, ::-1], I[:, ::-1]
    assert (J == bj).all() and (I == bi).all(), f"stag recipe mismatch {rec}"
    return rec


def _build_stag_recipes(spec: HaloSpec) -> Tuple[List[_StagRecipe],
                                                 List[_StagRecipe]]:
    """Block decomposition of the padded u [6, N+1, N] and v [6, N, N+1]
    arrays.  The shared-interface rows/columns (h and h+n) split into their
    own 1-wide blocks because their halo cells resolve through a different
    edge sequence than the adjacent strips."""
    n, h = spec.n, spec.h
    N = n + 2 * h
    u_rows = [(0, h), (h, h + n), (h + n, h + n + 1), (h + n + 1, N + 1)]
    u_cols = [(0, h), (h, h + n), (h + n, N)]
    urec: List[_StagRecipe] = []
    for f in range(NFACES):
        for (r0, r1) in u_rows:
            for (c0, c1) in u_cols:
                interior = (r0 >= h and r1 <= h + n + 1 and c0 >= h
                            and c1 <= h + n)
                if interior:
                    continue
                urec.append(_fit_stag_block(
                    f, r0, r1, c0, c1, spec.u_idx[f], spec.u_sgn[f],
                    spec.u_sgn_n[f], n))
    v_rows = [(0, h), (h, h + n), (h + n, N)]
    v_cols = [(0, h), (h, h + n), (h + n, h + n + 1), (h + n + 1, N + 1)]
    vrec: List[_StagRecipe] = []
    for f in range(NFACES):
        for (r0, r1) in v_rows:
            for (c0, c1) in v_cols:
                interior = (c0 >= h and c1 <= h + n + 1 and r0 >= h
                            and r1 <= h + n)
                if interior:
                    continue
                vrec.append(_fit_stag_block(
                    f, r0, r1, c0, c1, spec.v_idx[f], spec.v_sgn[f],
                    spec.v_sgn_n[f], n))
    return urec, vrec


def _stag_block(u_like, v_like, r, normal: bool) -> jnp.ndarray:
    src = v_like if r.src_is_v else u_like
    blk = src[r.g, r.j0:r.j1, r.i0:r.i1]
    if r.transpose:
        blk = jnp.swapaxes(blk, 0, 1)
    if r.flip0:
        blk = blk[::-1]
    if r.flip1:
        blk = blk[:, ::-1]
    s = r.sgn_n if normal else r.sgn_t
    return -blk if s != 1 else blk


def _apply_stag_recipes(u_like: jnp.ndarray, v_like: jnp.ndarray,
                        recipes: List[_StagRecipe], interior: jnp.ndarray,
                        normal: bool, n: int, h: int) -> jnp.ndarray:
    """Concat-assemble a padded staggered array (one output pass).

    `interior` is the unpadded prognostic array whose rows/cols include the
    shared face-boundary interfaces (u: [6, n+1, n]; v: [6, n, n+1]).
    Layout: top halo rows | [west halo, interior, east halo] | bottom rows,
    where for the u-grid the west/east mid columns stack two row-blocks
    (the strip plus the single shared-interface row band) and for the
    v-grid the top/bottom rows stack blocks across four column bands.
    """
    u_grid = interior.shape[1] == n + 1
    bottom_row_start = (h + n + 1) if u_grid else (h + n)
    by_face: dict = {}
    for r in recipes:
        by_face.setdefault(r.face, []).append(r)
    faces = []
    for f in range(NFACES):
        recs = by_face[f]

        def cat(rs, axis):
            return jnp.concatenate(
                [_stag_block(u_like, v_like, r, normal) for r in rs],
                axis=axis)

        top = cat(sorted((r for r in recs if r.dj0 == 0),
                         key=lambda r: r.di0), axis=1)
        bot = cat(sorted((r for r in recs if r.dj0 >= bottom_row_start),
                         key=lambda r: r.di0), axis=1)
        west = cat(sorted((r for r in recs
                           if r.di0 == 0 and 0 < r.dj0 < bottom_row_start),
                          key=lambda r: r.dj0), axis=0)
        east = cat(sorted((r for r in recs
                           if r.di0 >= h + n and 0 < r.dj0 < bottom_row_start),
                          key=lambda r: r.dj0), axis=0)
        mid = jnp.concatenate([west, interior[f], east], axis=1)
        faces.append(jnp.concatenate([top, mid, bot], axis=0))
    return jnp.stack(faces, axis=0)


def _build_recipes(spec: HaloSpec, order: str) -> List[_BlockRecipe]:
    """Edge strips + corner blocks for one corner-table direction."""
    n, h = spec.n, spec.h
    N = n + 2 * h
    gidx = spec.gidx_x if order == "x" else spec.gidx_y
    sf = gidx // (n * n)
    sj = (gidx // n) % n
    si = gidx % n
    out: List[_BlockRecipe] = []
    blocks = [
        (h, h + n, 0, h),          # W strip
        (h, h + n, h + n, N),      # E strip
        (0, h, h, h + n),          # S strip
        (h + n, N, h, h + n),      # N strip
        (0, h, 0, h),              # SW corner
        (0, h, h + n, N),          # SE
        (h + n, N, 0, h),          # NW
        (h + n, N, h + n, N),      # NE
    ]
    for f in range(NFACES):
        for dj0, dj1, di0, di1 in blocks:
            out.append(_fit_recipe(f, dj0, dj1, di0, di1,
                                   sf[f], sj[f], si[f]))
    return out


def _block(field: jnp.ndarray, r) -> jnp.ndarray:
    blk = field[r.g, r.j0:r.j1, r.i0:r.i1]
    if r.transpose:
        blk = jnp.swapaxes(blk, 0, 1)
    if r.flip0:
        blk = blk[::-1]
    if r.flip1:
        blk = blk[:, ::-1]
    return blk


def _apply_recipes(field: jnp.ndarray, recipes: List[_BlockRecipe],
                   n: int, h: int) -> jnp.ndarray:
    """field [6, n, n, ...] -> padded [6, N, N, ...] assembled by pure
    concatenation (one output pass; sequential .at[].set updates would
    each copy the full array)."""
    # (face, row-band, col-band) -> recipe; bands: 0 = S/W halo, 2 = N/E
    bands = {}
    for r in recipes:
        bj = 0 if r.dj0 == 0 else 2
        bi = 0 if r.di0 == 0 else 2
        if r.dj0 == h and r.dj1 == h + n:
            bj = 1
        if r.di0 == h and r.di1 == h + n:
            bi = 1
        bands[(r.face, bj, bi)] = r
    faces = []
    for f in range(NFACES):
        top = jnp.concatenate([
            _block(field, bands[(f, 0, 0)]),
            _block(field, bands[(f, 0, 1)]),
            _block(field, bands[(f, 0, 2)])], axis=1)
        mid = jnp.concatenate([
            _block(field, bands[(f, 1, 0)]),
            field[f],
            _block(field, bands[(f, 1, 2)])], axis=1)
        bot = jnp.concatenate([
            _block(field, bands[(f, 2, 0)]),
            _block(field, bands[(f, 2, 1)]),
            _block(field, bands[(f, 2, 2)])], axis=1)
        faces.append(jnp.concatenate([top, mid, bot], axis=0))
    return jnp.stack(faces, axis=0)


@dataclass(frozen=True)
class HaloOps:
    """Device-resident halo gather tables + fill ops for one (n, h)."""

    n: int
    h: int
    gidx_x: jax.Array
    gidx_y: jax.Array
    vswap_x: jax.Array
    vsy_x: jax.Array
    vsx_x: jax.Array
    vswap_y: jax.Array
    vsy_y: jax.Array
    vsx_y: jax.Array
    u_idx: jax.Array
    u_sgn: jax.Array
    u_sgn_n: jax.Array
    v_idx: jax.Array
    v_sgn: jax.Array
    v_sgn_n: jax.Array
    recipes_x: Tuple[_BlockRecipe, ...] = ()
    recipes_y: Tuple[_BlockRecipe, ...] = ()
    stag_u_recipes: Tuple[_StagRecipe, ...] = ()
    stag_v_recipes: Tuple[_StagRecipe, ...] = ()

    # -- scalar, cell-centered -----------------------------------------
    def fill(self, field: jax.Array, direction: str = "x") -> jax.Array:
        """[6, n, n, ...] -> padded [6, N, N, ...].

        direction picks the corner-block table: 'x' for x-direction stencils
        (rows continue through S/N-hop-first corners), 'y' for y-direction.
        Uses the gather-free block recipes (slice/transpose/flip).
        """
        recipes = self.recipes_x if direction == "x" else self.recipes_y
        if recipes:
            return _apply_recipes(field, recipes, self.n, self.h)
        n = self.n
        gidx = self.gidx_x if direction == "x" else self.gidx_y
        flat = field.reshape((NFACES * n * n,) + field.shape[3:])
        return jnp.take(flat, gidx, axis=0)

    # -- cell-centered vector ------------------------------------------
    def fill_vector(self, vy: jax.Array, vx: jax.Array, direction: str = "x"
                    ) -> Tuple[jax.Array, jax.Array]:
        """Pad a cell-centered vector (y-comp, x-comp), applying the
        signed-permutation frame change in the halo."""
        if direction == "x":
            sw, sy, sx = self.vswap_x, self.vsy_x, self.vsx_x
        else:
            sw, sy, sx = self.vswap_y, self.vsy_y, self.vsx_y
        py = self.fill(vy, direction)
        px = self.fill(vx, direction)
        extra = (1,) * (py.ndim - 3)
        sw = sw.reshape(sw.shape + extra)
        sy = sy.reshape(sy.shape + extra).astype(py.dtype)
        sx = sx.reshape(sx.shape + extra).astype(px.dtype)
        out_y = sy * jnp.where(sw, px, py)
        out_x = sx * jnp.where(sw, py, px)
        return out_y, out_x

    # -- D-grid staggered winds ----------------------------------------
    def fill_dgrid(self, u: jax.Array, v: jax.Array
                   ) -> Tuple[jax.Array, jax.Array]:
        """u [6, n+1, n, ...], v [6, n, n+1, ...] ->
        padded u [6, N+1, N, ...], v [6, N, N+1, ...] with the MPP
        DGRID_NE-style u<->v swap/sign handling baked into the recipes."""
        if self.stag_u_recipes:
            pu = _apply_stag_recipes(u, v, self.stag_u_recipes, u,
                                     normal=False, n=self.n, h=self.h)
            pv = _apply_stag_recipes(u, v, self.stag_v_recipes, v,
                                     normal=False, n=self.n, h=self.h)
            return pu, pv
        n = self.n
        trail = u.shape[3:]
        flat = jnp.concatenate([
            u.reshape((NFACES * (n + 1) * n,) + trail),
            v.reshape((NFACES * n * (n + 1),) + trail),
        ], axis=0)
        extra = (1,) * len(trail)
        pu = jnp.take(flat, self.u_idx, axis=0)
        pu = pu * self.u_sgn.reshape(self.u_sgn.shape + extra).astype(u.dtype)
        pv = jnp.take(flat, self.v_idx, axis=0)
        pv = pv * self.v_sgn.reshape(self.v_sgn.shape + extra).astype(v.dtype)
        return pu, pv

    # -- C-grid staggered normal winds ---------------------------------
    def fill_cgrid(self, uc: jax.Array, vc: jax.Array
                   ) -> Tuple[jax.Array, jax.Array]:
        """uc [6, n, n+1, ...]: x-normal wind on W/E interfaces (v-point
        locations); vc [6, n+1, n, ...]: y-normal wind on S/N interfaces
        (u-point locations).  Same index tables as the D-grid exchange, but
        the *normal* component signs (a normal comp at a u-point is a
        y-component, so it gathers with the y sign)."""
        if self.stag_u_recipes:
            pvc = _apply_stag_recipes(vc, uc, self.stag_u_recipes, vc,
                                      normal=True, n=self.n, h=self.h)
            puc = _apply_stag_recipes(vc, uc, self.stag_v_recipes, uc,
                                      normal=True, n=self.n, h=self.h)
            return puc, pvc
        n = self.n
        trail = uc.shape[3:]
        # concat order must match table construction: u-point array first
        flat = jnp.concatenate([
            vc.reshape((NFACES * (n + 1) * n,) + trail),
            uc.reshape((NFACES * n * (n + 1),) + trail),
        ], axis=0)
        extra = (1,) * len(trail)
        pvc = jnp.take(flat, self.u_idx, axis=0)
        pvc = pvc * self.u_sgn_n.reshape(self.u_sgn_n.shape + extra).astype(vc.dtype)
        puc = jnp.take(flat, self.v_idx, axis=0)
        puc = puc * self.v_sgn_n.reshape(self.v_sgn_n.shape + extra).astype(uc.dtype)
        return puc, pvc

    @property
    def ny(self) -> int:
        """Rows of the local (face) block; == n for whole-face fills.
        Subtile fillers (parallel/subtile.py) override with the block
        height so the dycore slicing generalizes to rectangular blocks."""
        return self.n

    @property
    def nx(self) -> int:
        return self.n

    def interior(self, padded: jax.Array) -> jax.Array:
        """Strip the halo of a padded cell-centered array."""
        h, n = self.h, self.n
        return padded[:, h:h + n, h:h + n]

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> jax.Array:
        return jnp.zeros(shape, dtype)


def build_halo_ops(n: int, h: int) -> HaloOps:
    spec: HaloSpec = halo_spec(n, h)
    as_dev = lambda a: jnp.asarray(a)
    return HaloOps(
        n=n, h=h,
        gidx_x=as_dev(spec.gidx_x.reshape(-1)).reshape(spec.gidx_x.shape),
        gidx_y=as_dev(spec.gidx_y),
        vswap_x=as_dev(spec.vswap_x),
        vsy_x=as_dev(spec.vsy_x),
        vsx_x=as_dev(spec.vsx_x),
        vswap_y=as_dev(spec.vswap_y),
        vsy_y=as_dev(spec.vsy_y),
        vsx_y=as_dev(spec.vsx_y),
        u_idx=as_dev(spec.u_idx),
        u_sgn=as_dev(spec.u_sgn),
        u_sgn_n=as_dev(spec.u_sgn_n),
        v_idx=as_dev(spec.v_idx),
        v_sgn=as_dev(spec.v_sgn),
        v_sgn_n=as_dev(spec.v_sgn_n),
        recipes_x=tuple(_build_recipes(spec, "x")),
        recipes_y=tuple(_build_recipes(spec, "y")),
        stag_u_recipes=tuple(_build_stag_recipes(spec)[0]),
        stag_v_recipes=tuple(_build_stag_recipes(spec)[1]),
    )


def symmetrize_shared_edges(u: jax.Array, v: jax.Array):
    """Average the two independently-prognosed copies of every shared
    face-boundary staggered wind entry (cheap insurance against
    shared-edge rounding drift; both copies are equal in exact
    arithmetic).  u [6, n+1, n, ...], v [6, n, n+1, ...]."""
    from ..core.topology import edge_twins

    n = u.shape[2]
    idx_a, idx_b, sgn = edge_twins(n)
    trail = u.shape[3:]
    uf = u.reshape((-1,) + trail)
    vf = v.reshape((-1,) + trail)
    flat = jnp.concatenate([uf, vf], axis=0)
    s = jnp.asarray(sgn, u.dtype).reshape((-1,) + (1,) * len(trail))
    mean = 0.5 * (flat[idx_a] + s * flat[idx_b])
    flat = flat.at[idx_a].set(mean).at[idx_b].set(s * mean)
    nu = uf.shape[0]
    return (flat[:nu].reshape(u.shape), flat[nu:].reshape(v.shape))
