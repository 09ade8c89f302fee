"""shard_map + ppermute halo exchange for face-sharded meshes.

The GSPMD path (parallel/halo.py under jit) lets XLA choose collectives
for the concat-assembly's cross-face references - correct, but at scale it
tends to all-gather whole faces.  This module is the ppermute path the
reference's MPI halo exchange maps to (SURVEY.md SS2.10): each device owns
one cube face and exchanges *only the strips*, via `lax.ppermute`, in

  phase 1: 4 rounds of disjoint face-pair swaps (a perfect-matching
           4-edge-coloring of the octahedral face-adjacency graph), each
           carrying one edge strip per direction;
  phase 2: 4 more rounds carrying the corner blocks, which each face can
           only serve *after* its own halo strips are filled (the two-hop
           ownership of cube corners, core/topology.py).

All per-face asymmetry (which edge faces the partner, transpose/flip
orientation) is static data baked into per-face branch functions selected
with `lax.switch(axis_index)` - the SPMD program is identical on every
device.  Equivalence with the gather/concat fill is asserted in tests on a
6-device CPU mesh.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.topology import NFACES, edge_table, halo_spec

# 4 perfect matchings partitioning the 12 face-pair edges
MATCHINGS: Tuple[Tuple[Tuple[int, int], ...], ...] = (
    ((0, 1), (2, 4), (3, 5)),
    ((0, 3), (1, 4), (2, 5)),
    ((0, 4), (1, 5), (2, 3)),
    ((0, 5), (1, 2), (3, 4)),
)

_EDGE_BLOCKS = {
    # edge -> (padded dest slice rows, cols) as functions of (n, h)
    "W": lambda n, h: (slice(h, h + n), slice(0, h)),
    "E": lambda n, h: (slice(h, h + n), slice(h + n, h + n + h)),
    "S": lambda n, h: (slice(0, h), slice(h, h + n)),
    "N": lambda n, h: (slice(h + n, h + n + h), slice(h, h + n)),
}
# corner name -> (rows, cols)
_CORNER_BLOCKS = {
    "SW": lambda n, h: (slice(0, h), slice(0, h)),
    "SE": lambda n, h: (slice(0, h), slice(h + n, h + n + h)),
    "NW": lambda n, h: (slice(h + n, h + n + h), slice(0, h)),
    "NE": lambda n, h: (slice(h + n, h + n + h), slice(h + n, h + n + h)),
}
# which neighbor serves each corner, per table: x-order -> S/N first hop
_CORNER_FIRST_EDGE = {
    "x": {"SW": "S", "SE": "S", "NW": "N", "NE": "N"},
    "y": {"SW": "W", "SE": "E", "NW": "W", "NE": "E"},
}


@dataclass(frozen=True)
class _Xform:
    """source rectangle (possibly in padded coords) + orientation."""

    j0: int
    j1: int
    i0: int
    i1: int
    transpose: bool
    flip0: bool
    flip1: bool
    padded_src: bool  # rectangle indexes the sender's *padded* array

    def apply(self, arr: jnp.ndarray) -> jnp.ndarray:
        blk = arr[self.j0:self.j1, self.i0:self.i1]
        if self.transpose:
            blk = jnp.swapaxes(blk, 0, 1)
        if self.flip0:
            blk = blk[::-1]
        if self.flip1:
            blk = blk[:, ::-1]
        return blk


def _fit_xform(sj: np.ndarray, si: np.ndarray, padded_src: bool) -> _Xform:
    """Fit an orientation transform mapping a source rectangle onto the
    dest block whose source coords are (sj, si)."""
    R, C = sj.shape
    drj = int(sj[1, 0] - sj[0, 0]) if R > 1 else 0
    dri = int(si[1, 0] - si[0, 0]) if R > 1 else 0
    dcj = int(sj[0, 1] - sj[0, 0]) if C > 1 else 0
    dci = int(si[0, 1] - si[0, 0]) if C > 1 else 0
    if R > 1:
        transpose = drj == 0 and dri != 0
    elif C > 1:
        transpose = dci == 0 and dcj != 0
    else:
        transpose = False
    j0, j1 = int(sj.min()), int(sj.max()) + 1
    i0, i1 = int(si.min()), int(si.max()) + 1
    if not transpose:
        flip0 = (drj < 0) if R > 1 else False
        flip1 = (dci < 0) if C > 1 else False
    else:
        flip0 = (dri < 0) if R > 1 else False
        flip1 = (dcj < 0) if C > 1 else False
    x = _Xform(j0, j1, i0, i1, transpose, flip0, flip1, padded_src)
    # verify
    J, I = np.meshgrid(np.arange(j0, j1), np.arange(i0, i1), indexing="ij")
    if transpose:
        J, I = J.T, I.T
    if flip0:
        J, I = J[::-1], I[::-1]
    if flip1:
        J, I = J[:, ::-1], I[:, ::-1]
    assert (J == sj).all() and (I == si).all(), "xform mismatch"
    return x


@dataclass(frozen=True)
class ShardHaloPlan:
    n: int
    h: int
    # phase 1: strip_send[r][f] = transform of the LOCAL interior producing
    # the partner's halo-edge block (canonical [h, n]); strip_edge[r][f] =
    # the receiver's edge
    strip_send: Tuple[Tuple[_Xform, ...], ...]
    strip_edge: Tuple[Tuple[str, ...], ...]
    # phase 2: corner_send[r][f] = PAIR of transforms of the local PADDED
    # array producing the partner's two corner blocks (stacked [2h, h] on
    # send); corner_meta[r][f] = (table, corner0, corner1) the face RECEIVES
    corner_send: Tuple[Tuple[Tuple[_Xform, _Xform], ...], ...]
    corner_meta: Tuple[Tuple[Tuple[str, str, str], ...], ...]
    partner: Tuple[Tuple[int, ...], ...]  # partner[r][f]


@functools.lru_cache(maxsize=8)
def build_plan(n: int, h: int) -> ShardHaloPlan:
    spec = halo_spec(n, h)
    N = n + 2 * h
    et = edge_table()
    # receiver-edge per (face, partner)
    edge_toward = {}
    for (f, e), link in et.items():
        edge_toward[(f, link.neighbor)] = e

    sfx = spec.gidx_x // (n * n)
    sjx = (spec.gidx_x // n) % n
    six = spec.gidx_x % n
    sfy = spec.gidx_y // (n * n)
    sjy = (spec.gidx_y // n) % n
    siy = spec.gidx_y % n

    partner = []
    strip_send = []
    strip_edge = []
    for pairs in MATCHINGS:
        p_row = [0] * NFACES
        send_row: List[_Xform] = [None] * NFACES
        edge_row: List[str] = [""] * NFACES
        for a, b in pairs:
            p_row[a], p_row[b] = b, a
            for me, other in ((a, b), (b, a)):
                # the other's halo edge toward me
                oe = edge_toward[(other, me)]
                js, is_ = _EDGE_BLOCKS[oe](n, h)
                # source coords of other's halo block live on MY face;
                # canonicalize every strip to [h, n] (depth-major) so all
                # lax.switch branches agree in shape - receivers of W/E
                # edges transpose back on placement
                sj = sjx[other][js, is_]
                si = six[other][js, is_]
                assert (sfx[other][js, is_] == me).all()
                if oe in ("W", "E"):
                    sj, si = sj.T, si.T
                send_row[me] = _fit_xform(sj, si, padded_src=False)
                # placement edge for the RECEIVER `me`: my own edge toward
                # the partner (what the partner prepared for me)
                edge_row[me] = edge_toward[(me, other)]
        partner.append(tuple(p_row))
        strip_send.append(tuple(send_row))
        strip_edge.append(tuple(edge_row))

    # ---- phase 2: each face gets x-table corners from its S/N partners
    # and y-table corners from its W/E partners, in the same 4 rounds -----
    tables = {"x": (sfx, sjx, six), "y": (sfy, sjy, siy)}

    # per-face lookup: source cell -> position in my padded array.  Cells
    # duplicated at cube corners appear both in corner blocks and in edge
    # strips; prefer interior, then strips (affine-consistent), corners last.
    def _pos_class(pj, pi):
        in_j = h <= pj < h + n
        in_i = h <= pi < h + n
        if in_j and in_i:
            return 0
        if in_j or in_i:
            return 1
        return 2

    luts = {}
    for t, (sf_t, sj_t, si_t) in tables.items():
        for me in range(NFACES):
            lut = {}
            best = {}
            for pj in range(N):
                for pi in range(N):
                    key = (int(sf_t[me][pj, pi]), int(sj_t[me][pj, pi]),
                           int(si_t[me][pj, pi]))
                    cls = _pos_class(pj, pi)
                    if key not in best or cls < best[key]:
                        best[key] = cls
                        lut[key] = (pj, pi)
            luts[(t, me)] = lut

    corner_send: List[Tuple[_Xform, ...]] = []
    corner_meta: List[Tuple[Tuple[str, str, str], ...]] = []  # (table, c0, c1)
    for pairs in MATCHINGS:
        send_row: List[_Xform] = [None] * NFACES
        meta_row: List[Tuple[str, str, str]] = [("", "", "")] * NFACES
        for a, b in pairs:
            for me, other in ((a, b), (b, a)):
                # other's corners whose first hop is its edge toward me
                oe = edge_toward[(other, me)]
                table = "x" if oe in ("S", "N") else "y"
                corners = sorted(
                    c for c, e in _CORNER_FIRST_EDGE[table].items()
                    if e == oe)
                assert len(corners) == 2, (other, me, oe, table)
                sf_t, sj_t, si_t = tables[table]
                lut = luts[(table, me)]
                pj_blocks, pi_blocks = [], []
                for c in corners:
                    js, is_ = _CORNER_BLOCKS[c](n, h)
                    of = sf_t[other][js, is_]
                    oj = sj_t[other][js, is_]
                    oi = si_t[other][js, is_]
                    R, C = of.shape
                    pj_arr = np.zeros((R, C), int)
                    pi_arr = np.zeros((R, C), int)
                    for r_ in range(R):
                        for c_ in range(C):
                            key = (int(of[r_, c_]), int(oj[r_, c_]),
                                   int(oi[r_, c_]))
                            assert key in lut, (
                                "corner owner cell not present in the "
                                "first-hop face's padded array")
                            pj_arr[r_, c_], pi_arr[r_, c_] = lut[key]
                    pj_blocks.append(pj_arr)
                    pi_blocks.append(pi_arr)
                # the two corners come from opposite sides of the
                # sender's face - fit each block independently
                send_row[me] = (
                    _fit_xform(pj_blocks[0], pi_blocks[0], padded_src=True),
                    _fit_xform(pj_blocks[1], pi_blocks[1], padded_src=True),
                )
                # the RECEIVER's metadata mirrors the sender's by symmetry:
                # record for `me` what `me` RECEIVES, computed from me's
                # own edge toward other
                meta_row[me] = meta_row[me]  # placeholder, fixed below
        # receiver metadata pass
        for a, b in pairs:
            for me, other in ((a, b), (b, a)):
                e_mine = edge_toward[(me, other)]
                table = "x" if e_mine in ("S", "N") else "y"
                corners = sorted(
                    c for c, e in _CORNER_FIRST_EDGE[table].items()
                    if e == e_mine)
                meta_row[me] = (table, corners[0], corners[1])
        corner_send.append(tuple(send_row))
        corner_meta.append(tuple(meta_row))

    return ShardHaloPlan(
        n=n, h=h,
        strip_send=tuple(strip_send),
        strip_edge=tuple(strip_edge),
        corner_send=tuple(corner_send),
        corner_meta=tuple(corner_meta),
        partner=tuple(partner),
    )


# --------------------------------------------------------------------------
# staggered (D/C-grid) exchange: packed-message matching rounds
# --------------------------------------------------------------------------
# Every staggered padded block (strips, shared-interface fragments, AND
# corner blocks) references the *interior* u/v arrays of a face adjacent to
# the receiver (at cube corners the third face is adjacent to both), so a
# single exchange round per matching suffices: the sender packs all blocks
# the partner's padding sources from it into one flat message.


@dataclass(frozen=True)
class StagExchangePlan:
    n: int
    h: int
    msg_len: int
    # send_layout[r][f]: tuple of (recipe, offset) - blocks of the
    # partner's padding sourced from face f's interior u/v
    send_layout: tuple
    # recv_layout[r][f]: tuple of (recipe, offset, which) - where face f
    # unpacks into its own padded arrays; which in {"u", "v"}
    recv_layout: tuple


@functools.lru_cache(maxsize=8)
def build_stag_plan(n: int, h: int) -> StagExchangePlan:
    from .halo import _build_stag_recipes  # reuse verified recipes

    spec = halo_spec(n, h)
    urec, vrec = _build_stag_recipes(spec)
    et = edge_table()
    edge_toward = {}
    for (f, e), link in et.items():
        edge_toward[(f, link.neighbor)] = e

    def blocks_of(face):
        out = []
        for r in urec:
            if r.face == face:
                out.append(("u", r))
        for r in vrec:
            if r.face == face:
                out.append(("v", r))
        return out

    send_layout = []
    recv_layout = []
    msg_len = 0
    for pairs in MATCHINGS:
        srow = [()] * NFACES
        rrow = [()] * NFACES
        for a, b in pairs:
            for me, other in ((a, b), (b, a)):
                # blocks of MY padding sourced from `other`
                mine = [(which, r) for which, r in blocks_of(me)
                        if r.g == other]
                mine.sort(key=lambda wr: (wr[0], wr[1].dj0, wr[1].di0))
                offs = []
                off = 0
                for which, r in mine:
                    size = (r.dj1 - r.dj0) * (r.di1 - r.di0)
                    offs.append((r, off, which))
                    off += size
                msg_len = max(msg_len, off)
                rrow[me] = tuple(offs)
                # the sender's layout is the receiver's list (same static
                # data); stored under the SENDER's index
                srow_entry = tuple((r, o) for r, o, _ in offs)
                srow[other] = srow_entry
        send_layout.append(tuple(srow))
        recv_layout.append(tuple(rrow))
    return StagExchangePlan(n=n, h=h, msg_len=msg_len,
                            send_layout=tuple(send_layout),
                            recv_layout=tuple(recv_layout))


def _stag_extract(u_like, v_like, r, normal: bool):
    src = v_like if r.src_is_v else u_like
    blk = src[r.g, r.j0:r.j1, r.i0:r.i1] if src.ndim > 3 else \
        src[r.j0:r.j1, r.i0:r.i1]
    if r.transpose:
        blk = jnp.swapaxes(blk, 0, 1)
    if r.flip0:
        blk = blk[::-1]
    if r.flip1:
        blk = blk[:, ::-1]
    s = r.sgn_n if normal else r.sgn_t
    return -blk if s != 1 else blk


def shard_fill_dgrid(u_local: jnp.ndarray, v_local: jnp.ndarray,
                     plan: StagExchangePlan, normal: bool = False,
                     axis_name: str = "face"
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inside shard_map: u_local [n+1, n, ...], v_local [n, n+1, ...] ->
    padded (pu [N+1, N, ...], pv [N, N+1, ...]).  `normal=True` applies
    C-grid normal-component signs (pass (u_local=vc, v_local=uc) like
    HaloOps.fill_cgrid and swap the outputs)."""
    n, h = plan.n, plan.h
    idx = jax.lax.axis_index(axis_name)
    trail = u_local.shape[2:]
    tsize = 1
    for t in trail:
        tsize *= t

    pad_cfg = [(h, h), (h, h)] + [(0, 0)] * len(trail)
    pu = jnp.pad(u_local, pad_cfg)
    pv = jnp.pad(v_local, pad_cfg)

    for r_i, pairs in enumerate(MATCHINGS):
        perm = [(a, b) for a, b in pairs] + [(b, a) for a, b in pairs]

        # recipes index [g, j, i]; for outgoing blocks g is always the
        # sender's own face, so wrap the local arrays in a g-ignoring view
        def pack_local(f):
            u_like, v_like = _OwnFace(u_local), _OwnFace(v_local)
            parts = []
            used = 0
            for rec, off in plan.send_layout[r_i][f]:
                blk = _stag_extract(u_like, v_like, rec, normal)
                parts.append(blk.reshape((-1,) + trail))
                used += (rec.dj1 - rec.dj0) * (rec.di1 - rec.di0)
            pad_elems = plan.msg_len - used
            if pad_elems or not parts:
                parts.append(jnp.zeros((pad_elems,) + trail, u_local.dtype))
            return jnp.concatenate(parts, axis=0)

        send = jax.lax.switch(
            idx, [functools.partial(pack_local, f) for f in range(NFACES)])
        recv = jax.lax.ppermute(send, axis_name, perm)

        def unpack(f, pu, pv, recv):
            for rec, off, which in plan.recv_layout[r_i][f]:
                R = rec.dj1 - rec.dj0
                C = rec.di1 - rec.di0
                blk = recv[off:off + R * C].reshape((R, C) + trail)
                if which == "u":
                    pu = pu.at[rec.dj0:rec.dj1, rec.di0:rec.di1].set(blk)
                else:
                    pv = pv.at[rec.dj0:rec.dj1, rec.di0:rec.di1].set(blk)
            return pu, pv

        pu, pv = jax.lax.switch(
            idx, [functools.partial(unpack, f) for f in range(NFACES)],
            pu, pv, recv)
    return pu, pv


class _OwnFace:
    """Adapter: recipes index src[g, j0:j1, i0:i1]; inside shard_map the
    sender only has its own face, so g-indexing returns the local array."""

    def __init__(self, local):
        self._local = local
        self.ndim = local.ndim + 1
        self.dtype = local.dtype

    def __getitem__(self, key):
        # key is (g, jslice, islice)
        _, js, is_ = key
        return self._local[js, is_]


def shard_halo_fill(local: jnp.ndarray, plan: ShardHaloPlan,
                    axis_name: str = "face"
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inside shard_map: local [n, n, ...] -> (padded_x, padded_y)
    [N, N, ...] via 8 ppermute rounds."""
    n, h = plan.n, plan.h
    idx = jax.lax.axis_index(axis_name)
    pad_cfg = [(h, h), (h, h)] + [(0, 0)] * (local.ndim - 2)
    padded = jnp.pad(local, pad_cfg)

    # ---- phase 1: edge strips ------------------------------------------
    for r, pairs in enumerate(MATCHINGS):
        perm = [(a, b) for a, b in pairs] + [(b, a) for a, b in pairs]

        send = jax.lax.switch(
            idx, [functools.partial(plan.strip_send[r][f].apply)
                  for f in range(NFACES)], local)
        recv = jax.lax.ppermute(send, axis_name, perm)

        def place(f, padded, recv):
            e = plan.strip_edge[r][f]
            js, is_ = _EDGE_BLOCKS[e](n, h)
            if e in ("W", "E"):
                recv = jnp.swapaxes(recv, 0, 1)
            return padded.at[js, is_].set(recv)

        padded = jax.lax.switch(
            idx, [functools.partial(place, f) for f in range(NFACES)],
            padded, recv)

    # ---- phase 2: corners (strips must be complete first) --------------
    # each face receives its x-table corners from S/N partners and y-table
    # corners from W/E partners across the same 4 matchings
    px = padded
    py = padded
    for r, pairs in enumerate(MATCHINGS):
        perm = [(a, b) for a, b in pairs] + [(b, a) for a, b in pairs]
        def send_corners(f, padded):
            x0, x1 = plan.corner_send[r][f]
            return jnp.concatenate([x0.apply(padded), x1.apply(padded)],
                                   axis=0)

        send = jax.lax.switch(
            idx, [functools.partial(send_corners, f)
                  for f in range(NFACES)], padded)
        recv = jax.lax.ppermute(send, axis_name, perm)

        def place_c(f, px, py, recv):
            table, c0, c1 = plan.corner_meta[r][f]
            js0, is0 = _CORNER_BLOCKS[c0](n, h)
            js1, is1 = _CORNER_BLOCKS[c1](n, h)
            if table == "x":
                px = px.at[js0, is0].set(recv[:h])
                px = px.at[js1, is1].set(recv[h:])
            else:
                py = py.at[js0, is0].set(recv[:h])
                py = py.at[js1, is1].set(recv[h:])
            return px, py

        px, py = jax.lax.switch(
            idx, [functools.partial(place_c, f) for f in range(NFACES)],
            px, py, recv)
    return px, py
