"""Subtile (NX x NY per face) ppermute halo exchange + sharded execution.

The reference decomposes each cube face into an NX x NY grid of MPI ranks
(layouts swapped by config file,
/root/reference/src/tcn/ci/pipeline/held_suarez.py:142-218, parsed back as
``node_setup=(NX, NY/6, ranks)`` in
/root/reference/src/tcn/benchmark/geos_log_parser.py:40-58), and its halo
exchange rides MPI point-to-point transport (SURVEY.md SS2.10).  This module
is the JAX equivalent for arbitrary subtile meshes - the general
case the face-only path (parallel/shard_halo.py, exactly 6 devices) cannot
cover:

* **faces-local layout** (``face_sharded=False``): a (Py, Px) device grid;
  every device holds the same (by, bx) block of ALL 6 faces.  Any device
  count that factors (8 = 2 x 4, 4 = 2 x 2, ...) works - this is how a
  4-GPU host runs with no idle card.
* **face-sharded layout** (``face_sharded=True``): a (6, Py, Px) grid; one
  device owns one block of one face - the reference's `6*NX*NY` rank
  layout (24, 54, 96 ... devices).

Design (not an MPI translation): instead of per-neighbor
pack/unpack branches, every exchange is compiled from *per-cell source
maps* (core/topology.halo_spec - the same tables that drive the verified
single-device fills):

1. for every padded halo cell of every device, resolve the true owning
   cell (face, j, i) -> owning device + its local flat index;
2. cells a device needs from a remote peer form one message: the sorted,
   **deduplicated** set of sender-local indices (raw values - a cell needed
   by both the x- and y-corner tables, or with two different signs, is sent
   once);
3. messages are edge-colored into rounds; each round is a single
   ``lax.ppermute`` (a partial permutation over the flat device axis);
4. each device's padded array is then ONE ``jnp.take`` from
   ``concat(local_interior, 0, recv_0, ..., recv_R)`` with a static
   per-device index table; orientation (transpose/flip at rotated face
   edges) and D/C-grid sign flips are baked into the table/sign rows.

The SPMD program is identical on every device - the only device-varying
value is ``lax.axis_index`` selecting rows of the (tiny) static tables.
Equivalence with the single-device concat-assembly fill and with the
unsharded model step is asserted in tests on 8- and 24-virtual-device CPU
meshes (tests/test_subtile.py).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.topology import NFACES, halo_spec

DEV_AXIS = "dev"


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SubtileLayout:
    """Static description of a subtile decomposition."""

    n: int                 # cells per face edge
    h: int                 # halo width
    py: int                # blocks per face edge, y
    px: int                # blocks per face edge, x
    face_sharded: bool     # True: device grid (6, py, px); False: (py, px)

    def __post_init__(self):
        assert self.n % self.py == 0 and self.n % self.px == 0, (
            "face edge must divide evenly into the block grid")

    @property
    def bny(self) -> int:
        return self.n // self.py

    @property
    def bnx(self) -> int:
        return self.n // self.px

    @property
    def nslots(self) -> int:
        """Faces held locally per device."""
        return 1 if self.face_sharded else NFACES

    @property
    def ndevices(self) -> int:
        base = self.py * self.px
        return NFACES * base if self.face_sharded else base

    def dev_coords(self, d: int) -> Tuple[int, int, int]:
        """device id -> (face (or -1), by, bx)."""
        if self.face_sharded:
            f, rem = divmod(d, self.py * self.px)
            by, bx = divmod(rem, self.px)
            return f, by, bx
        by, bx = divmod(d, self.px)
        return -1, by, bx

    def owner_scalar(self, f, j, i):
        """Owning device of cell-centered (face, j, i) (vectorized)."""
        oby = j // self.bny
        obx = i // self.bnx
        if self.face_sharded:
            return (f * self.py + oby) * self.px + obx
        return oby * self.px + obx


# --------------------------------------------------------------------------
# plan
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class _Round:
    perm: Tuple[Tuple[int, int], ...]   # (src, dst) pairs, a partial perm
    msg_len: int
    pack_idx: np.ndarray                # [D, msg_len] into local-flat+zero


@dataclass(frozen=True)
class _Exchange:
    """One exchange family (scalar or staggered): rounds + unpack tables."""

    local_len: int                      # flat local source segment length
    rounds: Tuple[_Round, ...]
    # dest-name -> (idx [D, cells], sign [D, cells] or None, out_shape)
    unpack: Dict[str, Tuple[np.ndarray, Optional[np.ndarray], Tuple[int, ...]]]


@dataclass(frozen=True)
class _TwinPlan:
    """Cross-device shared-edge symmetrization tables (the sharded form
    of parallel/halo.symmetrize_shared_edges).

    Per device (rows of each table, padded to the max entry count):
    tgt [D, m]: local flat position (u-then-v segment) of a face-boundary
    staggered entry this device holds (pad = local_len -> dropped);
    pos [D, m]: position of its TWIN's value in the exchange concat
    buffer; sgn [D, m]: the pair's tangent sign."""

    rounds: Tuple[_Round, ...]
    tgt: np.ndarray
    pos: np.ndarray
    sgn: np.ndarray
    local_len: int


@dataclass(frozen=True)
class SubtilePlan:
    layout: SubtileLayout
    scalar: _Exchange     # dests: 'x', 'y'
    stag: _Exchange       # dests: 'u_t', 'v_t', 'u_n', 'v_n' (idx shared)
    twins: Optional[_TwinPlan] = None


def _schedule(pairs: Dict[Tuple[int, int], np.ndarray], D: int
              ) -> Tuple[List[_Round], Dict[Tuple[int, int], Tuple[int, int]]]:
    """Greedy edge-coloring of the (src -> dst) message multigraph into
    rounds where each device sends and receives at most once.  Returns the
    rounds and, per pair, (round index, base offset within the receiver's
    concat for that round's segment)."""
    order = sorted(pairs.items(), key=lambda kv: (-len(kv[1]), kv[0]))
    buckets: List[Dict] = []
    assign: Dict[Tuple[int, int], int] = {}
    for (s, d), cells in order:
        placed = False
        for r, b in enumerate(buckets):
            if s not in b["senders"] and d not in b["receivers"]:
                b["senders"].add(s)
                b["receivers"].add(d)
                b["pairs"].append((s, d))
                assign[(s, d)] = r
                placed = True
                break
        if not placed:
            buckets.append({"senders": {s}, "receivers": {d},
                            "pairs": [(s, d)]})
            assign[(s, d)] = len(buckets) - 1
    rounds: List[_Round] = []
    for r, b in enumerate(buckets):
        m = max(len(pairs[p]) for p in b["pairs"])
        pack = np.full((D, m), -1, np.int64)  # -1 patched to zero-idx later
        for (s, d) in b["pairs"]:
            cells = pairs[(s, d)]
            pack[s, :len(cells)] = cells
        rounds.append(_Round(perm=tuple(sorted(b["pairs"])), msg_len=m,
                             pack_idx=pack))
    return rounds, assign


class _PlanAccum:
    """Accumulates (dest cell -> source) relations for one exchange family
    across all devices, then resolves messages/rounds/unpack tables."""

    def __init__(self, layout: SubtileLayout, local_len: int):
        self.layout = layout
        self.local_len = local_len
        self.D = layout.ndevices
        # per (src,dst): growing list of sender-local flat indices
        self._pair_cells: Dict[Tuple[int, int], List[np.ndarray]] = {}
        # per dest name: list over devices of (is_local, local_idx,
        # src_dev, sender_idx, sign) cell arrays
        self._dests: Dict[str, List[Tuple]] = {}
        self._shapes: Dict[str, Tuple[int, ...]] = {}

    def add_dest(self, name: str, d: int, is_local: np.ndarray,
                 local_idx: np.ndarray, src_dev: np.ndarray,
                 sender_idx: np.ndarray, sign: Optional[np.ndarray],
                 out_shape: Tuple[int, ...]):
        self._shapes[name] = out_shape
        self._dests.setdefault(name, [])
        assert len(self._dests[name]) == d, "devices must be added in order"
        self._dests[name].append(
            (is_local, local_idx, src_dev, sender_idx, sign))
        remote = ~is_local
        if remote.any():
            sd = src_dev[remote]
            si = sender_idx[remote]
            for s in np.unique(sd):
                self._pair_cells.setdefault((int(s), d), []).append(
                    si[sd == s])

    def finish(self) -> _Exchange:
        pairs = {k: np.unique(np.concatenate(v))
                 for k, v in self._pair_cells.items()}
        rounds, assign = _schedule(pairs, self.D)
        # receiver concat layout: [local, zero, recv_0, ..., recv_{R-1}]
        seg_base = [self.local_len + 1]
        for r in rounds:
            seg_base.append(seg_base[-1] + r.msg_len)
        unpack: Dict[str, Tuple] = {}
        for name, per_dev in self._dests.items():
            cells = per_dev[0][0].size
            idx = np.zeros((self.D, cells), np.int64)
            sgn = None
            for d, (is_local, local_idx, src_dev, sender_idx, sign
                    ) in enumerate(per_dev):
                row = np.where(is_local, local_idx, 0)
                remote = ~is_local
                if remote.any():
                    sd = src_dev[remote]
                    si = sender_idx[remote]
                    pos = np.zeros(si.shape, np.int64)
                    for s in np.unique(sd):
                        msk = sd == s
                        msg = pairs[(int(s), d)]
                        pos[msk] = (seg_base[assign[(int(s), d)]]
                                    + np.searchsorted(msg, si[msk]))
                    row[remote] = pos
                idx[d] = row
                if sign is not None:
                    if sgn is None:
                        sgn = np.ones((self.D, cells), np.int8)
                    sgn[d] = sign
            unpack[name] = (idx.astype(np.int32), sgn, self._shapes[name])
        # patch pack padding (-1 -> zero cell at local_len)
        patched = []
        for r in rounds:
            pk = r.pack_idx.copy()
            pk[pk < 0] = self.local_len
            patched.append(_Round(perm=r.perm, msg_len=r.msg_len,
                                  pack_idx=pk.astype(np.int32)))
        return _Exchange(local_len=self.local_len, rounds=tuple(patched),
                         unpack=unpack)


@functools.lru_cache(maxsize=8)
def build_subtile_plan(n: int, h: int, py: int, px: int,
                       face_sharded: bool = False) -> SubtilePlan:
    lay = SubtileLayout(n=n, h=h, py=py, px=px, face_sharded=face_sharded)
    spec = halo_spec(n, h)
    bny, bnx, S, D = lay.bny, lay.bnx, lay.nslots, lay.ndevices
    Npy, Npx = bny + 2 * h, bnx + 2 * h

    # ---- scalar (cell-centered) exchange --------------------------------
    dec = {}
    for t, g in (("x", spec.gidx_x), ("y", spec.gidx_y)):
        dec[t] = (g // (n * n), (g // n) % n, g % n)   # (face, j, i) [6,N,N]

    scalar = _PlanAccum(lay, local_len=S * bny * bnx)
    for d in range(D):
        fd, by, bx = lay.dev_coords(d)
        faces = [fd] if face_sharded else list(range(NFACES))
        for t in ("x", "y"):
            sf_t, sj_t, si_t = dec[t]
            SF, SJ, SI = [], [], []
            for f in faces:
                sl = (slice(by * bny, by * bny + Npy),
                      slice(bx * bnx, bx * bnx + Npx))
                SF.append(sf_t[f][sl])
                SJ.append(sj_t[f][sl])
                SI.append(si_t[f][sl])
            qf = np.stack(SF).ravel().astype(np.int64)
            qj = np.stack(SJ).ravel().astype(np.int64)
            qi = np.stack(SI).ravel().astype(np.int64)
            oby, obx = qj // bny, qi // bnx
            src_dev = lay.owner_scalar(qf, qj, qi)
            slot_src = np.zeros_like(qf) if face_sharded else qf
            if face_sharded:
                is_local = (qf == fd) & (oby == by) & (obx == bx)
            else:
                is_local = (oby == by) & (obx == bx)
            local_idx = ((slot_src * bny + (qj - by * bny)) * bnx
                         + (qi - bx * bnx))
            sender_idx = ((slot_src * bny + (qj - oby * bny)) * bnx
                          + (qi - obx * bnx))
            scalar.add_dest(t, d, is_local, local_idx, src_dev, sender_idx,
                            None, (S, Npy, Npx))
    scalar_ex = scalar.finish()

    # ---- staggered (D/C-grid) exchange ----------------------------------
    # u [6, n+1, n] and v [6, n, n+1] concat-flat source; blocks hold
    # bny+1 / bnx+1 with duplicated shared interfaces (both neighbors
    # prognose them identically - the same shared-edge contract the
    # face-level exchange relies on), so interface cells resolve locally.
    u_count = NFACES * (n + 1) * n
    u_seg = S * (bny + 1) * bnx         # local flat layout: u then v

    def decode_stag(idx):
        is_v = idx >= u_count
        g = np.where(is_v, (idx - u_count) // (n * (n + 1)),
                     idx // ((n + 1) * n))
        rem_u = idx % ((n + 1) * n)
        rem_v = (idx - u_count) % (n * (n + 1))
        j = np.where(is_v, rem_v // (n + 1), rem_u // n)
        i = np.where(is_v, rem_v % (n + 1), rem_u % n)
        return is_v, g, j, i

    stag = _PlanAccum(lay, local_len=u_seg + S * bny * (bnx + 1))
    for d in range(D):
        fd, by, bx = lay.dev_coords(d)
        faces = [fd] if face_sharded else list(range(NFACES))
        for name, table, sgn_t_tab, sgn_n_tab, rows, cols, shape in (
                ("u", spec.u_idx, spec.u_sgn, spec.u_sgn_n,
                 Npy + 1, Npx, (S, Npy + 1, Npx)),
                ("v", spec.v_idx, spec.v_sgn, spec.v_sgn_n,
                 Npy, Npx + 1, (S, Npy, Npx + 1))):
            IDX, ST, SN = [], [], []
            for f in faces:
                sl = (slice(by * bny, by * bny + rows),
                      slice(bx * bnx, bx * bnx + cols))
                IDX.append(table[f][sl])
                ST.append(sgn_t_tab[f][sl])
                SN.append(sgn_n_tab[f][sl])
            idx = np.stack(IDX).ravel().astype(np.int64)
            st = np.stack(ST).ravel().astype(np.int8)
            sn = np.stack(SN).ravel().astype(np.int8)
            is_v, qg, qj, qi = decode_stag(idx)
            slot_src = np.zeros_like(qg) if face_sharded else qg
            # locality: the block holds rows [by*bny, by*bny+bny] of u
            # (inclusive) and cols [bx*bnx, bx*bnx+bnx] of v
            loc_u = ((qj >= by * bny) & (qj <= by * bny + bny)
                     & (qi >= bx * bnx) & (qi < bx * bnx + bnx))
            loc_v = ((qj >= by * bny) & (qj < by * bny + bny)
                     & (qi >= bx * bnx) & (qi <= bx * bnx + bnx))
            on_my_block = np.where(is_v, loc_v, loc_u)
            face_ok = (qg == fd) if face_sharded else np.ones_like(qg,
                                                                   bool)
            is_local = on_my_block & face_ok
            # owner: staggered rows/cols at block interfaces go to the
            # higher block (min caps the last interface into the last row)
            oby = np.where(is_v, qj // bny, np.minimum(qj // bny, py - 1))
            obx = np.where(is_v, np.minimum(qi // bnx, px - 1), qi // bnx)
            if face_sharded:
                src_dev = (qg * py + oby) * px + obx
            else:
                src_dev = oby * px + obx

            def flat(sv, bby, bbx):
                fu = (slot_src * (bny + 1) + (qj - bby * bny)) * bnx \
                    + (qi - bbx * bnx)
                fv = u_seg + (slot_src * bny + (qj - bby * bny)) \
                    * (bnx + 1) + (qi - bbx * bnx)
                return np.where(sv, fv, fu)

            local_idx = flat(is_v, by, bx)
            sender_idx = flat(is_v, oby, obx)
            stag.add_dest(f"{name}_t", d, is_local, local_idx, src_dev,
                          sender_idx, st, shape)
            stag.add_dest(f"{name}_n", d, is_local, local_idx, src_dev,
                          sender_idx, sn, shape)
    stag_ex = stag.finish()

    return SubtilePlan(layout=lay, scalar=scalar_ex, stag=stag_ex,
                       twins=_build_twin_plan(lay))


def _build_twin_plan(lay: SubtileLayout) -> _TwinPlan:
    """Shared-edge twin exchange plan (see _TwinPlan).

    Every face-boundary staggered entry (u rows 0/n, v cols 0/n) has
    exactly one holder device per face copy - u rows 0/n sit only in the
    by = 0 / py-1 block rows, v cols 0/n only in the bx = 0 / px-1 block
    columns - so the per-device entry lists need no duplicate handling.
    Each holder computes new = 0.5 * (mine + sign * twin), which equals
    the single-device symmetrize_shared_edges update BIT-exactly on both
    sides (multiplication by +-1 is exact)."""
    from ..core.topology import edge_twins

    n, h, py, px = lay.n, lay.h, lay.py, lay.px
    bny, bnx, S, D = lay.bny, lay.bnx, lay.nslots, lay.ndevices
    face_sharded = lay.face_sharded
    idx_a, idx_b, sgn_ab = edge_twins(n)
    twin_of: Dict[int, Tuple[int, int]] = {}
    for a, b, s in zip(idx_a.tolist(), idx_b.tolist(), sgn_ab.tolist()):
        twin_of[a] = (b, int(s))
        twin_of[b] = (a, int(s))

    u_count = NFACES * (n + 1) * n
    u_seg = S * (bny + 1) * bnx
    local_len = u_seg + S * bny * (bnx + 1)

    def decode(g):
        if g >= u_count:
            rem = g - u_count
            f, rem = divmod(rem, n * (n + 1))
            j, i = divmod(rem, n + 1)
            return True, f, j, i
        f, rem = divmod(g, (n + 1) * n)
        j, i = divmod(rem, n)
        return False, f, j, i

    def owner(is_v, f, j, i):
        if is_v:
            oby, obx = j // bny, min(i // bnx, px - 1)
        else:
            oby, obx = min(j // bny, py - 1), i // bnx
        return ((f * py + oby) * px + obx if face_sharded
                else oby * px + obx), oby, obx

    def local_flat(is_v, slot, j, i, oby, obx):
        if is_v:
            return u_seg + (slot * bny + (j - oby * bny)) * (bnx + 1) \
                + (i - obx * bnx)
        return (slot * (bny + 1) + (j - oby * bny)) * bnx + (i - obx * bnx)

    per_dev: List[List[Tuple[int, int, int, int, int]]] = [
        [] for _ in range(D)]  # (tgt_local, src_dev, src_local, sign, _)
    pair_cells: Dict[Tuple[int, int], List[int]] = {}
    for g, (g2, s) in twin_of.items():
        is_v, f, j, i = decode(g)
        d, oby, obx = owner(is_v, f, j, i)
        slot = 0 if face_sharded else f
        tgt = local_flat(is_v, slot, j, i, oby, obx)
        is_v2, f2, j2, i2 = decode(g2)
        d2, oby2, obx2 = owner(is_v2, f2, j2, i2)
        slot2 = 0 if face_sharded else f2
        src = local_flat(is_v2, slot2, j2, i2, oby2, obx2)
        per_dev[d].append((tgt, d2, src, s, g))
        if d2 != d:
            pair_cells.setdefault((d2, d), []).append(src)

    pairs = {k: np.unique(np.asarray(v, np.int64))
             for k, v in pair_cells.items()}
    rounds, assign = _schedule(pairs, D)
    seg_base = [local_len + 1]
    for r in rounds:
        seg_base.append(seg_base[-1] + r.msg_len)

    m = max((len(e) for e in per_dev), default=0)
    tgt = np.full((D, m), local_len, np.int32)   # pad -> dropped scatter
    pos = np.zeros((D, m), np.int32)
    sg = np.zeros((D, m), np.int8)
    for d, entries in enumerate(per_dev):
        for k, (t, d2, src, s, _g) in enumerate(entries):
            tgt[d, k] = t
            sg[d, k] = s
            if d2 == d:
                pos[d, k] = src
            else:
                msg = pairs[(d2, d)]
                pos[d, k] = (seg_base[assign[(d2, d)]]
                             + int(np.searchsorted(msg, src)))
    patched = []
    for r in rounds:
        pk = r.pack_idx.copy()
        pk[pk < 0] = local_len
        patched.append(_Round(perm=r.perm, msg_len=r.msg_len,
                              pack_idx=pk.astype(np.int32)))
    return _TwinPlan(rounds=tuple(patched), tgt=tgt, pos=pos, sgn=sg,
                     local_len=local_len)


# --------------------------------------------------------------------------
# filler (HaloOps drop-in inside shard_map)
# --------------------------------------------------------------------------

class SubtileFiller:
    """Drop-in for HaloOps inside shard_map on a flat 'dev' mesh axis.

    Local arrays carry the slot (face) leading dim: [S, bny(+1), bnx(+1),
    ...].  Exposes rectangular block extents (ny, nx) - the dycore slices
    through ops.ny/ops.nx so blocks need not be square."""

    def __init__(self, plan: SubtilePlan, axis_name: str = DEV_AXIS,
                 comm: bool = True):
        lay = plan.layout
        self.plan = plan
        self.axis_name = axis_name
        # comm=False: skip the ppermutes, halo segments read the sender's
        # own packed data - same local flop/memory profile, no
        # collectives.  Used to measure the compute-only leg of the
        # halo/compute overlap fraction (harness/tasks/scaling.py); NOT a
        # correct model step.
        self.comm = comm
        self.h = lay.h
        self.ny = lay.bny
        self.nx = lay.bnx
        self.nslots = lay.nslots
        self._memo: dict = {}
        dev = jnp.asarray
        self._sc_unpack = {k: (dev(i), None if s is None else dev(s), shp)
                           for k, (i, s, shp) in plan.scalar.unpack.items()}
        self._st_unpack = {k: (dev(i), None if s is None else dev(s), shp)
                           for k, (i, s, shp) in plan.stag.unpack.items()}
        self._sc_rounds = [(r.perm, dev(r.pack_idx))
                           for r in plan.scalar.rounds]
        self._st_rounds = [(r.perm, dev(r.pack_idx))
                           for r in plan.stag.rounds]
        tw = plan.twins
        self._tw = None if tw is None else (
            [(r.perm, dev(r.pack_idx)) for r in tw.rounds],
            dev(tw.tgt), dev(tw.pos), dev(tw.sgn))

    @property
    def n(self) -> int:
        assert self.ny == self.nx, (
            "square-only consumer on a rectangular subtile block")
        return self.ny

    # -- exchange core ---------------------------------------------------
    def _exchange(self, src: jnp.ndarray, rounds) -> jnp.ndarray:
        """src [L+1, ...trail] (zero row appended) -> concat of src and all
        round receive buffers."""
        didx = jax.lax.axis_index(self.axis_name)
        parts = [src]
        for perm, pack_idx in rounds:
            row = jnp.take(pack_idx, didx, axis=0)
            msg = jnp.take(src, row, axis=0)
            if self.comm:
                msg = jax.lax.ppermute(msg, self.axis_name, perm)
            parts.append(msg)
        return jnp.concatenate(parts, axis=0) if len(parts) > 1 else src

    def _unpack(self, full, table, dtype):
        idx, sgn, shp = table
        didx = jax.lax.axis_index(self.axis_name)
        row = jnp.take(idx, didx, axis=0)
        out = jnp.take(full, row, axis=0)
        if sgn is not None:
            s = jnp.take(sgn, didx, axis=0).astype(dtype)
            out = out * s.reshape(s.shape + (1,) * (out.ndim - 1))
        return out.reshape(shp + full.shape[1:])

    @staticmethod
    def _with_zero(*flats):
        cat = jnp.concatenate(flats, axis=0) if len(flats) > 1 else flats[0]
        z = jnp.zeros((1,) + cat.shape[1:], cat.dtype)
        return jnp.concatenate([cat, z], axis=0)

    # -- scalar, cell-centered -------------------------------------------
    def fill(self, field: jax.Array, direction: str = "x") -> jax.Array:
        key = id(field)
        if key not in self._memo:
            flat = field.reshape((-1,) + field.shape[3:])
            full = self._exchange(self._with_zero(flat), self._sc_rounds)
            # keep a ref to `field` so the id is not recycled in-trace
            self._memo[key] = (field, full)
        full = self._memo[key][1]
        return self._unpack(full, self._sc_unpack[direction], field.dtype)

    # -- D-grid staggered winds ------------------------------------------
    def _stag_exchange(self, u_like: jax.Array, v_like: jax.Array):
        uf = u_like.reshape((-1,) + u_like.shape[3:])
        vf = v_like.reshape((-1,) + v_like.shape[3:])
        return self._exchange(self._with_zero(uf, vf), self._st_rounds)

    def fill_dgrid(self, u: jax.Array, v: jax.Array):
        full = self._stag_exchange(u, v)
        pu = self._unpack(full, self._st_unpack["u_t"], u.dtype)
        pv = self._unpack(full, self._st_unpack["v_t"], v.dtype)
        return pu, pv

    # -- C-grid staggered normal winds -----------------------------------
    def fill_cgrid(self, uc: jax.Array, vc: jax.Array):
        # vc has u's staggering, uc has v's (same convention as
        # HaloOps.fill_cgrid); messages carry raw values, the normal-
        # component signs live in the unpack tables
        full = self._stag_exchange(vc, uc)
        pvc = self._unpack(full, self._st_unpack["u_n"], vc.dtype)
        puc = self._unpack(full, self._st_unpack["v_n"], uc.dtype)
        return puc, pvc

    # -- shared-edge symmetrization --------------------------------------
    def symmetrize_dgrid(self, u: jax.Array, v: jax.Array):
        """Sharded form of parallel/halo.symmetrize_shared_edges: average
        the two independently-prognosed copies of every face-boundary
        staggered wind entry, exchanging the twin values over ppermute
        rounds.  Each holder computes 0.5 * (mine + sign * twin), which
        matches the single-device update bit-exactly on both sides."""
        if self._tw is None:
            return u, v
        rounds, tgt_t, pos_t, sgn_t = self._tw
        uf = u.reshape((-1,) + u.shape[3:])
        vf = v.reshape((-1,) + v.shape[3:])
        nu = uf.shape[0]
        flat = jnp.concatenate([uf, vf], axis=0)
        full = self._exchange(self._with_zero(uf, vf), rounds)
        didx = jax.lax.axis_index(self.axis_name)
        tgt = jnp.take(tgt_t, didx, axis=0)
        pos = jnp.take(pos_t, didx, axis=0)
        s = jnp.take(sgn_t, didx, axis=0).astype(u.dtype)
        s = s.reshape(s.shape + (1,) * (flat.ndim - 1))
        mine = jnp.take(full, tgt, axis=0, mode="fill", fill_value=0)
        twin = jnp.take(full, pos, axis=0)
        new = 0.5 * (mine + s * twin)
        flat = flat.at[tgt].set(new, mode="drop")
        return (flat[:nu].reshape(u.shape), flat[nu:].reshape(v.shape))

    def interior(self, padded: jax.Array) -> jax.Array:
        h = self.h
        return padded[:, h:h + self.ny, h:h + self.nx]

    def zeros(self, shape, dtype=jnp.float32) -> jax.Array:
        # mark device-varying so scan carries typecheck inside shard_map
        return jax.lax.pcast(jnp.zeros(shape, dtype), self.axis_name,
                             to="varying")


# --------------------------------------------------------------------------
# block placement (global [6, ...] <-> device-stacked [D, S, ...])
# --------------------------------------------------------------------------

def _block_slices(lay: SubtileLayout, size_y: int, size_x: int, by: int,
                  bx: int) -> Tuple[slice, slice]:
    """Slices of a global (possibly staggered/padded) axis pair for block
    (by, bx).  Unpadded: size n -> bn cells, n+1 -> bn+1 (shared
    interfaces duplicated).  Padded (size n+2h / n+1+2h): block keeps its
    own halo band."""
    n, h = lay.n, lay.h
    bny, bnx = lay.bny, lay.bnx

    def one(size, b, bn):
        if size == n:
            return slice(b * bn, (b + 1) * bn)
        if size == n + 1:
            return slice(b * bn, b * bn + bn + 1)
        if size == n + 2 * h:
            return slice(b * bn, b * bn + bn + 2 * h)
        if size == n + 1 + 2 * h:
            return slice(b * bn, b * bn + bn + 1 + 2 * h)
        raise ValueError(f"axis size {size} does not match n={n}, h={h}")

    return one(size_y, by, bny), one(size_x, bx, bnx)


def stack_blocks(lay: SubtileLayout, arr) -> np.ndarray:
    """Global [6, sy, sx, ...] -> device-stacked [D, S, by, bx, ...]."""
    arr = np.asarray(arr)
    out = []
    for d in range(lay.ndevices):
        fd, by, bx = lay.dev_coords(d)
        js, is_ = _block_slices(lay, arr.shape[1], arr.shape[2], by, bx)
        blk = arr[:, js, is_]
        if lay.face_sharded:
            blk = blk[fd:fd + 1]
        out.append(blk)
    return np.stack(out, axis=0)


def unstack_blocks(lay: SubtileLayout, stacked, sy: int, sx: int
                   ) -> np.ndarray:
    """Inverse of stack_blocks (duplicated interface rows/cols agree by
    the shared-edge contract; last writer wins)."""
    stacked = np.asarray(stacked)
    out = np.zeros((NFACES, sy, sx) + stacked.shape[4:], stacked.dtype)
    for d in range(lay.ndevices):
        fd, by, bx = lay.dev_coords(d)
        js, is_ = _block_slices(lay, sy, sx, by, bx)
        if lay.face_sharded:
            out[fd, js, is_] = stacked[d, 0]
        else:
            out[:, js, is_] = stacked[d]
    return out


# --------------------------------------------------------------------------
# sharded model step
# --------------------------------------------------------------------------

def subtile_mesh(lay: SubtileLayout, devices=None):
    from jax.sharding import Mesh

    devs = devices if devices is not None else jax.devices()
    if len(devs) < lay.ndevices:
        raise ValueError(
            f"layout needs {lay.ndevices} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:lay.ndevices]), axis_names=(DEV_AXIS,))


def _put_stacked(arr_np: np.ndarray, sharding):
    """Place a host-stacked [D, ...] array under a (possibly multi-host)
    sharding.  device_put cannot target non-addressable devices, so cross-
    process meshes build the jax.Array from per-shard callbacks - each
    process materializes only its own blocks (the launcher's
    jax.distributed path, harness/launcher.py)."""
    local_only = all(d.process_index == jax.process_index()
                     for d in sharding.mesh.devices.flat)
    if local_only:
        return jax.device_put(jnp.asarray(arr_np), sharding)
    return jax.make_array_from_callback(
        arr_np.shape, sharding, lambda idx: np.ascontiguousarray(arr_np[idx]))

def build_subtile_step(ctx, lay: SubtileLayout, mesh=None, lats=None,
                       forcing=None, comm: bool = True):
    """Sharded full-model step over a subtile mesh.

    ctx: DycoreContext built for the GLOBAL grid (single-device).
    forcing(state_local, lats_local) -> state_local applies column physics
    (e.g. Held-Suarez) on the local block; lats is the global HSLatitudes
    (or any pytree of [6, sy, sx(, ...)] arrays) sliced per block.

    Returns (step, place, unplace): place/unplace move a global DycoreState
    onto/off the mesh; step runs one model step SPMD with ppermute-only
    halo exchange."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..dycore.fv_dynamics import DycoreContext, fv_dynamics_step

    mesh = mesh or subtile_mesh(lay)
    plan = build_subtile_plan(lay.n, lay.h, lay.py, lay.px,
                              lay.face_sharded)
    cfg = ctx.config

    spec = P(DEV_AXIS)
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    metrics_st = jax.tree.map(
        lambda a: _put_stacked(stack_blocks(lay, np.asarray(a)), sharding),
        ctx.metrics)
    lats_st = None
    if lats is not None:
        lats_st = jax.tree.map(
            lambda a: _put_stacked(stack_blocks(lay, np.asarray(a)),
                                   sharding), lats)

    chart_sh = None
    if ctx.chart is not None:
        from ..core.chart_corners import sharded_chart_for_subtile

        # None when blocks are too small for the corner patches (tiny
        # dev meshes) - such runs skip the corner correction
        chart_sh = sharded_chart_for_subtile(ctx.chart, lay, DEV_AXIS)

    stag_st = None
    if ctx.stag is not None:
        # per-block slices of the staggered-halo resample tables (the
        # padded weight arrays slice exactly like the metrics; interior
        # blocks get all-zero weights -> identity resample)
        stag_st = jax.tree.map(
            lambda a: _put_stacked(stack_blocks(lay, np.asarray(a)),
                                   sharding), ctx.stag)

    def local_step(state_l, metrics_l, lats_l, stag_l):
        sq = lambda t: jax.tree.map(lambda a: a[0], t)
        state_l = sq(state_l)
        stag_sq = None if stag_l is None else sq(stag_l)
        filler = SubtileFiller(plan, comm=comm)
        lctx = DycoreContext(ops=filler, metrics=sq(metrics_l),
                             ak=ctx.ak, bk=ctx.bk, config=cfg,
                             chart=chart_sh, stag=stag_sq)
        out = fv_dynamics_step(state_l, lctx)
        if forcing is not None:
            out = forcing(out, sq(lats_l))
        if cfg.edge_symmetrize:
            # same step position as the single-device model (after the
            # forcing): cross-device twin averaging, bit-matching the
            # single-device symmetrize_shared_edges
            u2, v2 = filler.symmetrize_dgrid(out.u, out.v)
            out = dataclasses.replace(out, u=u2, v=v2)
        return jax.tree.map(lambda a: a[None], out)

    if lats_st is None:
        lats_st = _put_stacked(np.zeros((lay.ndevices, 1)), sharding)
    step_sm = jax.jit(jax.shard_map(
        local_step, mesh=mesh, in_specs=(spec, spec, spec, spec),
        out_specs=spec))

    def step(state_stacked):
        # metrics/lats ride as runtime args (jit constants would need the
        # full value on every process - impossible on a multi-host mesh)
        return step_sm(state_stacked, metrics_st, lats_st, stag_st)

    def place(state):
        return jax.tree.map(
            lambda a: _put_stacked(stack_blocks(lay, np.asarray(a)),
                                   sharding), state)

    def unplace(state_stacked, n: int):
        def one(a):
            a = np.asarray(a)
            sy = n + (a.shape[2] - lay.bny)  # recover global staggering
            sx = n + (a.shape[3] - lay.bnx)
            return unstack_blocks(lay, a, sy, sx)

        return jax.tree.map(one, state_stacked)

    return step, place, unplace


# --------------------------------------------------------------------------
# MeshConfig -> stepper (the experiment pipeline's entry point)
# --------------------------------------------------------------------------

def layout_from_mesh(mesh_cfg, npx: int, halo: int) -> SubtileLayout:
    """Experiment MeshConfig (core/config.py) -> SubtileLayout.

    face=6 is the reference's 6*NX*NY rank layout (one device owns one
    block of one face, held_suarez.py:142-218); face=1 is the faces-local
    layout (every device owns the same block of all 6 faces - fills
    non-multiple-of-6 hosts with no idle device)."""
    if mesh_cfg.face not in (1, 6):
        raise ValueError(f"mesh.face must be 1 or 6, got {mesh_cfg.face}")
    return SubtileLayout(n=npx, h=halo, py=mesh_cfg.y, px=mesh_cfg.x,
                         face_sharded=mesh_cfg.face == 6)


def build_mesh_stepper(model, mesh_cfg, forcing):
    """Mesh-aware model stepper for the pipeline tasks.

    Returns (place, step, unplace, desc): `place` moves a global
    DycoreState onto the device mesh, `step` advances one model step on
    placed state, `unplace` recovers the global state for gates/archives.
    mesh_cfg None or 1 device: identity place/unplace around
    model.step_fn.  A layout that needs more devices than the host has
    raises ValueError.  Otherwise the subtile ppermute path - the layout is
    part of the experiment, not a side tool (the reference's layouts are
    config rows, /root/reference/src/tcn/ci/pipeline/held_suarez.py:272-377).

    The sharded step applies edge_symmetrize through the ppermute twin
    plan (SubtileFiller.symmetrize_dgrid), bit-matching the
    single-device numerics - sharded experiments need no config
    divergence from the single-device default."""
    if mesh_cfg is None or mesh_cfg.n_devices <= 1:
        return ((lambda s: s), model.step_fn, (lambda s: s),
                "single-device")
    if len(jax.devices()) < mesh_cfg.n_devices:
        raise ValueError(
            f"mesh layout needs {mesh_cfg.n_devices} devices, this host "
            f"has {len(jax.devices())}")
    cfg = model.config
    lay = layout_from_mesh(mesh_cfg, cfg.npx, cfg.halo)
    step, place, unplace = build_subtile_step(
        model.ctx, lay, lats=model.lats, forcing=forcing)
    kind = (f"face-sharded (6,{lay.py},{lay.px})" if lay.face_sharded
            else f"faces-local ({lay.py},{lay.px})")
    return (place, step, lambda s: unplace(s, cfg.npx),
            f"subtile {kind}, {lay.ndevices} devices")
