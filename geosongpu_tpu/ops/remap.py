"""Vertical Lagrangian-to-Eulerian remap (FV3's map1_ppm analog).

After `n_split` dynamics substeps the Lagrangian surfaces have deformed;
fields are conservatively remapped back to the reference hybrid coordinate
pe = ak + bk * ps.  The reference exposes exactly this contract through its
bridge (`ak`/`bk`/`delp`/`pe`/`pk`/`peln`/`pkz` in
/root/reference/src/tcn/py_ftn_interface/example_def_dycore.yaml:44-58).

Design: the vertical index search is a *comparison-matrix count*
(K x K elementwise ops, fully vectorized over all columns - no
searchsorted gathers with data-dependent trip counts), followed by
`take_along_axis` of cumulative integrals.  K is the minor dim so all of
this runs as wide elementwise ops.

Arrays: [..., K] cell layers, [..., K+1] interfaces, TOA -> surface.
"""
from __future__ import annotations

import jax.numpy as jnp


def _ppm_edges_k(q: jnp.ndarray, dp: jnp.ndarray):
    """Monotone PPM edge values along the last (vertical) axis for
    *nonuniform* layer thicknesses dp.  Simplified Colella-Woodward:
    4th-order interior interface values with uniform-weighting (adequate for
    smoothly varying dp), clipped to neighbor cell means for monotonicity;
    one-sided 2nd-order at top/bottom."""
    # interior interface estimate between k-1 and k (length K-1)
    qm = q[..., :-1]
    qp = q[..., 1:]
    # nonuniform 2-cell average weighted by thickness
    w = dp[..., :-1] / (dp[..., :-1] + dp[..., 1:])
    e = qm + (qp - qm) * w  # 2nd-order interface value
    # clip for monotonicity
    lo = jnp.minimum(qm, qp)
    hi = jnp.maximum(qm, qp)
    e = jnp.clip(e, lo, hi)
    # one-sided 2nd-order boundary edges: linear extrapolation from the two
    # nearest layer means through the midpoint spacing (a cell-mean edge is
    # only 1st order and visibly degrades thin boundary target layers)
    s_top = (q[..., 1:2] - q[..., :1]) / (0.5 * (dp[..., :1] + dp[..., 1:2]))
    top = q[..., :1] - s_top * 0.5 * dp[..., :1]
    s_bot = (q[..., -1:] - q[..., -2:-1]) / (0.5 * (dp[..., -1:] + dp[..., -2:-1]))
    bot = q[..., -1:] + s_bot * 0.5 * dp[..., -1:]
    edges = jnp.concatenate([top, e, bot], axis=-1)  # [..., K+1]
    aL = edges[..., :-1]
    aR = edges[..., 1:]
    # CW limiter
    extremum = (aR - q) * (q - aL) <= 0.0
    aL = jnp.where(extremum, q, aL)
    aR = jnp.where(extremum, q, aR)
    da = aR - aL
    a6 = 6.0 * (q - 0.5 * (aL + aR))
    aL = jnp.where(a6 * da > da * da, 3.0 * q - 2.0 * aR, aL)
    da = aR - aL
    a6 = 6.0 * (q - 0.5 * (aL + aR))
    aR = jnp.where(a6 * da < -da * da, 3.0 * q - 2.0 * aL, aR)
    a6 = 6.0 * (q - 0.5 * (aL + aR))
    return aL, aR, a6


def _partial_integral(aL, aR, a6, x0, x1):
    """Integral of the cell parabola over normalized coords [x0, x1] in
    [0, 1] (fraction of the layer, measured from the *top* interface),
    divided by nothing - i.e. mean * (x1 - x0) contribution."""
    # parabola q(x) = aL + x*(da + a6*(1-x)), da = aR - aL
    da = aR - aL

    def anti(x):  # antiderivative
        return aL * x + 0.5 * da * x * x + a6 * (0.5 * x * x - x * x * x / 3.0)

    return anti(x1) - anti(x0)


def remap_field(q: jnp.ndarray, pe1: jnp.ndarray, pe2: jnp.ndarray,
                kord: int = 8) -> jnp.ndarray:
    """Conservatively remap layer means q from source interfaces pe1 to
    target interfaces pe2 (both [..., K+1], monotone increasing, same
    endpoints or pe2 within pe1's range).  Returns target means [..., K2].

    Formulation: instead of searchsorted/gather, each (target l, source k)
    pair's *overlap* contribution is an elementwise expression reduced
    over k - a fused broadcast+reduction with no materialized [K2, K1]
    tensor.  Each source layer's mass
    telescopes exactly across the targets, so conservation holds to
    roundoff of local terms (no top-of-column cumulative cancellation).
    """
    dp1 = pe1[..., 1:] - pe1[..., :-1]
    aL, aR, a6 = _ppm_edges_k(q, dp1)

    # broadcast [..., K2, K1]
    lo = jnp.maximum(pe1[..., None, :-1], pe2[..., :-1, None])
    hi = jnp.minimum(pe1[..., None, 1:], pe2[..., 1:, None])
    dp1b = dp1[..., None, :]
    x0 = jnp.clip((lo - pe1[..., None, :-1]) / dp1b, 0.0, 1.0)
    x1 = jnp.clip((hi - pe1[..., None, :-1]) / dp1b, 0.0, 1.0)
    x1 = jnp.maximum(x1, x0)  # empty overlap -> zero-width integral
    contrib = _partial_integral(
        aL[..., None, :], aR[..., None, :], a6[..., None, :], x0, x1) * dp1b
    target_mass = jnp.sum(contrib, axis=-1)
    dp2 = pe2[..., 1:] - pe2[..., :-1]
    return target_mass / dp2


def _shift_k(a: jnp.ndarray, d: int, fill: float) -> jnp.ndarray:
    """a[..., l+d] along the last axis; out-of-range slots get `fill`."""
    if d == 0:
        return a
    if d > 0:
        pad = jnp.full(a.shape[:-1] + (d,), fill, a.dtype)
        return jnp.concatenate([a[..., d:], pad], axis=-1)
    pad = jnp.full(a.shape[:-1] + (-d,), fill, a.dtype)
    return jnp.concatenate([pad, a[..., :d]], axis=-1)


def remap_fields_banded(qs, pe1: jnp.ndarray, pe2: jnp.ndarray,
                        kord: int = 8, band: int = 10):
    """Banded-overlap remap of SEVERAL fields sharing one (pe1, pe2)
    coordinate pair: EXACT equal to remap_field whenever every target
    layer l draws only from source layers l-band..l+band.

    The overlap geometry (shifted interfaces, normalized integration
    bounds) depends only on the coordinates, so it is computed once and
    applied to every field.  A single reciprocal per shift replaces the
    two divides.

    Returns a list of remapped fields, one per entry of qs.
    """
    K1 = qs[0].shape[-1]
    assert pe2.shape[-1] == K1 + 1, "banded remap needs K2 == K1"
    band = min(band, K1 - 1)  # band >= K is the full form
    dp1 = pe1[..., 1:] - pe1[..., :-1]
    edges = [_ppm_edges_k(q, dp1) for q in qs]
    pe1_lo, pe1_hi = pe1[..., :-1], pe1[..., 1:]
    pe2_lo, pe2_hi = pe2[..., :-1], pe2[..., 1:]

    totals = [jnp.zeros_like(pe2_lo) for _ in qs]
    BIG = jnp.asarray(3e30, qs[0].dtype)
    for d in range(-band, band + 1):
        fill = BIG if d > 0 else -BIG
        lo_s = _shift_k(pe1_lo, d, fill)
        hi_s = _shift_k(pe1_hi, d, fill)
        dp_s = _shift_k(dp1, d, 1.0)
        rdp_s = 1.0 / dp_s
        lo = jnp.maximum(lo_s, pe2_lo)
        hi = jnp.minimum(hi_s, pe2_hi)
        x0 = jnp.clip((lo - lo_s) * rdp_s, 0.0, 1.0)
        x1 = jnp.clip((hi - lo_s) * rdp_s, 0.0, 1.0)
        x1 = jnp.maximum(x1, x0)
        for i, (aL, aR, a6) in enumerate(edges):
            totals[i] = totals[i] + _partial_integral(
                _shift_k(aL, d, 0.0), _shift_k(aR, d, 0.0),
                _shift_k(a6, d, 0.0), x0, x1) * dp_s
    rdp2 = 1.0 / (pe2_hi - pe2_lo)
    return [t * rdp2 for t in totals]


def remap_field_banded(q: jnp.ndarray, pe1: jnp.ndarray, pe2: jnp.ndarray,
                       kord: int = 8, band: int = 10) -> jnp.ndarray:
    """Single-field form of remap_fields_banded (shared body).  The
    HeldSuarez task's check() compares banded vs full on the final state
    every run (a physics-reasons gate on the band assumption)."""
    return remap_fields_banded([q], pe1, pe2, kord, band)[0]


def lagrangian_to_eulerian(delp, pt, u_cell, v_cell, q, ak, bk, ptop,
                           kord: int = 8):
    """Full remap step on cell-centered fields [..., K] (+ tracers with a
    trailing tracer axis): rebuild target coordinate from the new surface
    pressure and remap everything.  Winds here are cell-centered (the model
    remaps D-grid winds by averaging to cells, remapping, and adding the
    increment back at the staggered points - see dycore/fv_dynamics.py).

    Returns (delp_new, pt_new, u_new, v_new, q_new, ps, pe2).
    """
    from .vertical import interfaces_from_delp

    pe1 = interfaces_from_delp(delp, ptop)
    ps = pe1[..., -1]
    pe2 = ak + bk * ps[..., None]
    delp_new = pe2[..., 1:] - pe2[..., :-1]

    pt_new = remap_field(pt, pe1, pe2, kord)
    u_new = remap_field(u_cell, pe1, pe2, kord)
    v_new = remap_field(v_cell, pe1, pe2, kord)
    if q is not None:
        # tracers carry a trailing tracer axis [..., K, T]
        qs = jnp.moveaxis(q, -1, 0)
        qs = jnp.stack(
            [remap_field(qs[t], pe1, pe2, kord) for t in range(qs.shape[0])],
            axis=0,
        )
        q_new = jnp.moveaxis(qs, 0, -1)
    else:
        q_new = None
    return delp_new, pt_new, u_new, v_new, q_new, ps, pe2
