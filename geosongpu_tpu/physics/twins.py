"""Independent second implementations of four standalone column kernels.

The reference's physics contract compares two SOURCES of each kernel
(serial vs OpenACC Fortran,
/root/reference/src/tcn/ci/pipeline/physics_standalone.py:40-55), not two
backends of one source.  These are re-derivations with their own
formulations, gated against the primaries in physics/standalone.py at the
reference's 0.01% contract in the physics standalone tasks:

* GFDL microphysics: its own saturation functions and its own
  sedimentation recurrence (the implicit-upstream K loop unrolled over
  the static level count instead of the primary's lax.scan);
* fill_q2_zero: the top-down borrowing recurrence unrolled over K;
* buoyancy: via the DENSITY ratio at equal pressure
  (B = g (rho_env / rho_parcel - 1)) with the virtual-temperature factor
  built from its own gas constants (Rv/Rd - 1), instead of the primary's
  (Tv_p - Tv_e)/Tv_e with thermo.t_virtual's (1/EPS - 1) form;
* evap/subl PDF: its own inlined saturation pressures, the clear-sky
  fraction written as the integral of the triangular RH PDF
  (0.5 + (1 - rh)/(2 w), clipped) rather than the primary's
  ((1 - rh + w)/(2 w)) form, and the evaporation limiters composed in a
  different (min-associativity-equivalent) order.

All functions are plain jnp over [..., K] columns with K minor.
"""
from __future__ import annotations

import jax.numpy as jnp

from .standalone import (C_ACC, C_REVP, HLF, QL_CRIT, RHO0, TAU_AUTO,
                         TAU_WBF, VT_ICE_MAX, VT_RAIN_MAX)
from .thermo import CP_AIR, EPS, GRAV, HLS, HLV, RDGAS, T_ICE

# own constants for the buoyancy and evap/subl twins (not physics.thermo)
_RD = 287.04
_RV = 461.50
_G = 9.80665
_CP = 1004.64
_T0 = 273.16
_LV = 2.501e6
_LS = 2.834e6


def _qsat(t, p):
    tc = t - T_ICE
    es = 611.2 * jnp.exp(17.67 * tc / (tc + 243.5))
    es = jnp.minimum(es, 0.9 * p)
    return EPS * es / (p - (1.0 - EPS) * es)


def _qsat_ice(t, p):
    tc = t - T_ICE
    es = 611.2 * jnp.exp(21.87 * tc / (tc + 265.5))
    es = jnp.minimum(es, 0.9 * p)
    return EPS * es / (p - (1.0 - EPS) * es)


def _dqsat_dt(t, p):
    return _qsat(t, p) * HLV / (461.50 * t * t)


def _unrolled_sediment(q, c, delp):
    """Implicit upstream sedimentation, top (k=0) to bottom, unrolled over
    the static K.  Returns (q', flux out of the column bottom)."""
    K = q.shape[-1]
    cols = []
    in_flux = jnp.zeros_like(q[..., :1])
    for k in range(K):
        qk = (q[..., k:k + 1] * delp[..., k:k + 1] + in_flux) \
            / (1.0 + c[..., k:k + 1])
        in_flux = qk * c[..., k:k + 1]
        cols.append(qk / delp[..., k:k + 1])
    return jnp.concatenate(cols, axis=-1), in_flux[..., 0]


def gfdl_microphysics_twin(t, qv, ql, qr, qi, p, delp, dt):
    """Returns (t', qv', ql', qr', qi', precip) for [..., K] inputs."""
    rho = p / (RDGAS * jnp.maximum(t, 150.0))
    dz = delp / (rho * GRAV)

    # 1. saturation adjustment (2 Newton steps)
    for _ in range(2):
        qs0 = _qsat(t, p)
        dq = (qv - qs0) / (1.0 + (HLV / CP_AIR) * _dqsat_dt(t, p))
        cond = jnp.where(dq > 0, dq, jnp.maximum(dq, -ql))
        qv = qv - cond
        ql = ql + cond
        t = t + HLV / CP_AIR * cond

    # 2. freezing / melting
    tc = t - T_ICE
    frz_hom = jnp.where(tc < -40.0, ql, 0.0)
    bigg = ql * (1.0 - jnp.exp(
        -dt * 1.0e-4 * (jnp.exp(0.66 * jnp.maximum(-tc, 0.0)) - 1.0)))
    frz = jnp.minimum(ql, jnp.where((tc < 0.0) & (tc >= -40.0), bigg, 0.0)
                      + frz_hom)
    melt = jnp.where(tc > 0.0,
                     jnp.minimum(qi, CP_AIR * jnp.maximum(tc, 0.0) / HLF),
                     0.0)
    ql = ql - frz + melt
    qi = qi + frz - melt
    t = t + (HLF / CP_AIR) * (frz - melt)

    # 3. WBF deposition / ice sublimation
    qs_i = _qsat_ice(t, p)
    gam_i = 1.0 + (HLS / CP_AIR) * _dqsat_dt(t, p)
    ice_presence = 1.0 - jnp.exp(-qi / 1.0e-6)
    dep = jnp.where(tc < 0.0,
                    jnp.maximum(qv - qs_i, 0.0) / gam_i * ice_presence
                    * (1.0 - jnp.exp(-dt / TAU_WBF)), 0.0)
    sub = jnp.minimum(qi, jnp.maximum(qs_i - qv, 0.0) / gam_i
                      * (1.0 - jnp.exp(-dt / TAU_WBF)))
    qv = qv - dep + sub
    qi = qi + dep - sub
    t = t + (HLS / CP_AIR) * (dep - sub)

    # 4. warm rain
    auto = jnp.maximum(ql - QL_CRIT, 0.0) * (1.0 - jnp.exp(-dt / TAU_AUTO))
    acc = ql * (1.0 - jnp.exp(
        -dt * C_ACC * jnp.maximum(rho * qr, 0.0) ** 0.875))
    to_rain = jnp.minimum(ql, auto + acc)
    ql = ql - to_rain
    qr = qr + to_rain

    # 5. sedimentation
    cfl = lambda vt: vt * dt / jnp.maximum(dz, 1.0)
    vt_r = jnp.clip(36.34 * jnp.maximum(rho * qr, 0.0) ** 0.2
                    * jnp.sqrt(RHO0 / rho), 0.0, VT_RAIN_MAX)
    qr, rain_out = _unrolled_sediment(qr, cfl(vt_r), delp)
    vt_i = jnp.clip(3.29 * jnp.maximum(rho * qi, 0.0) ** 0.16,
                    0.0, VT_ICE_MAX)
    qi, ice_out = _unrolled_sediment(qi, cfl(vt_i), delp)
    precip = (rain_out + ice_out) / GRAV

    # 6. rain evaporation
    qs1 = _qsat(t, p)
    gam_l = 1.0 + (HLV / CP_AIR) * _dqsat_dt(t, p)
    subsat = jnp.maximum(qs1 - qv, 0.0)
    vent = 1.0 - jnp.exp(
        -dt * C_REVP * jnp.maximum(rho * qr, 0.0) ** 0.525)
    evap = jnp.minimum(qr, subsat / gam_l * vent)
    qr = qr - evap
    qv = qv + evap
    t = t - HLV / CP_AIR * evap
    return t, qv, ql, qr, qi, precip


def fill_q2_zero_twin(q, delp):
    """Top-down borrowing of negative mass, unrolled over the static K."""
    K = q.shape[-1]
    deficit = jnp.zeros_like(q[..., :1])
    cols = []
    for k in range(K):
        qk = q[..., k:k + 1] + deficit / delp[..., k:k + 1]
        deficit = jnp.minimum(qk, 0.0) * delp[..., k:k + 1]
        cols.append(jnp.maximum(qk, 0.0))
    return jnp.concatenate(cols, axis=-1)


def buoyancy_twin(t, qv, p, t_parcel, qv_parcel):
    fac = _RV / _RD - 1.0
    # density at equal pressure: rho = p / (Rd T (1 + fac q));
    # B = g (rho_env / rho_par - 1) = g (T_par (1+fac q_par)
    #                                   / (T_env (1+fac q_env)) - 1)
    num = t_parcel * (1.0 + fac * qv_parcel)
    den = t * (1.0 + fac * qv)
    return _G * (num / den - 1.0)


def evap_subl_pdf_twin(t, qv, ql, qi, p, dt, pdf_width=0.1):
    """Returns (t', qv', ql', qi')."""
    eps = _RD / _RV
    tc = t - _T0
    es_l = 611.2 * jnp.exp(17.67 * tc / (tc + 243.5))
    es_l = jnp.minimum(es_l, 0.9 * p)
    qs_l = eps * es_l / (p - (1.0 - eps) * es_l)
    es_i = 611.2 * jnp.exp(21.87 * tc / (tc + 265.5))
    es_i = jnp.minimum(es_i, 0.9 * p)
    qs_i = eps * es_i / (p - (1.0 - eps) * es_i)

    rh = qv / jnp.maximum(qs_l, 1e-12)
    # clear fraction = integral of the triangular RH PDF above saturation,
    # written as 1/2 + (1 - rh)/(2 w)
    clear = jnp.clip(0.5 + (1.0 - rh) / (2.0 * pdf_width), 0.0, 1.0)
    f = 1.0 - jnp.exp(-dt / 900.0)

    # limiter order: cap by subsaturation first, then by available
    # condensate (min is associative - same value, different source)
    evap = jnp.minimum(jnp.maximum(qs_l - qv, 0.0), ql * clear * f)
    evap = jnp.minimum(evap, ql)
    subl = jnp.minimum(jnp.maximum(qs_i - qv, 0.0), qi * clear * f)
    subl = jnp.minimum(subl, qi)

    return (t - (_LV * evap + _LS * subl) / _CP, qv + evap + subl,
            ql - evap, qi - subl)
