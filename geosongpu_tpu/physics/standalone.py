"""Moist-physics standalone column kernels.

The reference validates seven OpenACC Fortran physics kernels against their
serial builds at 0.01% (/root/reference/src/tcn/ci/pipeline/physics_standalone.py:13-146;
kernel list :149-339: MoistRadCoup, GFDLMicrophysics, Buoyancy, CupGfSh,
EvapSublPdfLoop, FillQ2Zero, AerActivation).  The Fortran sources live in
external orphan branches, so these are JAX *re-derivations of the
same physical roles* using standard formulations - not ports.  Each kernel
is a pure column function over [..., K] arrays (K minor => wide vector ops;
vertical scans are lax scans/cumsums), jit- and vmap-friendly.

Validation mirrors the reference's serial-vs-OACC gate: each kernel runs on
the default backend (jit) and on the CPU backend over 5 synthetic datasets
and must agree within 0.01% (harness/tasks/physics_standalone.py).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .thermo import (CP_AIR, EPS, GRAV, HLV, HLS, RDGAS, T_ICE, dqsat_dt,
                     qsat, qsat_ice, t_virtual)


# --------------------------------------------------------------------------
# FillQ2Zero: conservative removal of negative tracer values
# --------------------------------------------------------------------------

def fill_q2_zero(q: jnp.ndarray, delp: jnp.ndarray) -> jnp.ndarray:
    """Eliminate negative mixing ratios by borrowing mass from the layer
    below (top-down pass), then clip any residual negative in the bottom
    layer.  Column mass of q*delp is conserved except for the final clip.
    Arrays [..., K]."""
    K = q.shape[-1]

    def body(carry, k):
        q_above_deficit = carry  # mass deficit [Pa kg/kg] owed from above
        qk = q[..., k] + q_above_deficit / delp[..., k]
        deficit = jnp.minimum(qk, 0.0) * delp[..., k]
        qk = jnp.maximum(qk, 0.0)
        return deficit, qk

    deficit0 = jnp.zeros_like(q[..., 0])
    _, cols = jax.lax.scan(body, deficit0, jnp.arange(K))
    return jnp.moveaxis(cols, 0, -1)


# --------------------------------------------------------------------------
# Buoyancy: parcel buoyancy profile
# --------------------------------------------------------------------------

def buoyancy(t: jnp.ndarray, qv: jnp.ndarray, p: jnp.ndarray,
             t_parcel: jnp.ndarray, qv_parcel: jnp.ndarray) -> jnp.ndarray:
    """Parcel buoyancy B = g (Tv_p - Tv_e)/Tv_e per layer [m/s^2]."""
    tv_env = t_virtual(t, qv)
    tv_par = t_virtual(t_parcel, qv_parcel)
    return GRAV * (tv_par - tv_env) / tv_env


# --------------------------------------------------------------------------
# EvapSublPdfLoop: condensate evaporation/sublimation with a subgrid PDF
# --------------------------------------------------------------------------

def evap_subl_pdf(t: jnp.ndarray, qv: jnp.ndarray, ql: jnp.ndarray,
                  qi: jnp.ndarray, p: jnp.ndarray, dt: float,
                  pdf_width: float = 0.1) -> Tuple[jnp.ndarray, ...]:
    """Evaporate cloud liquid / sublimate cloud ice into subsaturated air.

    Subgrid variability: a symmetric triangular RH PDF of half-width
    `pdf_width`; the clear (subsaturated) fraction drives evaporation with
    a 900 s timescale.  Returns (t', qv', ql', qi')."""
    qs_l = qsat(t, p)
    qs_i = qsat_ice(t, p)
    rh = qv / jnp.maximum(qs_l, 1e-12)
    # clear-sky fraction from triangular PDF centered at rh
    clear = jnp.clip((1.0 - rh + pdf_width) / (2.0 * pdf_width), 0.0, 1.0)
    tau = 900.0
    f = 1.0 - jnp.exp(-dt / tau)

    evap = jnp.minimum(ql, ql * clear * f)
    evap = jnp.minimum(evap, jnp.maximum(qs_l - qv, 0.0))
    subl = jnp.minimum(qi, qi * clear * f)
    subl = jnp.minimum(subl, jnp.maximum(qs_i - qv, 0.0))

    qv2 = qv + evap + subl
    ql2 = ql - evap
    qi2 = qi - subl
    t2 = t - (HLV * evap + HLS * subl) / CP_AIR
    return t2, qv2, ql2, qi2


# --------------------------------------------------------------------------
# AerActivation: aerosol activation (lognormal CCN spectrum)
# --------------------------------------------------------------------------

def aer_activation(num_aer: jnp.ndarray, w: jnp.ndarray, t: jnp.ndarray,
                   p: jnp.ndarray, sigma_g: float = 2.0,
                   s_crit0: float = 0.003) -> jnp.ndarray:
    """Activated cloud droplet number [same units as num_aer].

    Twomey/ARG-style: maximum supersaturation from the updraft, activated
    fraction = lognormal CDF of critical supersaturation."""
    # max supersaturation ~ w^(3/4) scaling (ARG)
    smax = jnp.clip(0.01 * jnp.maximum(w, 0.0) ** 0.75, 1e-5, 0.1)
    # activated fraction: erf form of lognormal CDF
    ln_ratio = jnp.log(s_crit0 / smax)
    ln_sig = jnp.log(sigma_g)
    frac = 0.5 * (1.0 - jax.lax.erf(ln_ratio / (jnp.sqrt(2.0) * 1.5 * ln_sig)))
    return num_aer * frac


# --------------------------------------------------------------------------
# GFDLMicrophysics (1M-lite): the flagship column kernel
# --------------------------------------------------------------------------

class MicrophysicsOut(NamedTuple):
    t: jnp.ndarray
    qv: jnp.ndarray
    ql: jnp.ndarray
    qr: jnp.ndarray
    qi: jnp.ndarray
    precip: jnp.ndarray  # surface precip flux accumulated over dt [kg/m^2]


# ---- GFDL-1M process constants ------------------------------------------
HLF = HLS - HLV          # latent heat of fusion [J/kg]
RHO0 = 1.2               # reference air density [kg/m^3]
QL_CRIT = 5.0e-4         # Kessler autoconversion threshold [kg/kg]
TAU_AUTO = 1800.0        # autoconversion timescale [s]
C_ACC = 2.2              # rain-accretion rate coefficient
C_REVP = 0.3             # rain-evaporation ventilation coefficient
TAU_WBF = 600.0          # Bergeron-Findeisen deposition timescale [s]
VT_RAIN_MAX = 12.0       # clip on bulk rain fall speed [m/s]
VT_ICE_MAX = 1.5


def vt_rain(rho, qr):
    """Lin et al. (1983)-type bulk mass-weighted rain fall speed [m/s]:
    vt = 36.34 (rho qr)^0.2 sqrt(rho0/rho), clipped (the GFDL 1M scheme's
    vtr formula family; role of gfdl_cloud_microphys' terminal_fall
    speeds)."""
    rq = jnp.maximum(rho * qr, 0.0)
    return jnp.clip(36.34 * rq ** 0.2 * jnp.sqrt(RHO0 / rho),
                    0.0, VT_RAIN_MAX)


def vt_ice(rho, qi):
    """Heymsfield & Donner (1990) bulk ice fall speed:
    vt = 3.29 (rho qi)^0.16, clipped."""
    rq = jnp.maximum(rho * qi, 0.0)
    return jnp.clip(3.29 * rq ** 0.16, 0.0, VT_ICE_MAX)


def _sediment_implicit(q, delp, c):
    """Implicit upstream sedimentation: unconditionally stable for any
    Courant number c = vt dt / dz (rain falls through many layers per
    physics step).  Per layer (TOA -> surface): q' = (q delp + in) /
    ((1 + c) delp), out = q' c delp.  Returns (q', surface flux)."""
    K = q.shape[-1]

    def body(in_flux, k):
        qk = (q[..., k] * delp[..., k] + in_flux) / (1.0 + c[..., k])
        out = qk * c[..., k]
        return out, qk / delp[..., k]

    zeros = jnp.zeros_like(q[..., 0])
    out_last, cols = jax.lax.scan(body, zeros, jnp.arange(K))
    return jnp.moveaxis(cols, 0, -1), out_last


def gfdl_microphysics(t, qv, ql, qr, qi, p, delp, dt) -> MicrophysicsOut:
    """Single-moment (GFDL-1M process set) bulk microphysics column:

      1. saturation adjustment w.r.t. liquid (2 Newton iterations),
      2. ice phase: homogeneous freezing below -40 C, Bigg (1953)-type
         heterogeneous freezing between -40 and 0 C, melting above 0 C
         limited by available sensible heat,
      3. Wegener-Bergeron-Findeisen vapor deposition onto ice (growth to
         ice saturation where ice is present) and ice sublimation in
         ice-subsaturated air,
      4. warm rain: Kessler autoconversion + Lin-type accretion,
      5. sedimentation of rain AND ice with Lin/Heymsfield-Donner bulk
         fall speeds through an implicit upstream pass (any Courant),
      6. rain evaporation with a (rho qr)^0.525 ventilation factor.

    All phase changes carry latent heating; column total water is
    conserved up to surface precipitation (asserted in tests).  Vertical
    index runs TOA -> surface.  Role parity: the reference's
    GFDLMicrophysics standalone
    (/root/reference/src/tcn/ci/pipeline/physics_standalone.py:181-191).
    """
    rho = p / (RDGAS * jnp.maximum(t, 150.0))
    dz = delp / (rho * GRAV)

    # --- 1. saturation adjustment (2 Newton iterations) ------------------
    for _ in range(2):
        qs0 = qsat(t, p)
        dq = (qv - qs0) / (1.0 + (HLV / CP_AIR) * dqsat_dt(t, p))
        cond = jnp.where(dq > 0, dq, jnp.maximum(dq, -ql))
        qv = qv - cond
        ql = ql + cond
        t = t + HLV / CP_AIR * cond

    # --- 2. freezing / melting -------------------------------------------
    tc = t - T_ICE
    frz_hom = jnp.where(tc < -40.0, ql, 0.0)
    # Bigg-type stochastic freezing rate, ~0 at 0C, fast by -30C
    bigg = ql * (1.0 - jnp.exp(-dt * 1.0e-4 *
                               (jnp.exp(0.66 * jnp.maximum(-tc, 0.0)) - 1.0)))
    frz = jnp.minimum(ql, jnp.where((tc < 0.0) & (tc >= -40.0), bigg, 0.0)
                      + frz_hom)
    melt = jnp.where(tc > 0.0,
                     jnp.minimum(qi, CP_AIR * jnp.maximum(tc, 0.0) / HLF),
                     0.0)
    ql = ql - frz + melt
    qi = qi + frz - melt
    t = t + (HLF / CP_AIR) * (frz - melt)

    # --- 3. WBF deposition / ice sublimation ------------------------------
    qs_i = qsat_ice(t, p)
    gam_i = 1.0 + (HLS / CP_AIR) * dqsat_dt(t, p)
    ice_presence = 1.0 - jnp.exp(-qi / 1.0e-6)
    dep = jnp.where(
        (tc < 0.0),
        jnp.maximum(qv - qs_i, 0.0) / gam_i * ice_presence
        * (1.0 - jnp.exp(-dt / TAU_WBF)),
        0.0)
    sub = jnp.minimum(
        qi, jnp.maximum(qs_i - qv, 0.0) / gam_i
        * (1.0 - jnp.exp(-dt / TAU_WBF)))
    qv = qv - dep + sub
    qi = qi + dep - sub
    t = t + (HLS / CP_AIR) * (dep - sub)

    # --- 4. warm rain ------------------------------------------------------
    auto = jnp.maximum(ql - QL_CRIT, 0.0) * (1.0 - jnp.exp(-dt / TAU_AUTO))
    acc = ql * (1.0 - jnp.exp(-dt * C_ACC *
                              jnp.maximum(rho * qr, 0.0) ** 0.875))
    to_rain = jnp.minimum(ql, auto + acc)
    ql = ql - to_rain
    qr = qr + to_rain

    # --- 5. sedimentation (rain + ice), implicit upstream -----------------
    cr = vt_rain(rho, qr) * dt / jnp.maximum(dz, 1.0)
    qr, rain_out = _sediment_implicit(qr, delp, cr)
    ci = vt_ice(rho, qi) * dt / jnp.maximum(dz, 1.0)
    qi, ice_out = _sediment_implicit(qi, delp, ci)
    precip = (rain_out + ice_out) / GRAV   # [kg/m^2 per dt]

    # --- 6. rain evaporation ----------------------------------------------
    qs1 = qsat(t, p)
    gam_l = 1.0 + (HLV / CP_AIR) * dqsat_dt(t, p)
    subsat = jnp.maximum(qs1 - qv, 0.0)
    vent = 1.0 - jnp.exp(-dt * C_REVP *
                         jnp.maximum(rho * qr, 0.0) ** 0.525)
    evap = jnp.minimum(qr, subsat / gam_l * vent)
    qr = qr - evap
    qv = qv + evap
    t = t - HLV / CP_AIR * evap

    return MicrophysicsOut(t=t, qv=qv, ql=ql, qr=qr, qi=qi, precip=precip)


# --------------------------------------------------------------------------
# MoistRadCoup: condensate -> radiative cloud properties
# --------------------------------------------------------------------------

def moist_rad_coup(ql: jnp.ndarray, qi: jnp.ndarray, p: jnp.ndarray,
                   t: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    """Diagnose cloud fraction and effective radii for radiation coupling
    (Sundqvist-style fraction, T-dependent ice radius)."""
    q_cond = ql + qi
    cf = jnp.clip(1.0 - jnp.exp(-q_cond / 2.0e-5), 0.0, 1.0)
    re_liq = jnp.full_like(ql, 10.0e-6)
    re_ice = jnp.clip((t - 180.0) * 0.5e-6, 10.0e-6, 60.0e-6)
    return {"cloud_fraction": cf, "re_liquid": re_liq, "re_ice": re_ice,
            "condensate": q_cond}


# --------------------------------------------------------------------------
# CupGfSh: shallow convection (bulk mass-flux lite)
# --------------------------------------------------------------------------

def cup_gf_sh(t, qv, p, delp, dt) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Shallow cumulus mixing: where the lowest layer is buoyantly unstable
    w.r.t. the layer above (virtual potential temperature decreasing with
    height), mix T and qv over the unstable depth with a 3 h timescale.
    Returns (t', qv')."""
    theta_v = t_virtual(t, qv) * (1.0e5 / p) ** (RDGAS / CP_AIR)
    # instability: theta_v below > theta_v above (K increases downward)
    unstable = theta_v[..., 1:] > theta_v[..., :-1] + 0.1
    # mixing coefficient per interface
    f = (1.0 - jnp.exp(-dt / 10800.0)) * 0.5
    mix = jnp.where(unstable, f, 0.0)

    def mix_field(a):
        flux = mix * (a[..., 1:] - a[..., :-1])  # downgradient (upward)
        da = jnp.zeros_like(a)
        da = da.at[..., :-1].add(flux * delp[..., 1:] /
                                 (delp[..., :-1] + delp[..., 1:]))
        da = da.at[..., 1:].add(-flux * delp[..., :-1] /
                                (delp[..., :-1] + delp[..., 1:]))
        return a + da

    return mix_field(t), mix_field(qv)
