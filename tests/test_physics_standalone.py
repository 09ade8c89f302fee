"""Column-kernel physics tests: conservation and physical-bounds properties
(the reference validates only build-vs-build agreement; these check the
physics itself)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geosongpu_tpu.physics import standalone as K
from geosongpu_tpu.physics.thermo import CP_AIR, HLV, qsat


@pytest.fixture()
def cols():
    rng = np.random.default_rng(3)
    ncol, nz = 64, 30
    p = np.linspace(2000.0, 1.0e5, nz)[None, :] * np.ones((ncol, 1))
    t = 220.0 + 80.0 * (p / 1.0e5) ** 0.28
    qv = 0.8 * np.asarray(qsat(jnp.asarray(t), jnp.asarray(p)))
    return {
        "t": jnp.asarray(t, jnp.float32),
        "qv": jnp.asarray(qv, jnp.float32),
        "ql": jnp.asarray(np.clip(rng.normal(3e-4, 2e-4, (ncol, nz)), 0, None), jnp.float32),
        "qi": jnp.asarray(np.clip(rng.normal(5e-5, 5e-5, (ncol, nz)), 0, None), jnp.float32),
        "qr": jnp.asarray(np.clip(rng.normal(1e-4, 1e-4, (ncol, nz)), 0, None), jnp.float32),
        "p": jnp.asarray(p, jnp.float32),
        "delp": jnp.asarray(np.gradient(p, axis=1), jnp.float32),
    }


def test_fillq2zero_removes_negatives_conserves_mass(cols):
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.normal(1e-4, 3e-4, (64, 30)), jnp.float32)
    out = K.fill_q2_zero(q, cols["delp"])
    assert float(out.min()) >= 0.0
    # mass conserved except the bottom-layer clip
    m0 = np.sum(np.asarray(q) * np.asarray(cols["delp"]), axis=-1)
    m1 = np.sum(np.asarray(out) * np.asarray(cols["delp"]), axis=-1)
    # wherever no clip was needed (column mass positive enough), masses match
    clipped = m1 - m0
    assert (clipped >= -1e-5).all()  # clip only ever adds mass (f32 noise)


def test_evap_subl_conserves_water_and_energy(cols):
    t2, qv2, ql2, qi2 = K.evap_subl_pdf(
        cols["t"], cols["qv"], cols["ql"], cols["qi"], cols["p"], 600.0)
    water0 = cols["qv"] + cols["ql"] + cols["qi"]
    water1 = qv2 + ql2 + qi2
    np.testing.assert_allclose(np.asarray(water1), np.asarray(water0),
                               rtol=1e-6, atol=1e-9)
    # evaporation cools
    assert float((t2 - cols["t"]).max()) <= 1e-6
    assert float(ql2.min()) >= -1e-9 and float(qi2.min()) >= -1e-9


def test_microphysics_conserves_moist_static_energy(cols):
    out = K.gfdl_microphysics(cols["t"], cols["qv"], cols["ql"], cols["qr"],
                              cols["qi"], cols["p"], cols["delp"], 600.0)
    dp = np.asarray(cols["delp"])
    # column water: vapor+liquid+rain+ice after minus before = -precip
    w0 = np.sum(np.asarray(cols["qv"] + cols["ql"] + cols["qr"] + cols["qi"])
                * dp, axis=-1)
    w1 = np.sum(np.asarray(out.qv + out.ql + out.qr + out.qi) * dp, axis=-1)
    from geosongpu_tpu.physics.thermo import GRAV

    np.testing.assert_allclose(w1 + np.asarray(out.precip) * GRAV, w0,
                               rtol=5e-4, atol=1e-6)
    assert float(out.qv.min()) >= 0.0 or float(out.qv.min()) > -1e-8
    assert np.isfinite(np.asarray(out.t)).all()
    assert float(out.precip.min()) >= 0.0


def test_aer_activation_bounded(cols):
    n = jnp.full((64, 30), 1e8, jnp.float32)
    w = jnp.full((64, 30), 0.5, jnp.float32)
    act = K.aer_activation(n, w, cols["t"], cols["p"])
    a = np.asarray(act)
    assert (a >= 0).all() and (a <= 1e8 + 1).all()
    # stronger updraft activates more
    act2 = K.aer_activation(n, 4 * w, cols["t"], cols["p"])
    assert float((act2 - act).min()) >= 0.0


def test_cup_gf_sh_conserves_column_integrals(cols):
    t2, qv2 = K.cup_gf_sh(cols["t"], cols["qv"], cols["p"], cols["delp"],
                          600.0)
    dp = np.asarray(cols["delp"])
    np.testing.assert_allclose(
        np.sum(np.asarray(qv2) * dp, -1),
        np.sum(np.asarray(cols["qv"]) * dp, -1), rtol=1e-5)


def test_moist_rad_coup_fields(cols):
    out = K.moist_rad_coup(cols["ql"], cols["qi"], cols["p"], cols["t"])
    cf = np.asarray(out["cloud_fraction"])
    assert (cf >= 0).all() and (cf <= 1).all()
    assert (np.asarray(out["re_ice"]) >= 10e-6 - 1e-12).all()


def test_microphysics_sedimentation_stable_at_large_courant(cols):
    """Implicit upstream fall: rain falling many layers per step (CFL >> 1)
    must stay bounded, positive, and conservative."""
    qr = jnp.full_like(cols["qr"], 5e-3)  # heavy rain -> vt ~ 10 m/s
    out = K.gfdl_microphysics(cols["t"], cols["qv"], cols["ql"], qr,
                              cols["qi"], cols["p"], cols["delp"], 1800.0)
    assert float(out.qr.min()) >= 0.0
    assert np.isfinite(np.asarray(out.qr)).all()
    from geosongpu_tpu.physics.thermo import GRAV

    dp = np.asarray(cols["delp"])
    w0 = np.sum(np.asarray(cols["qv"] + cols["ql"] + qr + cols["qi"]) * dp,
                axis=-1)
    w1 = np.sum(np.asarray(out.qv + out.ql + out.qr + out.qi) * dp, axis=-1)
    np.testing.assert_allclose(w1 + np.asarray(out.precip) * GRAV, w0,
                               rtol=5e-4, atol=1e-6)


def test_microphysics_ice_processes(cols):
    """Cold columns: supercooled liquid freezes (warming), ice deposits in
    ice-supersaturated air, fall speeds stay in physical ranges."""
    t_cold = cols["t"] - 60.0  # well below freezing aloft
    out = K.gfdl_microphysics(t_cold, cols["qv"], cols["ql"], cols["qr"],
                              cols["qi"], cols["p"], cols["delp"], 600.0)
    # homogeneous freezing below -40C leaves no liquid there (mask on the
    # post-adjustment temperature: condensation heating can lift a cell
    # past the threshold)
    mask = np.asarray(out.t) < (273.16 - 40.0)
    assert float(np.asarray(out.ql)[mask].max(initial=0.0)) < 1e-7
    # freezing releases latent heat: mean T change in frozen region >= 0
    dT = np.asarray(out.t - t_cold)
    assert dT[mask].mean() >= -1e-3
    # fall speeds bounded
    rho = np.asarray(cols["p"]) / (287.04 * np.asarray(t_cold))
    vtr = np.asarray(K.vt_rain(jnp.asarray(rho), out.qr))
    vti = np.asarray(K.vt_ice(jnp.asarray(rho), out.qi))
    assert vtr.max() <= K.VT_RAIN_MAX + 1e-6 and vtr.min() >= 0
    assert vti.max() <= K.VT_ICE_MAX + 1e-6 and vti.min() >= 0


def test_all_seven_kernels_dual_build_gate():
    """The reference's serial-vs-OACC 0.01% contract
    (physics_standalone.py:132-144): CPU build vs default-device build
    (independent twin where one exists) for every kernel on one dataset
    (the task runs 5)."""
    from geosongpu_tpu.harness.tasks.physics_standalone import (
        KERNELS, _datasets, _run_kernel, _run_kernel_device)

    data = _datasets(seed=7)
    for name in KERNELS:
        ref = _run_kernel(name, data)
        opt = _run_kernel_device(name, data)
        assert set(ref) == set(opt)
        for var in ref:
            a = ref[var].astype(np.float64)
            b = opt[var].astype(np.float64)
            scale = np.sqrt(np.mean(a ** 2)) or 1.0
            rel = np.sqrt(np.mean((b - a) ** 2)) / scale
            assert rel < 1e-4, (name, var, rel)
