"""Independent physics twins (physics/twins.py) against their primaries
(physics/standalone.py) at the dual-build 0.01% gate (the reference's
serial-vs-OACC contract, physics_standalone.py:132-144)."""
import jax.numpy as jnp
import numpy as np
import pytest

from geosongpu_tpu.physics import standalone as K
from geosongpu_tpu.physics import twins as T


def _data(seed=0, ncol=300, K=32):
    rng = np.random.default_rng(seed)
    p = np.linspace(2000.0, 1e5, K)[None].repeat(ncol, 0).astype(np.float32)
    t = (220 + 80 * (p / 1e5) ** 0.28 + rng.normal(0, 2, (ncol, K))
         ).astype(np.float32)
    qv = np.clip(0.9 * 0.622 * 611.2 *
                 np.exp(17.67 * (t - 273.16) / (t - 30.06)) / p,
                 1e-7, 0.03).astype(np.float32)
    ql = np.clip(rng.normal(3e-4, 3e-4, (ncol, K)), 0, None).astype(np.float32)
    qi = np.clip(rng.normal(5e-5, 5e-5, (ncol, K)), 0, None).astype(np.float32)
    qr = np.clip(rng.normal(1e-4, 1e-4, (ncol, K)), 0, None).astype(np.float32)
    delp = np.gradient(p, axis=1).astype(np.float32)
    return tuple(map(jnp.asarray, (t, qv, ql, qr, qi, p, delp)))


def _assert_within_gate(ref, out, names):
    for name, a, b in zip(names, ref, out):
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        scale = np.sqrt(np.mean(a ** 2)) or 1.0
        rel = np.sqrt(np.mean((b - a) ** 2)) / scale
        assert rel < 1e-4, (name, rel)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_microphysics_twin_matches_primary_within_gate(seed):
    args = _data(seed)
    ref = K.gfdl_microphysics(*args, 600.0)
    out = T.gfdl_microphysics_twin(*args, 600.0)
    _assert_within_gate(
        (ref.t, ref.qv, ref.ql, ref.qr, ref.qi, ref.precip), out,
        ("t", "qv", "ql", "qr", "qi", "precip"))


def test_microphysics_twin_keeps_leading_shape():
    """A [6, n, n, K] block (the model's layout) round-trips with the
    surface precipitation reduced over K only."""
    args = _data(seed=3, ncol=6 * 4 * 5, K=16)
    args = tuple(a.reshape(6, 4, 5, 16) for a in args)
    out = T.gfdl_microphysics_twin(*args, 600.0)
    assert out[0].shape == (6, 4, 5, 16)
    assert out[5].shape == (6, 4, 5)
    assert bool(jnp.isfinite(out[0]).all())


def test_buoyancy_twin_matches_primary():
    t, qv, _, _, _, p, _ = _data(seed=4)
    ref = K.buoyancy(t, qv, p, t + 0.5, qv)
    out = T.buoyancy_twin(t, qv, p, t + 0.5, qv)
    _assert_within_gate((ref,), (out,), ("b",))


def test_evap_subl_pdf_twin_matches_primary():
    t, qv, ql, _, qi, p, _ = _data(seed=5)
    # subsaturate half the columns so both limiter branches are exercised
    qv = qv * jnp.where(jnp.arange(qv.shape[0])[:, None] % 2 == 0, 0.7, 1.0)
    ref = K.evap_subl_pdf(t, qv, ql, qi, p, 600.0)
    out = T.evap_subl_pdf_twin(t, qv, ql, qi, p, 600.0)
    _assert_within_gate(ref, out, ("t", "qv", "ql", "qi"))


def test_fill_q2_zero_twin_matches_primary():
    rng = np.random.default_rng(6)
    q = jnp.asarray(rng.normal(1e-4, 3e-4, (200, 24)), jnp.float32)
    _, _, _, _, _, _, delp = _data(seed=6, ncol=200, K=24)
    ref = K.fill_q2_zero(q, delp)
    out = T.fill_q2_zero_twin(q, delp)
    _assert_within_gate((ref,), (out,), ("q",))
    assert float(out.min()) >= 0.0
