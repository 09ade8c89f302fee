"""The device module, the precision of the step's contractions, and the
checks that need a GPU (marked `gpu`: they skip elsewhere; phases 3 and 5
of chip_smoke.py call the same functions)."""
import numpy as np
import pytest

from geosongpu_tpu.core.config import DycoreConfig
from geosongpu_tpu.device import NoGPUError, describe, require_gpu
from geosongpu_tpu.validation import chip_checks as cc


def test_require_gpu_refuses_a_cpu_only_host():
    desc = describe()
    assert set(desc) == {"platform", "kind", "count"}
    if desc["platform"] == "gpu":
        pytest.skip("this host has a GPU")
    with pytest.raises(NoGPUError, match="no GPU"):
        require_gpu()


def test_chart_corner_contractions_ask_for_highest():
    """Every float32 contraction of a model step - the chart-corner
    einsums and the vertical-integral matmuls - asks for HIGHEST in the
    jaxpr, so that none can run in TF32 on the GPU."""
    import jax.numpy as jnp

    from geosongpu_tpu.core.chart_corners import build_chart_tables
    from geosongpu_tpu.models.held_suarez import build_model
    from geosongpu_tpu.parallel.halo import build_halo_ops

    n, h = 12, 3
    tables = build_chart_tables(n, h)
    ops = build_halo_ops(n, h)
    a = jnp.ones((6, n, n, 4), jnp.float32)
    corner = cc.contraction_precisions(
        lambda x: tables.apply_scalar(ops.fill(x, "x"), "x"), a)
    assert corner, "the chart-corner resample lost its contraction"
    model = build_model(DycoreConfig(npx=n, npz=8, dt=600.0, n_split=2))
    step = cc.contraction_precisions(model.step_fn, model.init())
    assert len(step) > len(corner)
    for dtype, prec in corner + step:
        assert dtype == "float32" and prec.count("HIGHEST") == 2, prec


def test_step_tolerance_covers_a_one_ulp_log_difference(monkeypatch):
    """The GPU-vs-CPU step bounds (chip_checks.STEP_TOLS) rest on this
    experiment: on the CPU alone, moving every log() of the dycore by one
    ulp moves the winds of one JW06 step by far more than float32
    reassociation would (the discrete Exner function is ill-conditioned),
    and by less than the bounds."""
    import types

    import jax
    import jax.numpy as jnp

    from geosongpu_tpu.dycore import sw
    from geosongpu_tpu.models.held_suarez import build_model

    cfg = DycoreConfig(npx=12, npz=72, dt=600.0, n_split=6)
    model = build_model(cfg)
    s0 = cc.jw_state(model)
    exact = model.step_fn(s0)

    def log_off_by_one_ulp(x):
        y = jnp.log(x)
        up = (jax.lax.bitcast_convert_type(x, jnp.int32) >> 3) & 1 == 1
        return jnp.where(up, jnp.nextafter(y, jnp.inf),
                         jnp.nextafter(y, -jnp.inf))

    ulp_jnp = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    ulp_jnp.log = log_off_by_one_ulp
    monkeypatch.setattr(sw, "jnp", ulp_jnp)
    diffs = cc.field_diffs(build_model(cfg).step_fn(s0), exact)
    assert diffs["u"][0] > 1e-5 and diffs["v"][0] > 1e-5, diffs
    assert not cc.step_failures(diffs), diffs


@pytest.mark.gpu
def test_gpu_step_matches_cpu_step(gpu):
    diffs = cc.step_vs_cpu(DycoreConfig(npx=48, npz=72, dt=600.0,
                                        n_split=6))
    assert not cc.step_failures(diffs), diffs


@pytest.mark.gpu
def test_physics_twins_on_gpu_within_gate(gpu):
    from geosongpu_tpu.harness.tasks.physics_standalone import (
        KERNELS, REL_TOL, _datasets, _run_kernel, _run_kernel_device)

    data = _datasets(seed=1000)
    for name in KERNELS:
        ref = _run_kernel(name, data)
        out = _run_kernel_device(name, data)
        for var in ref:
            a = ref[var].astype(np.float64)
            d = out[var].astype(np.float64) - a
            rel = np.sqrt(np.mean(d ** 2)) / (np.sqrt(np.mean(a ** 2)) or 1)
            assert rel < REL_TOL, (name, var, rel)
