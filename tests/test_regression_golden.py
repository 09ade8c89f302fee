"""Golden-trajectory regression guard.

The reference's correctness story compares against Fortran runs on the
cluster; across build rounds of this framework we additionally pin the c12
Held-Suarez trajectory: any change to the numerics shows up as a drift in
these f64 field fingerprints.  Regenerate *deliberately* (and say so in
the commit message) when the discretization is intentionally improved:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m tests.test_regression_golden

and paste the printed values into GOLDEN in
geosongpu_tpu/validation/chip_checks.py (shared with the GPU check).
"""
import jax
import pytest

from geosongpu_tpu.validation.chip_checks import (GOLDEN, RTOL,
                                                  golden_errors,
                                                  golden_failures,
                                                  golden_fingerprints)

# (sum, abs-sum) after 24 steps of c12-L16 HS, n_split=6, dt=1200,
# perturb=0.01 seed=42 - recorded on the CPU backend, jax 0.9.0
# regenerated 2026-08-17 (x2): contravariant advective winds (cosa/sina),
# then PPM-upwinded vorticity flux + top sponge - deliberate numerics
# improvements, each verified by the stability suite
# regenerated 2026-08-20: contravariant KE (center + corner cosa cross
# terms), terrain-capable PGF (phis = 0 here), shared-edge
# symmetrization - deliberate metric-completeness improvements (verified
# by the balanced-flow convergence + mountain tests)
# regenerated 2026-08-20 (x2): face-edge consistency overhaul - halo wind
# basis rotation + chart resampling, chart-spacing C-grid gradients,
# linear-exact corner interpolation, post-transport halo refill before
# the backward PGF.  Balanced-jet edge-band imbalance drops 31x at c48
# and now CONVERGES with resolution (tests/test_balanced_flow.py gates)
# regenerated 2026-08-21: chart-consistent cube corners (chart_corners
# default on) - corner L-region resampling of fills/A-grid winds/vort +
# chart-evaluated cosa and corner_dw.  Balanced-jet corner-disk residual
# drops 8.3e-5 (flat) -> 5.4e-6 (converging to the edge-band floor);
# gated by the corner convergence test in tests/test_balanced_flow.py
# NOTE: recorded under the suite's 8-virtual-device CPU env (XLA
# partitions reductions differently per device count, and 24 chaotic
# steps amplify the reassociation) - regenerate via the __main__ block,
# which now pins the same device count
# regenerated 2026-08-21 (x2): metric-exact corner-dual divergence in
# the damping operator (FV3's divergence_corner: normal-projected winds
# x dual-edge chords / dual area, replacing locally-orthogonal
# differences) - deliberate dynamics-term improvement, stability suite +
# balanced-flow gates green
# regenerated 2026-08-21 (x3): strip-form A-grid halo corrections - the
# a_grid_winds chain itself is BIT-identical (verified cell-by-cell),
# but the reshaped HLO changes XLA's FMA contraction choices elsewhere
# in the step (3 cells at 7e-12 after one step), which 24 chaotic steps
# amplify into the cancellation-dominated v sum.  abs-sums moved < RTOL.
# regenerated 2026-08-21 (x4): chart-consistent damping divergence
# (sw.damping_divergence) - the corner-dual operator's raw staggered
# halos made smooth cross-edge flow look divergent (~2e-4 1/s, 5 orders
# above interior; exposed by the JW06 balanced state, which it destroyed
# at +40 hPa/day).  Owner-side normal fields + tangential exchange +
# staggered chart resample + corner-disk blend; JW06 steady-state drift
# drops 42 -> 5 hPa/day at c24.  A real dynamics-term change: u/v/delp
# fingerprints all move.
# regenerated 2026-08-21 (x5): in-kernel blended damping divergence
# (PaddedMetrics.div_blend) replacing the exchange+resample glue form -
# same solid-body quality (<= 6e-6 on edges AND corner disks) at zero
# glue cost
# regenerated 2026-08-21 (x6): damping_exchange="auto" - small grids
# (npx <= 96, incl. this c12 golden) return to the exchange+resample
# formulation (full checkerboard control); large grids keep the
# in-kernel blend
# regenerated 2026-10-16: the model step takes its context arrays (grid
# metrics, vertical coordinate, latitudes) as jit ARGUMENTS instead of
# closure constants (models/step.py; XLA compiled the c192-L72 step
# 3-4x slower with ~40 MB of embedded literals).  Same operations, but
# XLA no longer folds or reassociates the constant factors, so float32
# rounding moves: abs-sums by <= 4e-5 (< RTOL); v's signed sum, which
# cancels to 0.2% of its abs-sum, by 6.4e-3.
# The GPU check of the same fingerprints (same RTOL) is
# test_c12_trajectory_matches_golden_on_gpu below and phase 3 of
# chip_smoke.py.


@pytest.fixture
def cpu_backend():
    if jax.default_backend() != "cpu":
        pytest.skip("golden recorded on the CPU backend")


def test_c12_trajectory_matches_golden(cpu_backend):
    fps = golden_fingerprints()
    assert not golden_failures(golden_errors(fps)), (fps, GOLDEN, RTOL)


@pytest.mark.gpu
def test_c12_trajectory_matches_golden_on_gpu(gpu):
    fps = golden_fingerprints()
    errs = golden_errors(fps)
    assert not golden_failures(errs, signed_sums=False), (errs, RTOL)


if __name__ == "__main__":
    n = len(jax.devices("cpu"))
    assert n == 8, (
        f"regenerate under the suite env: saw {n} CPU devices, need "
        "XLA_FLAGS=--xla_force_host_platform_device_count=8")
    for k, v in golden_fingerprints().items():
        print(f'    "{k}": ({v[0]:.6e}, {v[1]:.6e}),')
