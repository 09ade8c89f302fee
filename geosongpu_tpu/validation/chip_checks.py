"""Checks of a run on the default device against the plain reference.

The `gpu`-marked tests and the phases of chip_smoke.py call these same
functions, so what the card is held to is written once:

* golden_fingerprints / golden_errors: the 24-step c12 Held-Suarez
  trajectory against its recorded f64 fingerprints
  (tests/test_regression_golden.py);
* step_vs_cpu: one model step on the default device against the same step
  compiled for the host CPU device in the same process;
* sharded_vs_single: a mesh layout's steps against the single-device
  steps of the same state;
* contraction_precisions: the precision of every dot_general in a
  function's jaxpr (float32 contractions must ask for HIGHEST, so that
  TF32 never enters on the GPU).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

# (sum, abs-sum) after 24 steps of c12-L16 HS, n_split=6, dt=1200,
# perturb=0.01 seed=42 - recorded on the CPU backend, jax 0.9.0, under the
# test suite's 8-virtual-device CPU env (see tests/test_regression_golden.py
# for the regeneration history and command)
GOLDEN = {
    "u": (4.961958e+02, 8.327311e+02),
    "v": (1.603233e+00, 7.226826e+02),
    "delp": (8.631406e+07, 8.631406e+07),
    "pt": (6.951876e+06, 6.951876e+06),
}
RTOL = 5e-4  # f32 run-to-run reassociation noise bound

# max|diff| / max|field| of one step, default device vs host CPU.  The
# GPU and CPU backends evaluate log and pow with different float32
# approximations (a few ulp apart), and the discrete Exner function
# pkz = dpk / (kappa dlog p) divides two differences of nearly equal
# numbers, so one ulp in log becomes ~1e-4 in pkz and a fixed ~2e-2 m/s
# in the winds after one step.  Measured: a 1-ulp change of log alone, on
# the CPU, moves one c24-L72 step from the JW06 state by 7e-4 (winds) and
# 7e-6 (delp); the H100 differs from the CPU by 5e-4 and 7e-6 at c48-L72
# (tests/test_device.py keeps the 1-ulp experiment).  The bounds are ~3x
# the 1-ulp effect.
STEP_TOLS = {"u": 2e-3, "v": 2e-3, "delp": 3e-5, "pt": 3e-5, "ps": 3e-5}

DIFF_FIELDS = ("u", "v", "delp", "pt", "ps")


def golden_fingerprints(steps: int = 24) -> Dict[str, Tuple[float, float]]:
    """(sum, abs-sum) of the golden fields after `steps` c12 steps on the
    default device."""
    from ..core.config import DycoreConfig
    from ..models.held_suarez import build_model

    cfg = DycoreConfig(npx=12, npz=16, dt=1200.0, n_split=6)
    m = build_model(cfg)
    s = m.init(perturb=0.01, seed=42)
    for _ in range(steps):
        s = m.step_fn(s)
    out = {}
    for name in GOLDEN:
        a = np.asarray(getattr(s, name), dtype=np.float64)
        out[name] = (float(a.sum()), float(np.abs(a).sum()))
    return out


def golden_errors(fps: Dict[str, Tuple[float, float]]
                  ) -> Dict[str, Tuple[float, float]]:
    """name -> (abs-sum relative error, sum error over its scale).  The
    gate is abs-sum < RTOL and sum < 10 RTOL (the signed sums cancel, so
    their scale is floored at 1e-3 of the abs-sum)."""
    errs = {}
    for name, (s_ref, a_ref) in GOLDEN.items():
        s_got, a_got = fps[name]
        scale = max(abs(s_ref), 1e-3 * a_ref)
        errs[name] = (abs(a_got - a_ref) / abs(a_ref),
                      abs(s_got - s_ref) / scale)
    return errs


def golden_failures(errs: Dict[str, Tuple[float, float]],
                    signed_sums: bool = True) -> List[str]:
    """Fields outside the gate.  signed_sums=False gates the abs-sums
    only: across backends (GPU vs the CPU that recorded GOLDEN) the signed
    wind sums, which cancel to 0.2% of their abs-sum, measure the
    conditioning of 24 chaotic steps, not correctness - on the CPU a
    1-ulp change of log alone moves v's signed sum by 1e-2."""
    return [f"{k}: abs-sum {a:.2e}, sum {s:.2e}" for k, (a, s) in errs.items()
            if not (a < RTOL and (s < 10 * RTOL or not signed_sums))]


def step_failures(diffs: Dict[str, Tuple[float, float]]) -> List[str]:
    return [f"{k}: {d[0]:.2e} > {STEP_TOLS[k]:.0e}" for k, d in diffs.items()
            if not d[0] < STEP_TOLS[k]]


def field_diffs(a, b, fields: Iterable[str] = DIFF_FIELDS
                ) -> Dict[str, Tuple[float, float]]:
    """name -> (max|a-b| / max|b|, relative RMS) over the named fields."""
    out = {}
    for f in fields:
        x = np.asarray(getattr(a, f), np.float64)
        y = np.asarray(getattr(b, f), np.float64)
        d = x - y
        out[f] = (float(np.abs(d).max() / max(np.abs(y).max(), 1e-30)),
                  float(np.sqrt(np.mean(d * d))
                        / max(np.sqrt(np.mean(y * y)), 1e-30)))
    return out


def jw_state(model):
    """The JW06 initial state (35 m/s jets, realistic pt/delp) on the
    model's grid and levels, built on the host in numpy: the same bits
    reach every device.  (The HS model's surface is flat, so the state is
    not in balance there; one step is still dominated by real signal.)  A
    resting start is no test of the winds: after one step they are
    ~1e-2 m/s of rounding-amplified response to the spin-up noise."""
    import jax

    from ..models.baroclinic_wave import jw_initial_state

    s, _ = jw_initial_state(model.config, model.grid,
                            np.asarray(model.ctx.ak), np.asarray(model.ctx.bk))
    return jax.tree.map(np.asarray, s)


def step_vs_cpu(cfg, steps: int = 1) -> Dict[str, Tuple[float, float]]:
    """field_diffs of `steps` Held-Suarez steps from jw_state on the
    default device against the same steps compiled for the host CPU
    device."""
    import jax

    from ..models.held_suarez import build_model

    def run():
        m = build_model(cfg)
        s = jw_state(m)
        for _ in range(steps):
            s = m.step_fn(s)
        return jax.tree.map(np.asarray, s)

    dev = run()
    with jax.default_device(jax.devices("cpu")[0]):
        ref = run()
    return field_diffs(dev, ref)


def sharded_vs_single(model, mesh_cfg, steps: int = 2
                      ) -> Tuple[str, Dict[str, Tuple[float, float]]]:
    """(layout description, field_diffs) of `steps` steps from jw_state
    through parallel.subtile.build_mesh_stepper against `steps`
    single-device steps of the same state on the first device.  The two
    trajectories run in two threads, so their compiles overlap.  (From
    rest the winds are rounding noise after a step: on four H100s the
    sharded and single-card winds then differ by 0.9 relative while
    delp agrees to 7e-6.)"""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from ..parallel.subtile import build_mesh_stepper

    state = jw_state(model)
    place, step, unplace, desc = build_mesh_stepper(model, mesh_cfg,
                                                    model.physics_fn)

    def single():
        s = state
        for _ in range(steps):
            s = model.step_fn(s)
        return jax.tree.map(np.asarray, s)

    def sharded():
        s = place(state)
        for _ in range(steps):
            s = step(s)
        return unplace(s)

    with ThreadPoolExecutor(max_workers=2) as pool:
        ref, out = pool.submit(single), pool.submit(sharded)
        ref, out = ref.result(), out.result()
    return desc, field_diffs(out, ref)


def contraction_precisions(fn, *args) -> List[Tuple[str, str]]:
    """(operand dtype, precision) of every dot_general in fn's jaxpr,
    nested jaxprs included."""
    import jax

    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append((str(eqn.invars[0].aval.dtype),
                              str(eqn.params.get("precision"))))
            for p in eqn.params.values():
                for j in (p if isinstance(p, (list, tuple)) else (p,)):
                    j = getattr(j, "jaxpr", j)  # ClosedJaxpr -> Jaxpr
                    if hasattr(j, "eqns"):
                        walk(j)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found
