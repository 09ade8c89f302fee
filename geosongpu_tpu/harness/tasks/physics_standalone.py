"""Physics standalone validation tasks.

Parity with /root/reference/src/tcn/ci/pipeline/physics_standalone.py:13-146:
the reference builds each Fortran kernel twice (serial + OpenACC), runs 5
datasets through both, and gates |oacc - serial| <= 0.01% per variable.
Here the same dual-build contract over 5 synthetic datasets at the same
0.01% gate:

* build 1: the jnp source compiled for the host CPU device;
* build 2: compiled for the default device (the GPU where there is one).
  GFDLMicrophysics, FillQ2Zero, Buoyancy and EvapSublPdfLoop use fully
  independent second implementations (own gas constants and saturation
  functions, density-ratio buoyancy, PDF-integral clear fraction,
  unrolled recurrences - physics/twins.py), so their gates compare
  genuinely different SOURCES, matching the reference's
  serial-vs-OpenACC two-source contract; the remaining three compile the
  shared jnp body for the default device, the reference's CPU-vs-GPU
  dual build.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Tuple

import numpy as np

from ...physics import standalone as K
from ...physics import twins as T
from ..environment import Environment
from ..exceptions import CICheckException
from ..progress import Progress
from ..registry import Registry
from ..task import TaskBase

N_DATASETS = 5          # reference runs input indices 0..4 (:67-84)
REL_TOL = 1e-4          # 0.01% (:132-144)
SHAPE = (128, 40)       # columns x levels


def _datasets(seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    ncol, nz = SHAPE
    p = np.linspace(2000.0, 1.0e5, nz)[None, :] * np.ones((ncol, 1))
    t = 220.0 + 80.0 * (p / 1.0e5) ** 0.28 + rng.normal(0, 2, SHAPE)
    qv = np.clip(0.8 * 0.622 * 611.2 *
                 np.exp(17.67 * (t - 273.16) / (t - 30.06)) / p
                 + rng.normal(0, 1e-4, SHAPE), 1e-7, 0.03)
    return {
        "t": t.astype(np.float32),
        "qv": qv.astype(np.float32),
        "ql": np.clip(rng.normal(2e-4, 2e-4, SHAPE), 0, None).astype(np.float32),
        "qi": np.clip(rng.normal(5e-5, 5e-5, SHAPE), 0, None).astype(np.float32),
        "qr": np.clip(rng.normal(1e-4, 1e-4, SHAPE), 0, None).astype(np.float32),
        "q_neg": rng.normal(1e-4, 3e-4, SHAPE).astype(np.float32),
        "p": p.astype(np.float32),
        "delp": np.gradient(p, axis=1).astype(np.float32),
        "w": np.abs(rng.normal(0.5, 0.3, SHAPE)).astype(np.float32),
        "num_aer": np.abs(rng.normal(1e8, 3e7, SHAPE)).astype(np.float32),
    }


# kernel name -> callable(data) -> dict of output arrays
KERNELS: Dict[str, Callable] = {
    "FillQ2Zero": lambda d: {"q": K.fill_q2_zero(d["q_neg"], d["delp"])},
    "Buoyancy": lambda d: {"b": K.buoyancy(d["t"], d["qv"], d["p"],
                                           d["t"] + 0.5, d["qv"])},
    "EvapSublPdfLoop": lambda d: dict(zip(
        ("t", "qv", "ql", "qi"),
        K.evap_subl_pdf(d["t"], d["qv"], d["ql"], d["qi"], d["p"], 600.0))),
    "AerActivation": lambda d: {"nact": K.aer_activation(
        d["num_aer"], d["w"], d["t"], d["p"])},
    "GFDLMicrophysics": lambda d: K.gfdl_microphysics(
        d["t"], d["qv"], d["ql"], d["qr"], d["qi"], d["p"], d["delp"],
        600.0)._asdict(),
    "MoistRadCoup": lambda d: K.moist_rad_coup(d["ql"], d["qi"], d["p"],
                                               d["t"]),
    "CupGfSh": lambda d: dict(zip(("t", "qv"), K.cup_gf_sh(
        d["t"], d["qv"], d["p"], d["delp"], 600.0))),
}


def _run_kernel(name: str, data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Build 1: the jnp source compiled for the host CPU device."""
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        out = jax.jit(KERNELS[name])(data)
        return {k: np.asarray(v) for k, v in out.items()}


# kernel name -> independent second source (physics/twins.py)
TWINS: Dict[str, Callable] = {
    "FillQ2Zero": lambda d: {"q": T.fill_q2_zero_twin(d["q_neg"],
                                                      d["delp"])},
    "Buoyancy": lambda d: {"b": T.buoyancy_twin(d["t"], d["qv"], d["p"],
                                                d["t"] + 0.5, d["qv"])},
    "EvapSublPdfLoop": lambda d: dict(zip(
        ("t", "qv", "ql", "qi"),
        T.evap_subl_pdf_twin(d["t"], d["qv"], d["ql"], d["qi"], d["p"],
                             600.0))),
    "GFDLMicrophysics": lambda d: dict(zip(
        ("t", "qv", "ql", "qr", "qi", "precip"),
        T.gfdl_microphysics_twin(d["t"], d["qv"], d["ql"], d["qr"],
                                 d["qi"], d["p"], d["delp"], 600.0))),
}


def _run_kernel_device(name: str, data: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
    """Build 2: the kernel's independent twin where it has one, else the
    jnp source, compiled for the default device."""
    import jax

    out = jax.jit(TWINS.get(name, KERNELS[name]))(data)
    return {k: np.asarray(v) for k, v in out.items()}


class _PhysicsStandaloneBase(TaskBase):
    kernel: str = ""

    def run_action(self, config, env: Environment) -> None:
        ws = env.CI_WORKSPACE
        os.makedirs(ws, exist_ok=True)

        results = []
        for i in range(N_DATASETS):
            data = _datasets(seed=1000 + i)
            ref = _run_kernel(self.kernel, data)
            opt = _run_kernel_device(self.kernel, data)
            assert set(ref) == set(opt), (self.kernel, ref.keys(),
                                          opt.keys())
            results.append((ref, opt))
            np.savez_compressed(
                os.path.join(ws, f"{self.kernel}_ds{i}.npz"),
                **{f"ref_{k}": v for k, v in ref.items()},
                **{f"opt_{k}": v for k, v in opt.items()})
        env.set(f"physics.{self.kernel}.results", results)

    def check(self, config, env: Environment) -> bool:
        results: List[Tuple[dict, dict]] = env.get(
            f"physics.{self.kernel}.results")
        if not results:
            return False
        for i, (ref, opt) in enumerate(results):
            for var in ref:
                a, b = ref[var], opt[var]
                scale = np.sqrt(np.mean(a.astype(np.float64) ** 2)) or 1.0
                rel = np.sqrt(np.mean((b - a).astype(np.float64) ** 2)) / scale
                if not np.isfinite(rel) or rel > REL_TOL:
                    raise CICheckException(
                        f"{self.kernel} dataset {i} var {var}: "
                        f"rel RMS {rel:.3e} > {REL_TOL}")
        Progress.log(f"{self.kernel}: {len(results)} datasets within "
                     f"{REL_TOL:.0e}")
        return True


# one registered task per kernel (reference classes :149-339)
for _name in KERNELS:
    _cls = type(_name, (_PhysicsStandaloneBase,), {"kernel": _name})
    Registry.register(_cls)
    globals()[_name] = _cls
