"""Aquaplanet pipeline task.

Parity with /root/reference/src/tcn/ci/pipeline/aquaplanet.py:31-235 (the
reference rewrites GEOS's gcm_run.j in place, submits via sbatch and polls;
its run_action branches on PipelineAction: validation = 1 ts cache + 12 h
run, benchmark = 1-day DSL vs 1-day Fortran, aquaplanet.py:99-178).  Here:

  Validation / All : one gated moist run at the experiment config
  Benchmark        : the same gated run with a measured phase tree (incl.
                     the moist physics leaf) and optional energy
                     envelope, plus round-over-round comparison.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import time

import numpy as np

from ...benchmark.timing import BenchmarkRecord, StepTimer, report
from ...core.config import DycoreConfig, ExperimentConfig
from ..environment import Environment
from ..exceptions import CICheckException
from ..progress import Progress
from ..registry import Registry
from ..task import PipelineAction, TaskBase


@Registry.register
class Aquaplanet(TaskBase):
    # ------------------------------------------------------------------
    def _timed_run(self, env: Environment, dyc: DycoreConfig,
                   backend_name: str, steps: int, warmup: int,
                   with_phases: bool = False, mesh=None):
        import jax

        from ...models.aquaplanet import build_model
        from ...parallel.subtile import build_mesh_stepper

        model = build_model(dyc)
        # sharded forcing = the full moist physics column on the local
        # block (surface fluxes + shallow conv + microphysics + HS
        # relaxation), with block-local latitudes/SST
        place, step_fn, unplace, mesh_desc = build_mesh_stepper(
            model, mesh, model.physics_fn)
        rec = BenchmarkRecord(
            experiment=env.experiment_name,
            backend=backend_name,
            grid={"npx": dyc.npx, "npz": dyc.npz},
        )
        rec.extra["mesh"] = mesh_desc

        sampler = None
        if env.get("HARDWARE_SAMPLING") in ("1", "true", "True"):
            from ...hws.server import Sampler

            sampler = Sampler(rate_s=0.1)

        t0 = time.perf_counter()
        state = place(model.init(perturb=1e-3))
        state.u.block_until_ready()
        rec.setup_time_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        for _ in range(max(1, warmup)):
            state = step_fn(state)
        state.u.block_until_ready()
        rec.compile_time_s = time.perf_counter() - t0

        timer = StepTimer()
        for _ in range(steps):
            timer.start()
            state = step_fn(state)
            state.u.block_until_ready()
            timer.stop()
            if sampler is not None:
                sampler.sample_once()
        rec.step_time_s = timer.times
        state = unplace(state)  # global state for gates/archives

        if sampler is not None:
            dump = sampler.dump(env.CI_WORKSPACE)
            rec.extra["hws_dump"] = dump
            from ...hws.analysis import energy_envelope, load_data

            er = energy_envelope(load_data(dump))
            rec.energy = {"cpu_kwh": er.cpu_kwh, "gpu_kwh": er.gpu_kwh,
                          "total_kwh": er.total_kwh}

        if with_phases and mesh_desc.startswith("single-device"):
            from ...benchmark.phases import measure_phases

            def forcing_fn(u, v, pt, delp):
                st = dataclasses.replace(state, u=u, v=v, pt=pt, delp=delp)
                out = model.physics_fn(st)
                return out.u, out.v, out.pt

            rec.phase_tree = measure_phases(
                model, state, inner=10, forcing_fn=forcing_fn).to_dict()
        elif with_phases:
            rec.extra["phases_note"] = (
                "sharded run: per-phase tree not instrumented, "
                "whole-step times only")

        return rec, state, model

    # ------------------------------------------------------------------
    def run_action(self, config, env: Environment) -> None:
        import jax

        cfg: ExperimentConfig = env.config
        assert cfg is not None, "aquaplanet experiment needs a config tree"
        ws = env.CI_WORKSPACE
        os.makedirs(ws, exist_ok=True)
        hw = jax.default_backend()

        rec, state, model = self._timed_run(
            env, cfg.dycore, hw, cfg.run.steps, cfg.run.warmup_steps,
            with_phases=env.experiment_action == PipelineAction.Benchmark,
            mesh=cfg.mesh)
        rec.save(os.path.join(ws, f"benchmark_{env.experiment_name}.json"))
        records = [rec]

        np.savez_compressed(
            os.path.join(ws, f"state_{env.experiment_name}.npz"),
            u=np.asarray(state.u), v=np.asarray(state.v),
            delp=np.asarray(state.delp), pt=np.asarray(state.pt),
            q=np.asarray(state.q), ps=np.asarray(state.ps))
        env.set("aq.records", records)
        env.set("aq.record", records[-1])
        env.set("aq.final_state", state)
        env.set("aq.model", model)

    # ------------------------------------------------------------------
    def check(self, config, env: Environment) -> bool:
        state = env.get("aq.final_state")
        records = env.get("aq.records")
        if state is None or not records:
            return False
        q = np.asarray(state.q)
        pt = np.asarray(state.pt)
        ps = np.asarray(state.ps)
        if not (np.isfinite(q).all() and np.isfinite(pt).all()):
            raise CICheckException("non-finite moist fields")
        if q[..., 0].min() < -1e-6:
            raise CICheckException(f"negative vapor: {q[..., 0].min()}")
        if q[..., 0].max() > 0.06:
            raise CICheckException(f"unphysical vapor: {q[..., 0].max()}")
        if not (ps.min() > 5.0e4 and ps.max() < 1.2e5):
            raise CICheckException(f"unphysical ps: {ps.min()}..{ps.max()}")
        for rec in records:
            rec.extra["gates"] = {"finite": True,
                                  "qv_min": float(q[..., 0].min()),
                                  "qv_max": float(q[..., 0].max()),
                                  "ps_min": float(ps.min()),
                                  "ps_max": float(ps.max())}

        # round-over-round comparison, like the HS task
        all_records = list(records)
        for path in sorted(glob.glob(os.path.join(
                env.artifact_directory,
                f"benchmark_{env.experiment_name}*.json"))):
            try:
                prev = BenchmarkRecord.load(path)
                prev.experiment += " (prev round)"
                all_records.append(prev)
            except Exception:
                pass

        os.makedirs(env.artifact_directory, exist_ok=True)
        rep = report(all_records)
        with open(os.path.join(env.artifact_directory,
                               "report_benchmark.out"), "w") as f:
            f.write(rep + "\n")
        for rec in records:
            rec.save(os.path.join(
                env.artifact_directory,
                f"benchmark_{env.experiment_name}_{rec.backend}.json"))
        Progress.log(rep)
        return True
