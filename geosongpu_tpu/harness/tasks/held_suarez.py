"""Held-Suarez pipeline task: the flagship workload.

Parity with /root/reference/src/tcn/ci/pipeline/held_suarez.py (the
reference clones+builds GEOS, swaps rc/nml configs per resolution, sruns
across nodes, then archives+mines logs; held_suarez.py:272-434).  Here the
model is in-repo and jitted, so the task reduces to: build -> init ->
warm-up (the reference's separate "cache build" run, held_suarez.py:297-308)
-> timed steps -> structured benchmark record + validation gates.

Action semantics (reference held_suarez.py:272-377):
  Validation / All : one gated run at the experiment config
  Benchmark        : the same gated run with a measured phase tree and
                     optional energy envelope, plus a round-over-round
                     comparison against the previous benchmark artifact.
"""
from __future__ import annotations

import glob
import json
import os
import time

import numpy as np

from ...benchmark.timing import BenchmarkRecord, StepTimer, compare, report
from ...core.config import DycoreConfig, ExperimentConfig
from ..environment import Environment
from ..exceptions import CICheckException
from ..progress import Progress
from ..registry import Registry
from ..task import PipelineAction, TaskBase


@Registry.register
class HeldSuarez(TaskBase):
    # ------------------------------------------------------------------
    def _timed_run(self, env: Environment, dyc: DycoreConfig,
                   backend_name: str, steps: int, warmup: int,
                   with_phases: bool = False, mesh=None):
        """One measured run -> (BenchmarkRecord, final state, model).

        mesh: optional MeshConfig.  n_devices > 1 shards the run over the
        subtile ppermute mesh - the layout is part of the experiment, as
        in the reference's per-resolution rank layouts
        (/root/reference/src/tcn/ci/pipeline/held_suarez.py:142-218)."""
        import jax

        from ...models.held_suarez import build_model
        from ...parallel.subtile import build_mesh_stepper

        model = build_model(dyc)
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

        # warm-up = the reference's cache-build run (JIT compile here)
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
            ws = env.CI_WORKSPACE
            dump = sampler.dump(ws)
            rec.extra["hws_dump"] = dump
            from ...hws.analysis import energy_envelope, load_data

            er = energy_envelope(load_data(dump))
            rec.energy = {"cpu_kwh": er.cpu_kwh, "gpu_kwh": er.gpu_kwh,
                          "total_kwh": er.total_kwh}

        if with_phases:
            if mesh_desc.startswith("single-device"):
                from ...benchmark.phases import measure_phases

                rec.phase_tree = measure_phases(model, state,
                                                inner=10).to_dict()
            else:
                # the phase tree instruments the single-device model fns;
                # under sharding the whole-step timing above is the truth
                rec.extra["phases_note"] = (
                    "sharded run: per-phase tree not instrumented, "
                    "whole-step times only")

        return rec, state, model

    # ------------------------------------------------------------------
    def run_action(self, config, env: Environment) -> None:
        import jax

        cfg: ExperimentConfig = env.config
        assert cfg is not None, "held_suarez experiment needs a config tree"
        ws = env.CI_WORKSPACE
        os.makedirs(ws, exist_ok=True)
        action = env.experiment_action
        hw = jax.default_backend()

        rec, state, model = self._timed_run(
            env, cfg.dycore, hw, cfg.run.steps, cfg.run.warmup_steps,
            with_phases=action == PipelineAction.Benchmark, mesh=cfg.mesh)
        rec.save(os.path.join(ws, f"benchmark_{env.experiment_name}.json"))
        env.set("hs.records", [rec])
        env.set("hs.record", rec)
        env.set("hs.final_state", state)
        env.set("hs.model", model)

        np.savez_compressed(
            os.path.join(ws, f"state_{env.experiment_name}.npz"),
            u=np.asarray(state.u), v=np.asarray(state.v),
            delp=np.asarray(state.delp), pt=np.asarray(state.pt),
            ps=np.asarray(state.ps))

    # ------------------------------------------------------------------
    def check(self, config, env: Environment) -> bool:
        state = env.get("hs.final_state")
        records = env.get("hs.records")
        model = env.get("hs.model")
        if state is None or not records:
            return False

        # validation gates (analog of the reference's log-grep + tolerance
        # checks, physics_standalone.py:128-144 / held_suarez.py:379-434)
        u = np.asarray(state.u)
        pt = np.asarray(state.pt)
        ps = np.asarray(state.ps)
        if not (np.isfinite(u).all() and np.isfinite(pt).all()):
            raise CICheckException("non-finite fields after run")
        if not (ps.min() > 5.0e4 and ps.max() < 1.2e5):
            raise CICheckException(f"unphysical ps range: {ps.min()}..{ps.max()}")
        w = np.asarray(model.grid.area)[model.grid.interior][..., None]
        mass = float((w * np.asarray(state.delp)).sum())
        mass0 = float(w.sum() * (1.0e5 - model.config.ptop))
        drift = abs(mass - mass0) / mass0
        if drift > 1e-3:
            raise CICheckException(f"mass drift {drift:.2e}")
        for rec in records:
            rec.extra["gates"] = {"finite": True,
                                  "ps_min": float(ps.min()),
                                  "ps_max": float(ps.max()),
                                  "mass_drift": drift}

        # round-over-round: pull the previous benchmark artifact (if any)
        # into the comparison, like the reference's cross-run reports
        all_records = list(records)
        prev_dir = env.artifact_directory
        for path in sorted(glob.glob(os.path.join(
                prev_dir, f"benchmark_{env.experiment_name}*.json"))):
            try:
                prev = BenchmarkRecord.load(path)
                prev.experiment += " (prev round)"
                all_records.append(prev)
            except Exception:
                pass

        # archive artifacts + report
        os.makedirs(env.artifact_directory, exist_ok=True)
        rep = report(all_records)
        out = os.path.join(env.artifact_directory, "report_benchmark.out")
        with open(out, "w") as f:
            f.write(rep + "\n")
        for rec in records:
            rec.save(os.path.join(
                env.artifact_directory,
                f"benchmark_{env.experiment_name}_{rec.backend}.json"))
        Progress.log(rep)
        return True
