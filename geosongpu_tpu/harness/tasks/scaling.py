"""Scaling-efficiency + comm-transport benchmark task.

The reference A/B-tests its MPI transport with OSU microbenchmarks and
archives the results (/root/reference/sw_stack/.../osu-bench.sh:15-86,
results/mpi_gpu_rdma/24W7.json).  Here:

* ppermute ring bandwidth + psum latency sweep (the OSU rows);
* a weak-scaling sweep of the Held-Suarez step over subtile ppermute
  meshes (parallel/subtile.py) at **fixed Courant number** - dt scales
  with 1/npx so per-point work and stability margin are identical across
  the sweep (round-2 verdict: letting dt/n_split stay fixed while npx grew
  conflated numerics with communication);
* per-entry **halo/compute overlap fraction**: t_comm (exchange rounds
  alone), t_compute (same step with collectives elided, comm=False
  filler), t_step (the real step), overlap = (t_comm + t_compute -
  t_step) / t_comm in [0, 1] - the BASELINE.md "overlap % reported per
  run" row.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from ...core.config import DycoreConfig
from ..environment import Environment
from ..progress import Progress
from ..registry import Registry
from ..task import TaskBase


def _near_square(m: int):
    ys = int(np.sqrt(m))
    while m % ys:
        ys -= 1
    return ys, m // ys


def _time_fn(fn, arg, repeats=3):
    import jax

    out = fn(arg)
    jax.tree.map(lambda x: x.block_until_ready(), out)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(arg)
    jax.tree.map(lambda x: x.block_until_ready(), out)
    return (time.perf_counter() - t0) / repeats


@Registry.register
class ScalingBench(TaskBase):
    def run_action(self, config, env: Environment) -> None:
        import jax

        from ...models.held_suarez import build_model
        from ...parallel.mesh import comm_microbench
        from ...parallel.subtile import (SubtileFiller, SubtileLayout,
                                         build_subtile_plan,
                                         build_subtile_step, subtile_mesh)
        from ...physics.held_suarez import held_suarez_forcing

        ws = env.CI_WORKSPACE
        os.makedirs(ws, exist_ok=True)
        devs = jax.devices()
        results = {"devices": str(devs), "n_devices": len(devs)}

        # ---- comm microbench (OSU analog) -------------------------------
        if len(devs) > 1:
            results["comm"] = comm_microbench(repeats=10)

        # ---- weak scaling over subtile ppermute meshes -------------------
        # per-device block ~B x B cells; dt ~ 1/npx holds the Courant
        # number (and so per-point work) fixed across the sweep
        B, npx0, dt0 = 12, 12, 600.0
        sizes = [n for n in (1, 2, 4, 8) if n <= len(devs)]
        scaling = []
        for nd in sizes:
            py, px = _near_square(nd)
            lcm = int(np.lcm(py, px))
            npx = int(round(B * np.sqrt(nd) / lcm)) * lcm  # divisibility
            cfg = DycoreConfig(npx=npx, npz=16, dt=dt0 * npx0 / npx,
                               n_split=3, overlap_fills=True)
            cfg_rs = dataclasses.replace(cfg, rim_split=True)
            model = build_model(cfg)
            model_rs = build_model(cfg_rs)
            st = model.init(perturb=1e-3)
            lay = SubtileLayout(n=npx, h=cfg.halo, py=py, px=px,
                                face_sharded=False)
            mesh = subtile_mesh(lay, devices=devs)

            def forcing(s, lats_l, _cfg=cfg):
                u, v, pt = held_suarez_forcing(
                    s.u, s.v, s.pt, s.delp, lats_l, _cfg.ptop, _cfg.dt)
                return dataclasses.replace(s, u=u, v=v, pt=pt)

            step, place, _ = build_subtile_step(
                model.ctx, lay, mesh=mesh, lats=model.lats, forcing=forcing)
            placed = place(st)
            t_step = _time_fn(step, placed)

            entry = {"n_devices": nd, "layout": [py, px], "npx": npx,
                     "dt": cfg.dt, "step_s": t_step,
                     "gridpoints_per_s": cfg.grid_points / t_step}
            if nd > 1:
                # compute-only: same program, collectives elided
                step_nc, place_nc, _ = build_subtile_step(
                    model.ctx, lay, mesh=mesh, lats=model.lats,
                    forcing=forcing, comm=False)
                t_compute = _time_fn(step_nc, place_nc(st))
                # interior/rim-split variant (SURVEY 7.3): the c_sw core
                # has no dataflow edge to the D-grid wind exchange, so
                # the scheduler can hide the ppermutes behind it
                step_rs, place_rs, _ = build_subtile_step(
                    model_rs.ctx, lay, mesh=mesh, lats=model_rs.lats,
                    forcing=forcing)
                t_step_rs = _time_fn(step_rs, place_rs(st))
                step_rs_nc, place_rs_nc, _ = build_subtile_step(
                    model_rs.ctx, lay, mesh=mesh, lats=model_rs.lats,
                    forcing=forcing, comm=False)
                t_compute_rs = _time_fn(step_rs_nc, place_rs_nc(st))
                # comm-only: the exchange rounds at one substep's volumes,
                # repeated n_split times (+1 for the remap/tracer fills)
                plan = build_subtile_plan(lay.n, lay.h, lay.py, lay.px,
                                          lay.face_sharded)
                from jax.sharding import PartitionSpec as P

                def comm_only(state_stacked):
                    import jax.numpy as jnp

                    def local(sl):
                        sq = jax.tree.map(lambda a: a[0], sl)
                        filler = SubtileFiller(plan)
                        acc = jnp.zeros((), jnp.float32)
                        for i in range(cfg.n_split + 1):
                            pu, pv = filler.fill_dgrid(sq.u + i, sq.v)
                            pd = filler.fill(sq.delp + i, "x")
                            pt_ = filler.fill(sq.pt + i, "x")
                            acc += (pu.sum() + pv.sum() + pd.sum()
                                    + pt_.sum())
                        return acc[None]

                    return jax.shard_map(
                        local, mesh=mesh, in_specs=(P("dev"),),
                        out_specs=P("dev"))(state_stacked)

                t_comm = _time_fn(jax.jit(comm_only), placed)
                overlap = (t_comm + t_compute - t_step) / max(t_comm, 1e-12)
                overlap_rs = (t_comm + t_compute_rs - t_step_rs) \
                    / max(t_comm, 1e-12)
                entry.update(
                    comm_s=t_comm, compute_s=t_compute,
                    overlap_frac=float(np.clip(overlap, 0.0, 1.0)),
                    step_rim_split_s=t_step_rs,
                    compute_rim_split_s=t_compute_rs,
                    overlap_frac_rim_split=float(
                        np.clip(overlap_rs, 0.0, 1.0)))
            scaling.append(entry)

        # weak-scaling efficiency: per-device throughput vs 1 device
        if scaling:
            base = scaling[0]["gridpoints_per_s"]
            for entry in scaling:
                entry["efficiency"] = (entry["gridpoints_per_s"] /
                                       (base * entry["n_devices"]))
        results["weak_scaling"] = scaling

        path = os.path.join(ws, "scaling_bench.json")
        with open(path, "w") as f:
            json.dump(results, f, indent=2)
        env.set("scaling.results", results)
        for entry in scaling:
            ov = entry.get("overlap_frac")
            Progress.log(
                f"{entry['n_devices']} dev {tuple(entry['layout'])}: "
                f"c{entry['npx']} {entry['step_s']*1e3:.1f} ms/step, "
                f"eff {entry['efficiency']*100:.0f}%"
                + (f", overlap {ov*100:.0f}%" if ov is not None else ""))

    def check(self, config, env: Environment) -> bool:
        results = env.get("scaling.results")
        if not results:
            return False
        os.makedirs(env.artifact_directory, exist_ok=True)
        src = os.path.join(env.CI_WORKSPACE, "scaling_bench.json")
        import shutil

        shutil.copy(src, os.path.join(env.artifact_directory,
                                      "scaling_bench.json"))
        sc = results.get("weak_scaling", [])
        ok = all(np.isfinite(e["step_s"]) and e["step_s"] > 0 for e in sc)
        # every multi-device entry must report its overlap fraction
        ok = ok and all("overlap_frac" in e for e in sc
                        if e["n_devices"] > 1)
        return ok
