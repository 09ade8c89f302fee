#!/usr/bin/env python
"""Prove the main path on one NVIDIA GPU, in one process.

    python chip_smoke.py            # phases 1-7 on one card
    python chip_smoke.py --four     # the 4-card layout check, nothing else

Phases (one summary line each; any failure exits non-zero):
  1. device: nvidia-smi's name and power limit, jax.devices(); not a GPU
     -> fail
  2. compile and memory of the c48-L72 and c192-L72 steps
  3. correctness against the plain reference: one c48-L72 step on the GPU
     vs the same step on the host CPU device, the c12 golden fingerprints
     on the GPU, and the precision of every contraction in the step
  4. pipeline: `cli ci held_suarez_c192 Validation` and
     `cli run held_suarez_c192 --steps 8`, called in process
  5. other paths: `cli ci aquaplanet_c48 Validation`,
     `cli ci physics_standalone_all`
  6. per-layer device times (benchmark/phases.measure_phases) at c48-L72
     and c192-L72
  7. device busy share of 3 c48-L72 steps from a jax.profiler trace
--four: held_suarez_c192_x4 through build_mesh_stepper on 4 cards, 2 steps,
  against the single-card steps of the same state on card 0.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
import argparse
import contextlib
import glob
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

class PhaseFailed(Exception):
    pass


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    try:
        yield
    except Exception as e:
        raise PhaseFailed(f"{name}: {type(e).__name__}: {e}") from e
    finally:
        print(f"[{name}] {time.perf_counter() - t0:.1f} s", flush=True)


def say(name, **kv):
    print(f"[{name}] " + json.dumps(kv, default=str), flush=True)


def aot_compile(lower):
    """(compiled, seconds) of lower().compile(); the executable also lands
    in the persistent compilation cache."""
    t0 = time.perf_counter()
    compiled = lower().compile()
    return compiled, time.perf_counter() - t0


def precompile(pool, c48, c192):
    """Start compiling, concurrently, every large program the phases run
    (an XLA compile keeps mostly one host thread busy).  The c48/c192
    steps are phase 2's; the rest reach the later phases through the
    persistent compilation cache."""
    from geosongpu_tpu.core.config import DycoreConfig
    from geosongpu_tpu.harness.task import get_config
    from geosongpu_tpu.models.aquaplanet import build_model as build_aq
    from geosongpu_tpu.models.held_suarez import build_model

    jobs, others = {}, []
    for label, cfg in (("c48-L72", c48), ("c192-L72", c192)):
        m = build_model(cfg)
        s = m.init(perturb=1e-3)
        jobs[label] = (m, s, pool.submit(aot_compile,
                                         lambda m=m, s=s: m.step_fn.lower(s)))
    m, s = jobs["c192-L72"][:2]
    others.append(pool.submit(  # `cli run held_suarez_c192 --steps 8`
        aot_compile, lambda: m.step_fn.run_fn(8).lower(s, m.step_fn.arrays)))
    aq = build_aq(DycoreConfig(**get_config("aquaplanet_c48")["experiment"]
                               ["dycore"]))
    aq_s = aq.init(perturb=1e-3)
    others.append(pool.submit(aot_compile, lambda: aq.step_fn.lower(aq_s)))
    c12 = build_model(DycoreConfig(npx=12, npz=16, dt=1200.0, n_split=6))
    c12_s = c12.init(perturb=0.01, seed=42)
    others.append(pool.submit(aot_compile,  # the golden's c12 step
                              lambda: c12.step_fn.lower(c12_s)))
    return jobs, others


def compile_and_memory(label, job):
    """Phase 2 for one configuration: compile seconds, memory analysis,
    peak bytes after a few steps."""
    import jax

    m, s, fut = job
    compiled, compile_s = fut.result()
    ma = compiled.memory_analysis()
    for _ in range(3):
        s = compiled(s, m.step_fn.arrays)
    jax.block_until_ready(s)
    say(f"2 compile {label}", compile_s=compile_s,
        note="compiled concurrently with the other phases' programs",
        argument_bytes=ma.argument_size_in_bytes,
        output_bytes=ma.output_size_in_bytes,
        temp_bytes=ma.temp_size_in_bytes,
        alias_bytes=ma.alias_size_in_bytes,
        peak_bytes_in_use_so_far=jax.devices()[0].memory_stats()
        ["peak_bytes_in_use"])


def check_correctness(c48):
    from geosongpu_tpu.validation import chip_checks as cc

    diffs = cc.step_vs_cpu(c48)
    say("3 gpu-vs-cpu c48-L72 step from JW06 (max|d|/max|f|, relRMS)",
        tol=cc.STEP_TOLS, **diffs)
    fails = cc.step_failures(diffs)
    if fails:
        raise AssertionError(f"GPU step differs from CPU: {fails}")
    errs = cc.golden_errors(cc.golden_fingerprints())
    say("3 c12 golden on GPU (abs-sum err, sum err)", rtol=cc.RTOL,
        gate="abs-sums within rtol", **errs)
    fails = cc.golden_failures(errs, signed_sums=False)
    if fails:
        raise AssertionError(f"golden drift: {fails}")
    from geosongpu_tpu.models.held_suarez import build_model

    m = build_model(c48)
    precs = cc.contraction_precisions(m.step_fn, m.init(perturb=1e-3))
    loose = [p for p in precs if p[0] == "float32" and "HIGHEST" not in p[1]]
    say("3 precision", dtype="float32", contractions=len(precs),
        not_highest=len(loose),
        note="every float32 contraction asks for HIGHEST: no TF32")
    if loose or not precs:
        raise AssertionError(f"contractions below HIGHEST: {loose}")


def run_cli(argv):
    from geosongpu_tpu import cli

    rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {' '.join(argv)} returned {rc}")


def ci_record(art, name):
    from geosongpu_tpu.benchmark.timing import BenchmarkRecord

    (path,) = glob.glob(os.path.join(art, f"benchmark_{name}_*.json"))
    rec = BenchmarkRecord.load(path)
    return {"ms_per_step_median": rec.median_step_s * 1e3,
            "compile_s": rec.compile_time_s,
            "gates": rec.extra.get("gates"), "mesh": rec.extra.get("mesh")}


def measure_phases_of(cfg, inner):
    from geosongpu_tpu.benchmark.phases import measure_phases
    from geosongpu_tpu.models.held_suarez import build_model

    m = build_model(cfg)
    s = m.step_fn(m.init(perturb=1e-3))
    return measure_phases(m, s, inner=inner).to_dict()


def busy_share(cfg, tdir, steps=3):
    import jax

    from geosongpu_tpu.hws.xprof_util import device_busy
    from geosongpu_tpu.models.held_suarez import build_model

    m = build_model(cfg)
    s = m.step_fn(m.init(perturb=1e-3))
    jax.block_until_ready(s)
    with jax.profiler.trace(tdir):
        for _ in range(steps):
            s = m.step_fn(s)
        jax.block_until_ready(s)
    say(f"7 device busy, {steps} c48-L72 steps", **device_busy(tdir))


def single_card(workdir, pool):
    from geosongpu_tpu.core.config import DycoreConfig
    from geosongpu_tpu.harness.task import get_config

    c48 = DycoreConfig(npx=48, npz=72, dt=600.0, n_split=6)
    c192 = DycoreConfig(**get_config("held_suarez_c192")["experiment"]
                        ["dycore"])
    art = os.path.join(workdir, "artifacts")
    ws = ["--workspace", os.path.join(workdir, "ws"), "--artifact", art]

    with phase("2 compile and memory"):
        jobs, others = precompile(pool, c48, c192)
        for label, job in jobs.items():
            compile_and_memory(label, job)
        say("2 other programs compiled", compile_s=[f.result()[1]
                                                    for f in others])
        del jobs, others
    with phase("3 correctness"):
        check_correctness(c48)
    with phase("4 pipeline"):
        run_cli(["ci", "held_suarez_c192", "Validation", *ws])
        say("4 ci held_suarez_c192 Validation",
            **ci_record(art, "held_suarez_c192"))
        run_cli(["run", "held_suarez_c192", "--steps", "8"])
    with phase("5 other paths"):
        run_cli(["ci", "aquaplanet_c48", "Validation", *ws])
        say("5 ci aquaplanet_c48 Validation",
            **ci_record(art, "aquaplanet_c48"))
        run_cli(["ci", "physics_standalone_all", *ws])
        say("5 ci physics_standalone_all", gate="7 kernels x 5 datasets "
            "within 1e-4 relative RMS, CPU build vs GPU build")
    with phase("6 per-layer"):
        # a first, untimed pass over both sizes at once overlaps the
        # compiles of the stage functions; the timed passes then load them
        # from the persistent cache and run alone on the card
        warm = [pool.submit(measure_phases_of, cfg, 1) for cfg in (c48, c192)]
        for fut in warm:
            fut.result()
        for label, cfg, inner in (("c48-L72", c48, 10),
                                  ("c192-L72", c192, 3)):
            tree = measure_phases_of(cfg, inner)
            say(f"6 phases {label} (ms per step)",
                full_step_ms=tree["full_step_ms"], **tree["phases_ms"])
    with phase("7 busy share"):
        busy_share(c48, os.path.join(workdir, "trace"))


def four_cards():
    from geosongpu_tpu.core.config import ExperimentConfig
    from geosongpu_tpu.harness.task import get_config
    from geosongpu_tpu.models.held_suarez import build_model
    from geosongpu_tpu.validation import chip_checks as cc

    exp = ExperimentConfig.from_dict(get_config("held_suarez_c192_x4")
                                     ["experiment"])
    with phase("8 four cards"):
        model = build_model(exp.dycore)
        desc, diffs = cc.sharded_vs_single(model, exp.mesh, steps=2)
        say("8 sharded vs single card, 2 c192-L72 steps from JW06 "
            "(max|d|/max|f|, relRMS)", layout=desc, tol=cc.STEP_TOLS,
            **diffs)
        fails = cc.step_failures(diffs)
        if fails:
            raise AssertionError(f"sharded differs from single card: "
                                 f"{fails}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card layout check")
    args = ap.parse_args(argv)

    try:
        from geosongpu_tpu.device import (NoGPUError, card_name_power,
                                           require_gpu)
    except ImportError as e:
        print(f"chip_smoke.py: run it from the repository root ({e})",
              file=sys.stderr)
        return 1
    try:
        desc = require_gpu()
        if args.four and desc["count"] < 4:
            raise NoGPUError(f"--four needs 4 GPUs, found {desc['count']}")
        card = card_name_power()
    except NoGPUError as e:
        print(f"chip_smoke.py: {e}", file=sys.stderr)
        return 2
    import jax

    say("1 device", card=card, devices=str(jax.devices()))
    try:
        from geosongpu_tpu.harness.checkpoint import enable_compilation_cache

        enable_compilation_cache()
        if args.four:
            four_cards()
        else:
            with tempfile.TemporaryDirectory() as workdir, \
                    ThreadPoolExecutor(max_workers=5) as pool:
                single_card(workdir, pool)
    except PhaseFailed as e:
        print(f"chip_smoke.py: FAILED {e}", file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": desc}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
