#!/usr/bin/env python
"""Run the BASELINE.md resolution ladder on the GPU and write one artifact
(results/bench_ladder_r{N}.json).

Ladder rungs (BASELINE.md "Config ladder" / primary-metric rows): c48-L72
and c192-L72 Held-Suarez, plain jnp/XLA path, grid-points/s per GPU.
Each rung is one `bench.py` child process, run one after another: never
run two at once (nor this script beside another JAX process on the same
card), since each JAX process reserves most of the card's memory and two
that compute at once spoil each other's times.  This parent process never
imports JAX.  Mirrors
the reference's benchmark matrix discipline (C180/C360 runs per backend,
/root/reference/src/tcn/ci/pipeline/held_suarez.py:314-377) with the
first (compile) step excluded, as the reference strips its JIT step
(report.py:131-150).

Usage: python scripts/bench_ladder.py [--out results/bench_ladder_r3.json]
       [--steps 10] [--rungs 48,192]
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_rung(npx: int, npz: int, steps: int) -> dict:
    env = dict(os.environ)
    env.update(BENCH_NPX=str(npx), BENCH_NPZ=str(npz),
               BENCH_STEPS=str(steps))
    res = subprocess.run([sys.executable, os.path.join(ROOT, "bench.py")],
                         env=env, capture_output=True, text=True,
                         timeout=2400)
    line = [l for l in res.stdout.splitlines() if l.startswith("{")]
    if res.returncode != 0 or not line:
        return {"config": f"c{npx}-L{npz}", "error": res.stderr[-800:]}
    d = json.loads(line[-1])
    gps = d["value"]
    return {"config": f"c{npx}-L{npz}",
            "gridpoints_per_s_per_gpu": gps,
            "ms_per_step": d["ms_per_step_median"],
            "ms_per_step_blocks": d.get("ms_per_step_blocks"),
            "device": d.get("device")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/bench_ladder_r3.json")
    ap.add_argument("--steps", type=int, default=20)  # == bench.py default
    # (bench.py and the ladder share steps/warmup/sync discipline so the
    # headline and ladder numbers for the same config agree; the
    # round-4 7% gap came from 20- vs 10-step blocks with no dispersion
    # bar on either)
    ap.add_argument("--npz", type=int, default=72)
    ap.add_argument("--rungs", default="48,192")
    args = ap.parse_args()

    entries = [run_rung(int(r), args.npz, args.steps)
               for r in args.rungs.split(",")]
    artifact = {
        "path": "plain jnp/XLA dycore",
        "entries": entries,
    }
    out = os.path.join(ROOT, args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact, indent=1))


if __name__ == "__main__":
    main()
