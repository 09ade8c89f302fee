#!/usr/bin/env python
"""Headline benchmark: grid-points/s per GPU on c48-L72 Held-Suarez.

Prints ONE JSON line with the rate, the step times and the device it ran
on (platform, device_kind, device count).  Exits non-zero, printing no
rate, when JAX finds no GPU: a CPU timing is never a device number.
"""
import json
import os
import sys
import time


def main() -> int:
    import jax

    from geosongpu_tpu.device import NoGPUError, require_gpu

    try:
        device = require_gpu()
    except NoGPUError as e:
        print(f"bench.py: {e}", file=sys.stderr)
        return 2

    from geosongpu_tpu.core.config import DycoreConfig
    from geosongpu_tpu.harness.checkpoint import enable_compilation_cache
    from geosongpu_tpu.models.held_suarez import build_model

    enable_compilation_cache()

    # L72 is the reference's standard level count (BASELINE.md ladder)
    npx = int(os.environ.get("BENCH_NPX", "48"))
    npz = int(os.environ.get("BENCH_NPZ", "72"))
    steps = int(os.environ.get("BENCH_STEPS", "20"))
    # hord_tm=6: unlimited PPM for delp/pt transport (FV3's production
    # hord_tm role); gated by the 6-day stability run + climatology smoke
    # (vorticity flux stays monotone: hord_mt=6 was measured nonlinearly
    # unstable, matching the enstrophy notes in dycore/sw.py)
    hord_tm = int(os.environ.get("BENCH_HORD_TM", "6"))
    cfg = DycoreConfig(npx=npx, npz=npz, dt=600.0, n_split=6,
                       hord_tm=hord_tm)
    model = build_model(cfg)
    state = model.init(perturb=1e-3)

    # warm-up (compile), excluded - mirrors the reference's cache-build run
    for _ in range(3):
        state = model.step_fn(state)
    jax.block_until_ready(state)

    # pipelined measurement: steps dispatch back-to-back with one sync per
    # block, matching how production runs execute (lax.scan loops).
    # BLOCKS repeats give a dispersion estimate (reference discipline:
    # median over steps, /root/reference/src/tcn/benchmark/report.py:152-164).
    blocks = int(os.environ.get("BENCH_BLOCKS", "5"))
    rates = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(steps):
            state = model.step_fn(state)
        jax.block_until_ready(state)
        rates.append((time.perf_counter() - t0) / steps)
    rates.sort()
    med = rates[len(rates) // 2]

    print(json.dumps({
        "metric": f"grid-points/s/gpu c{npx}-L{npz} Held-Suarez",
        "value": cfg.grid_points / med,
        "unit": "gridpoints/s",
        "ms_per_step_median": med * 1e3,
        "ms_per_step_blocks": [r * 1e3 for r in rates],
        "steps_per_block": steps,
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
