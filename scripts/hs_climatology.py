#!/usr/bin/env python
"""Held-Suarez climatology run: the canonical scientific validation.

Integrates the dycore + HS94 forcing long enough to spin up the general
circulation, then time-averages the zonal-mean zonal wind - the published
HS94 figure shows midlatitude westerly jets (~25-30 m/s near sigma~0.25)
with easterly tropics near the surface.  Reproducing that structure
end-to-end validates dynamics + physics + remap working together (the
reference's equivalent evidence is the full GEOS run on the cluster).

Usage:
  python scripts/hs_climatology.py [--npx 24] [--npz 20] [--days 200]
                                   [--spinup 50] [--cpu] [--out hs_clim.png]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--npx", type=int, default=24)
    p.add_argument("--npz", type=int, default=20)
    p.add_argument("--days", type=float, default=200.0)
    p.add_argument("--spinup", type=float, default=50.0)
    p.add_argument("--dt", type=float, default=900.0)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", default="hs_climatology.png")
    p.add_argument("--npz_out", default="hs_climatology.npz")
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from geosongpu_tpu.core.config import DycoreConfig
    from geosongpu_tpu.dycore.fv_dynamics import exner_mid
    from geosongpu_tpu.harness.checkpoint import enable_compilation_cache
    from geosongpu_tpu.models.held_suarez import build_model

    enable_compilation_cache()

    cfg = DycoreConfig(npx=args.npx, npz=args.npz, dt=args.dt, n_split=6)
    model = build_model(cfg)
    state = model.init(perturb=0.1)

    steps_per_day = int(86400.0 / args.dt)
    spin_steps = int(args.spinup * steps_per_day)
    avg_steps = int((args.days - args.spinup) * steps_per_day)
    print(f"c{args.npx}-L{args.npz}: spinup {spin_steps} steps + "
          f"average over {avg_steps}", flush=True)

    # spin-up as chunked scans (progress + bounded program size)
    chunk = 10 * steps_per_day
    t0 = time.time()
    done = 0
    while done < spin_steps:
        k = min(chunk, spin_steps - done)
        state = model.run(state, k)
        state.u.block_until_ready()
        done += k
        print(f"  spinup {done}/{spin_steps} ({time.time()-t0:.0f}s)",
              flush=True)

    # averaging phase: accumulate zonal-ish means of ua and T
    lat = np.asarray(model.lats.lat_c)  # [6, n, n]
    nbins = 32
    edges = np.linspace(-np.pi / 2, np.pi / 2, nbins + 1)
    bin_idx = np.digitize(lat.ravel(), edges) - 1
    bin_idx = np.clip(bin_idx, 0, nbins - 1)
    counts = np.bincount(bin_idx, minlength=nbins)

    usum = np.zeros((nbins, cfg.npz))
    tsum = np.zeros((nbins, cfg.npz))
    nsamp = 0
    sample_every = steps_per_day // 4 or 1
    while nsamp * sample_every < avg_steps:
        state = model.run(state, sample_every)
        ua = np.asarray(state.ua).reshape(-1, cfg.npz)
        tt = np.asarray(state.pt * exner_mid(state.delp, cfg.ptop)
                        ).reshape(-1, cfg.npz)
        for b in range(nbins):
            sel = bin_idx == b
            if sel.any():
                usum[b] += ua[sel].mean(0)
                tsum[b] += tt[sel].mean(0)
        nsamp += 1
        if nsamp % 40 == 0:
            print(f"  averaging sample {nsamp} ({time.time()-t0:.0f}s)",
                  flush=True)
    ubar = usum / max(nsamp, 1)
    tbar = tsum / max(nsamp, 1)

    np.savez_compressed(args.npz_out, ubar=ubar, tbar=tbar,
                        lat_edges=edges, nsamp=nsamp)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    latc = np.degrees(0.5 * (edges[:-1] + edges[1:]))
    sigma = (np.arange(cfg.npz) + 0.5) / cfg.npz
    fig, axes = plt.subplots(1, 2, figsize=(13, 5))
    cs = axes[0].contourf(latc, sigma, ubar.T, levels=15, cmap="RdBu_r")
    axes[0].invert_yaxis()
    axes[0].set_title("time/zonal-mean u [m/s]")
    axes[0].set_xlabel("latitude")
    axes[0].set_ylabel("sigma")
    fig.colorbar(cs, ax=axes[0])
    cs2 = axes[1].contourf(latc, sigma, tbar.T, levels=15, cmap="viridis")
    axes[1].invert_yaxis()
    axes[1].set_title("time/zonal-mean T [K]")
    axes[1].set_xlabel("latitude")
    fig.colorbar(cs2, ax=axes[1])
    fig.suptitle(f"Held-Suarez c{args.npx}-L{args.npz}, "
                 f"days {args.spinup}-{args.days}")
    fig.savefig(args.out, dpi=110, bbox_inches="tight")

    # the headline checks: midlatitude westerly jets aloft, tropical
    # surface easterlies
    mid = (np.abs(latc) > 25) & (np.abs(latc) < 65)
    jet = ubar[mid][:, :max(1, int(0.4 * cfg.npz))].max()
    trop = ubar[np.abs(latc) < 15][:, -3:].mean()
    print(f"jet max (midlat, upper): {jet:.1f} m/s "
          f"(HS94 ~ 25-30); tropical surface u: {trop:.1f} m/s (expect < 0)",
          flush=True)
    print(f"wrote {args.out} and {args.npz_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
