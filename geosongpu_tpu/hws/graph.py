"""Time-series plot of a sampler dump (parity:
/root/reference/src/tcn/hws/graph.py:11-71 - dual-axis PSU/utilization/mem
figure + maxima + energy report), matplotlib instead of plotly."""
from __future__ import annotations

import numpy as np

from . import constants as C
from .analysis import energy_envelope, load_data


def graph(path: str, out_png: str | None = None) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = load_data(path)
    n = len(data["cpu_psu"])
    t = np.arange(n) * float(data["rate_s"][0])

    fig, ax1 = plt.subplots(figsize=(10, 5))
    ax1.plot(t, data["cpu_psu"], label="CPU power [W]", color="tab:blue")
    ax1.plot(t, data["gpu_psu"], label="GPU power [W] (nvidia-smi)",
             color="tab:red")
    ax1.set_xlabel("time [s]")
    ax1.set_ylabel("power [W]")
    ax1.set_ylim(0, max(np.nanmax(data["gpu_psu"]), C.CPU_SPEC["tdp_w"])
                 * 1.1)

    ax2 = ax1.twinx()
    ax2.plot(t, data["cpu_exe_utl"], label="CPU util [%]",
             color="tab:green", alpha=0.6)
    ax2.plot(t, data["gpu_util"], label="GPU util [%] (nvidia-smi)",
             color="tab:purple")
    ax2.set_ylabel("utilization [%]")
    ax2.set_ylim(0, 105)

    for tick in data.get("ticks", []):
        ax1.axvline(tick * float(data["rate_s"][0]), color="gray",
                    linestyle=":", alpha=0.5)

    lines1, labels1 = ax1.get_legend_handles_labels()
    lines2, labels2 = ax2.get_legend_handles_labels()
    ax1.legend(lines1 + lines2, labels1 + labels2, loc="upper right")

    rep = energy_envelope(data)
    ax1.set_title(
        f"max CPU {np.max(data['cpu_psu']):.0f} W, "
        f"max GPU mem {np.nanmax(data['gpu_mem_mb']):.0f} MiB, "
        f"energy {rep.total_kwh*1e3:.2f} Wh")

    out = out_png or (path.rsplit(".", 1)[0] + ".png")
    fig.savefig(out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"max CPU power: {np.max(data['cpu_psu']):.1f} W")
    print(f"energy envelope: cpu {rep.cpu_kwh*1e3:.3f} Wh, "
          f"gpu {rep.gpu_kwh*1e3:.3f} Wh")
    return out
