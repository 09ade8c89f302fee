"""Energy-envelope analysis (parity:
/root/reference/src/tcn/hws/analysis.py:20-72 - trapezoidal integration of
the power series; the reference author flagged their kWh conversion as
'TODO: Wrong?!', analysis.py:38-39 - fixed here: kWh = W x s / 3.6e6).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class EnergyReport:
    cpu_joules: float
    gpu_joules: float

    @property
    def cpu_kwh(self) -> float:
        return self.cpu_joules / 3.6e6

    @property
    def gpu_kwh(self) -> float:
        return self.gpu_joules / 3.6e6

    @property
    def total_kwh(self) -> float:
        return self.cpu_kwh + self.gpu_kwh


def load_data(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".json"):
        with open(path) as f:
            d = json.load(f)
        out = {k: np.asarray(v) for k, v in d["data"].items()}
        out["rate_s"] = np.asarray([d["rate_s"]])
        out["ticks"] = np.asarray(d["ticks"])
        return out
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def energy_envelope(data: Dict[str, np.ndarray],
                    start: int = 0, end: int | None = None) -> EnergyReport:
    rate = float(data["rate_s"][0])
    sl = slice(start, end)
    cpu = np.trapezoid(data["cpu_psu"][sl], dx=rate) if len(data["cpu_psu"][sl]) > 1 else 0.0
    gpu = np.trapezoid(data["gpu_psu"][sl], dx=rate) if len(data["gpu_psu"][sl]) > 1 else 0.0
    return EnergyReport(cpu_joules=float(cpu), gpu_joules=float(gpu))
