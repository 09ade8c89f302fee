"""The one place that knows which accelerator the program runs on.

The dycore itself is plain jnp and compiles for whatever backend JAX
finds.  What depends on the machine is only its description (for every
printed result) and the refusal to measure anything without a GPU: a
timing taken on the host CPU is never reported as a device number.
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Dict


class NoGPUError(RuntimeError):
    """Raised where a measurement needs a GPU and JAX found none."""


def describe() -> Dict[str, object]:
    """{platform, kind, count} of the default devices, as JAX reports
    them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> Dict[str, object]:
    """describe(), or NoGPUError when the default device is not a GPU."""
    desc = describe()
    if desc["platform"] != "gpu":
        raise NoGPUError(
            f"no GPU found: JAX's default devices are {desc['platform']} "
            f"({desc['kind']}); device measurements need an NVIDIA GPU")
    return desc


def card_name_power() -> str:
    """The card's `name, power.limit` line(s) from nvidia-smi."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise NoGPUError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30)
    return out.stdout.strip()
