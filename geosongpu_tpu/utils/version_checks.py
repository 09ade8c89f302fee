"""Component-version drift checks.

Parity with /root/reference/src/tcn/sw/geos_version_checks.py:10-58 (diffs
components.yaml tag/branch pins between two GEOS branches over HTTP).  This
stack's pins live in Python packages, so this compares the *runtime
stack fingerprint* (jax/jaxlib/CUDA plugin/numpy versions + device kinds)
against a recorded manifest and reports drift - same role: catch the
software stack changing under the CI.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple


def stack_fingerprint() -> Dict[str, str]:
    import importlib.metadata as md

    import jax
    import numpy

    out = {
        "jax": jax.__version__,
        "numpy": numpy.__version__,
        "python": __import__("sys").version.split()[0],
    }
    for pkg in ("jaxlib", "flax", "optax"):
        try:
            out[pkg] = md.version(pkg)
        except md.PackageNotFoundError:
            pass
    # JAX's CUDA plugin packages (jax-cuda12-plugin, jax-cuda12-pjrt, ...)
    for dist in md.distributions():
        name = dist.metadata["Name"] or ""
        if name.lower().startswith("jax-cuda"):
            out[name.lower()] = dist.version
    try:
        out["devices"] = ",".join(sorted({d.device_kind
                                          for d in jax.devices()}))
    except Exception:
        out["devices"] = "unavailable"
    return out


def save_manifest(path: str) -> Dict[str, str]:
    fp = stack_fingerprint()
    with open(path, "w") as f:
        json.dump(fp, f, indent=2, sort_keys=True)
    return fp


def compare_with_manifest(path: str) -> Tuple[bool, List[str]]:
    with open(path) as f:
        recorded = json.load(f)
    current = stack_fingerprint()
    diffs = []
    for k in sorted(set(recorded) | set(current)):
        a, b = recorded.get(k), current.get(k)
        if a != b:
            diffs.append(f"{k}: recorded={a} current={b}")
    return (not diffs, diffs)
