"""Model state checkpoint/resume.

The reference has none (SURVEY.md SS5: GEOS restarts belong to the model;
the DaCe compile cache is the only de-facto checkpoint).  Here: orbax-based
save/restore of the DycoreState pytree + config, plus the JAX persistent
compilation cache playing the reference's cache-build role.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from ..core.config import DycoreConfig
from ..core.state import DycoreState

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    The reference warms the DaCe cache with a 1-step 'cache build' run
    (held_suarez.py:297-308); JAX's persistent compilation cache plays the
    same role across processes.  The directory is $JAX_COMPILATION_CACHE_DIR
    when that is set, else a fixed `.jax_cache/` in the checkout (a fixed
    path: the path is part of the cache key)."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def save(directory: str, state: DycoreState, config: DycoreConfig,
         step: int = 0) -> str:
    """Save a checkpoint; returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}")
    try:
        import orbax.checkpoint as ocp

        ckptr = ocp.StandardCheckpointer()
        ckptr.save(os.path.abspath(path), state, force=True)
        ckptr.wait_until_finished()
    except Exception:
        # orbax unavailable/incompatible: portable npz fallback
        os.makedirs(path, exist_ok=True)
        import dataclasses

        arrays = {f.name: np.asarray(getattr(state, f.name))
                  for f in dataclasses.fields(state)}
        np.savez_compressed(os.path.join(path, "state.npz"), **arrays)
    with open(os.path.join(directory, f"meta_{step:08d}.json"), "w") as f:
        json.dump({"step": step, "config": config.__dict__}, f)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(name.split("_")[1].split(".")[0])
             for name in os.listdir(directory) if name.startswith("meta_")]
    return max(steps) if steps else None


def restore(directory: str, template: DycoreState,
            step: Optional[int] = None) -> Tuple[DycoreState, int]:
    """Restore the checkpoint at `step` (default: latest); `template`
    provides the pytree structure/shapes."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}")
    npz = os.path.join(path, "state.npz")
    if os.path.exists(npz):
        import dataclasses

        import jax.numpy as jnp

        with np.load(npz) as z:
            kwargs = {k: jnp.asarray(z[k]) for k in z.files}
        return DycoreState(**kwargs), step
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    state = ckptr.restore(os.path.abspath(path), template)
    return state, step
