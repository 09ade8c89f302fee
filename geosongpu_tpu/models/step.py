"""A model step jitted with its context arrays as arguments."""
from __future__ import annotations

from typing import Any, Callable, Dict

import jax
import numpy as np


class HoistedStep:
    """`step(state, ctx)` jitted as `step(state, arrays)`, called as
    `step_fn(state)`.

    `arrays` are the array leaves of the context pytree `ctx` (grid
    metrics, vertical coordinate, latitudes, ...); its other leaves
    (config, halo recipes) stay static.  Arrays closed over by a jitted
    function are baked into the HLO as constants, and XLA compiles those
    tens of MB of literals slowly: on one H100 (700 W) the c192-L72
    Held-Suarez step compiled in 341-528 s with its context as constants
    and in 127 s with it as arguments."""

    def __init__(self, step: Callable[[Any, Any], Any], ctx: Any):
        leaves, self._treedef = jax.tree_util.tree_flatten(ctx)
        self._hoisted = [isinstance(a, (jax.Array, np.ndarray))
                         and np.size(a) > 64 for a in leaves]
        self._static = [None if h else a
                        for a, h in zip(leaves, self._hoisted)]
        self.arrays = [a for a, h in zip(leaves, self._hoisted) if h]
        self._step = step
        self._jit = jax.jit(self.apply)
        self._runs: Dict[int, Callable] = {}

    def context(self, arrays):
        """The context pytree rebuilt around `arrays`."""
        it = iter(arrays)
        return jax.tree_util.tree_unflatten(
            self._treedef, [next(it) if h else a
                            for a, h in zip(self._static, self._hoisted)])

    def apply(self, state, arrays):
        """The un-jitted step on explicit context arrays."""
        return self._step(state, self.context(arrays))

    def __call__(self, state):
        return self._jit(state, self.arrays)

    def lower(self, state):
        return self._jit.lower(state, self.arrays)

    def run_fn(self, steps: int) -> Callable:
        """jit of `steps` steps as one lax.scan, taking (state, arrays);
        cached per count (a fresh trace per call would recompile)."""
        fn = self._runs.get(steps)
        if fn is None:
            def body(s, arrays):
                return jax.lax.scan(lambda c, _: (self.apply(c, arrays), None),
                                    s, None, length=steps)[0]

            fn = self._runs[steps] = jax.jit(body)
        return fn

    def run(self, state, steps: int):
        return self.run_fn(steps)(state, self.arrays)
