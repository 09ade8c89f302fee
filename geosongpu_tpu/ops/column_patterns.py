"""Column-stencil idiom catalog: the dsl_patterns recipes, in jnp.

The reference maintains an executable Do/Dont/Cant catalog of GT4Py/NDSL
stencil idioms the physics needs (/root/reference/dsl_patterns/README.md:5-10)
- patterns that are awkward in that DSL are often trivial in JAX, and
vice versa.  This module is the living translation table, used by the
moist kernels and exercised by tests:

  Do__while_in_gt_functions.py:23-32   -> while_in_column
  Do__get_top_of_the_column.py:33-38   -> broadcast_top / broadcast_bottom
  WIP__hybrid_index_2dout.py:34-42     -> value_at_k (k-mask absolute
                                          indexing under a forward scan)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def while_in_column(q: jnp.ndarray, threshold: float,
                    max_iter: int = 50) -> jnp.ndarray:
    """Data-dependent per-column iteration (the reference's while-loop-in-
    stencil-function pattern): repeatedly diffuse each column until its
    max-min spread falls below `threshold`.  jax.lax.while_loop over the
    whole batch with a convergence mask - no Python control flow, fully
    vectorized across columns."""

    def spread(x):
        return jnp.max(x, axis=-1, keepdims=True) - jnp.min(
            x, axis=-1, keepdims=True)

    def cond(carry):
        x, it = carry
        return jnp.logical_and(it < max_iter,
                               jnp.any(spread(x) > threshold))

    def body(carry):
        x, it = carry
        xp = jnp.concatenate([x[..., :1], x, x[..., -1:]], axis=-1)
        sm = 0.25 * xp[..., :-2] + 0.5 * xp[..., 1:-1] + 0.25 * xp[..., 2:]
        # freeze converged columns (per-column masking)
        active = spread(x) > threshold
        return jnp.where(active, sm, x), it + 1

    out, _ = jax.lax.while_loop(cond, body, (q, 0))
    return out


def broadcast_top(q: jnp.ndarray) -> jnp.ndarray:
    """Column-top value broadcast to every level (the reference needs an
    interval(-1, None) + 2-D temporary dance; here it's a slice)."""
    return jnp.broadcast_to(q[..., :1], q.shape)


def broadcast_bottom(q: jnp.ndarray) -> jnp.ndarray:
    return jnp.broadcast_to(q[..., -1:], q.shape)


def value_at_k(q: jnp.ndarray, k_index: jnp.ndarray) -> jnp.ndarray:
    """Per-column value at a spatially-varying absolute level k_index
    [..., 1 or scalar-per-column] (the reference's k-mask trick under a
    FORWARD computation).  Mask+reduce instead of gather: one fused pass."""
    K = q.shape[-1]
    ks = jax.lax.broadcasted_iota(jnp.int32, q.shape, q.ndim - 1)
    mask = ks == k_index[..., None] if k_index.ndim == q.ndim - 1 \
        else ks == k_index
    return jnp.sum(jnp.where(mask, q, 0.0), axis=-1)


def first_k_above(q: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Lowest k (TOA->surface order) where q exceeds threshold; K if none.
    The searchsorted-free comparison-count idiom used by the remap."""
    K = q.shape[-1]
    hit = q > threshold
    # index of first True: argmax on int mask, guarded for all-False
    idx = jnp.argmax(hit.astype(jnp.int32), axis=-1)
    any_hit = jnp.any(hit, axis=-1)
    return jnp.where(any_hit, idx, K)
