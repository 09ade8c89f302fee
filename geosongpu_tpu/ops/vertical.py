"""Vertical-column primitives.

Every vertical integral in the dycore (pressure integrals, geopotential,
omga) is a K-cumsum written as a triangular matmul:
out[..., l] = sum_{k<=l} x[..., k] = x @ triu(1).  The goldens pin this
form's rounding; whether jnp.cumsum or an associative scan is faster on
the GPU at equal accuracy is open (measure before changing it).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def cumsum_k(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive forward cumsum along the last axis via a matmul.

    precision=HIGHEST: a lower matmul precision (bf16 passes, or TF32 on
    the GPU's tensor cores) is fine for ML weights, NOT for pressure
    integrals (1e-3 relative error on pe would swamp the PGF)."""
    K = x.shape[-1]
    tri = jnp.triu(jnp.ones((K, K), x.dtype))
    return jax.lax.dot_general(
        x, tri, (((x.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)


def rcumsum_k(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive REVERSE cumsum (suffix sum) along the last axis."""
    K = x.shape[-1]
    tri = jnp.tril(jnp.ones((K, K), x.dtype))
    return jax.lax.dot_general(
        x, tri, (((x.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)


def interfaces_from_delp(delp: jnp.ndarray, ptop: float) -> jnp.ndarray:
    """Interface pressures pe [..., K+1] from layer thickness [..., K]."""
    return ptop + jnp.concatenate(
        [jnp.zeros_like(delp[..., :1]), cumsum_k(delp)], axis=-1)
