"""Batched tiny-matrix contractions as broadcast-multiply-reduce.

Batched matmuls with tiny per-batch shapes (5×4 @ 4×4, batch ~thousands)
are expressed as a broadcast elementwise product + sum, which XLA fuses
with its neighbours into one elementwise kernel instead of emitting a
batched-matmul call per contraction. These helpers are used for every
per-pose/per-edge d- and r-sized contraction on the hot path. Whether this
beats a batched ``einsum`` on a given device is a measurement (ROADMAP.md).
"""

from __future__ import annotations

import jax.numpy as jnp


def bmm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(..., m, k) @ (..., k, n) -> (..., m, n)."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def bmm_nt(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(..., m, k) @ (..., n, k)^T -> (..., m, n)."""
    return jnp.sum(a[..., :, None, :] * b[..., None, :, :], axis=-1)


def bmm_tn(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(..., k, m)^T @ (..., k, n) -> (..., m, n)."""
    return jnp.sum(a[..., :, :, None] * b[..., :, None, :], axis=-3)


def bmv(a: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(..., m, k) @ (..., k) -> (..., m)."""
    return jnp.sum(a * v[..., None, :], axis=-1)


def outer(u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(..., m) ⊗ (..., n) -> (..., m, n)."""
    return u[..., :, None] * v[..., None, :]
