"""Batched SO(d)/SE(d) operations in JAX.

Device-side replacement for the Eigen/tf quaternion math used by the reference
serialization layer (``src/utils.cpp:63-106``). Everything is batched,
static-shape, and differentiable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def project_to_so(M: jnp.ndarray) -> jnp.ndarray:
    """Project (..., d, d) matrices onto SO(d) (nearest rotation, Frobenius).

    Uses the special orthogonal Procrustes solution
    R = U diag(1,...,1,det(U V^T)) V^T.
    """
    U, _, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(U @ Vt)
    d = M.shape[-1]
    S = jnp.concatenate(
        [jnp.ones(M.shape[:-2] + (d - 1,), M.dtype), det[..., None]], axis=-1
    )
    return (U * S[..., None, :]) @ Vt


def se_compose(Ta: jnp.ndarray, Tb: jnp.ndarray) -> jnp.ndarray:
    """Compose (..., d, d+1) rigid transforms: Ta ∘ Tb.

    (Ra, ta) ∘ (Rb, tb) = (Ra Rb, ta + Ra tb). Associative — usable with
    ``jax.lax.associative_scan`` for parallel-prefix odometry integration.
    """
    d = Ta.shape[-2]
    Ra, ta = Ta[..., :d], Ta[..., d]
    Rb, tb = Tb[..., :d], Tb[..., d]
    R = Ra @ Rb
    t = ta + jnp.einsum("...ij,...j->...i", Ra, tb)
    return jnp.concatenate([R, t[..., None]], axis=-1)


def se_inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Inverse of (..., d, d+1) rigid transforms: (R, t) -> (R^T, -R^T t)."""
    d = T.shape[-2]
    R, t = T[..., :d], T[..., d]
    Rt = jnp.swapaxes(R, -1, -2)
    ti = -jnp.einsum("...ij,...j->...i", Rt, t)
    return jnp.concatenate([Rt, ti[..., None]], axis=-1)


def se_identity(d: int, shape=(), dtype=jnp.float64) -> jnp.ndarray:
    T = jnp.concatenate([jnp.eye(d, dtype=dtype), jnp.zeros((d, 1), dtype)], axis=-1)
    return jnp.broadcast_to(T, shape + (d, d + 1))


def rotation_geodesic_distance(Ra: jnp.ndarray, Rb: jnp.ndarray) -> jnp.ndarray:
    """Angular distance (radians) between (..., d, d) rotations."""
    d = Ra.shape[-1]
    tr = jnp.einsum("...ij,...ij->...", Ra, Rb)
    if d == 3:
        c = (tr - 1.0) / 2.0
    else:
        c = tr / 2.0 - 0.0 if d != 2 else tr / 2.0
    return jnp.arccos(jnp.clip(c, -1.0, 1.0))


def odometry_chain(rel: jnp.ndarray, T0: jnp.ndarray | None = None) -> jnp.ndarray:
    """Integrate a chain of (n-1, d, d+1) relative transforms into (n, d, d+1)
    absolute poses via parallel prefix (``lax.associative_scan``).

    Parallel equivalent of the reference's sequential odometry
    initialization (DPGO ``localInitializationMethod=Odometry``,
    ``src/PGOAgentROSNode.cpp:104-117``) — O(log n) depth instead of O(n).
    """
    d = rel.shape[-2]
    if T0 is None:
        T0 = se_identity(d, dtype=rel.dtype)
    chain = jnp.concatenate([T0[None], rel], axis=0)
    return jax.lax.associative_scan(se_compose, chain)
