"""The lifted pose manifold M = (St(d, r) × R^r)^n, batched in JAX.

State layout: ``X`` of shape ``(n, r, d+1)`` where ``X[i, :, :d] = Y_i`` has
orthonormal *columns* (a point on the Stiefel manifold St(d, r)) and
``X[i, :, d] = p_i ∈ R^r`` is the lifted translation. This is the rank-r
relaxation of SE-Sync/DPGO: rank r defaults to 5 for d=3 (reference
``launch/PGOAgent.launch:12``; DPGO ``LiftedPose(r, d)`` per SURVEY.md §2.3).

All ops are batched over poses and differentiable; retractions use small
d×d eigendecompositions / QR of r×d blocks, or matmul-only Newton-Schulz.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from dpgo_ros_tpu.ops.batched import bmm, bmm_tn


def split(X: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(n, r, d+1) -> Y (n, r, d), p (n, r)."""
    d = X.shape[-1] - 1
    return X[..., :d], X[..., d]


def join(Y: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([Y, p[..., None]], axis=-1)


def sym(M: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def proj_tangent(X: jnp.ndarray, V: jnp.ndarray) -> jnp.ndarray:
    """Project ambient V onto the tangent space at X.

    Stiefel component (embedded metric): V_Y - Y sym(Y^T V_Y);
    Euclidean translation component unchanged.
    """
    d = X.shape[-1] - 1
    Y, _ = split(X)
    VY, Vp = split(V)
    YtV = bmm_tn(Y, VY)
    VY_t = VY - bmm(Y, sym(YtV))
    return join(VY_t, Vp)


def retract_polar(X: jnp.ndarray, V: jnp.ndarray) -> jnp.ndarray:
    """Polar retraction: Y+V_Y ↦ nearest Stiefel point; p moves Euclidean.

    polar(A) = A (A^T A)^{-1/2} computed via a batched d×d eigendecomposition
    (d is 2 or 3, so this is cheap and fully fused by XLA).
    """
    Y, p = split(X)
    VY, Vp = split(V)
    A = Y + VY
    M = jnp.einsum("nra,nrb->nab", A, A)  # (n, d, d) SPD
    w, Q = jnp.linalg.eigh(M)
    w = jnp.maximum(w, 1e-12)
    Minvsqrt = jnp.einsum(
        "nab,nb,ncb->nac", Q, jax.lax.rsqrt(w), Q
    )
    Ynew = jnp.einsum("nra,nab->nrb", A, Minvsqrt)
    return join(Ynew, p + Vp)


def retract_polar_ns(
    X: jnp.ndarray, V: jnp.ndarray, iters: int = 20
) -> jnp.ndarray:
    """Polar retraction via Newton–Schulz iteration — matmul-only, no
    eigendecomposition; the hot-path variant of :func:`retract_polar`.

    X_{k+1} = ½ X_k (3I − X_kᵀX_k) converges to polar(A) for σ(A) ∈ (0, √3).
    A = Y + V_Y is pre-scaled by trace normalization (σ_max ≤ 1), so the
    iteration is contractive for any tangent step. The default 20 iterations
    covers σ_min down to ~1e-3 (small singular values grow ×1.5/iteration
    before the quadratic phase); each iteration is two tiny
    contractions, still ≫ faster than a batched eigh. A trust-region step
    producing σ_min ≪ 1e-3 is a (numerically) rank-deficient pose block,
    where the polar factor is ill-defined for any method.
    """
    d = X.shape[-1] - 1
    Y, p = split(X)
    VY, Vp = split(V)
    A = Y + VY
    tr = jnp.sum(A * A, axis=(-2, -1))
    s = jax.lax.rsqrt(jnp.maximum(tr, 1e-12))[:, None, None]  # σ_max ≤ 1
    Z = A * s
    I3 = jnp.eye(d, dtype=X.dtype)

    def body(_, Zk):
        G = bmm_tn(Zk, Zk)
        return 0.5 * bmm(Zk, 3.0 * I3 - G)

    Z = jax.lax.fori_loop(0, iters, body, Z)
    return join(Z, p + Vp)


def retract_qr(X: jnp.ndarray, V: jnp.ndarray) -> jnp.ndarray:
    """QR retraction (sign-fixed thin QR of the r×d blocks)."""
    Y, p = split(X)
    VY, Vp = split(V)
    A = Y + VY
    Q, R = jnp.linalg.qr(A)
    s = jnp.sign(jnp.diagonal(R, axis1=-2, axis2=-1))
    s = jnp.where(s == 0, 1.0, s)
    return join(Q * s[..., None, :], p + Vp)


def random_stiefel(key, n: int, r: int, d: int, dtype=jnp.float64) -> jnp.ndarray:
    """Random point on St(d, r)^n (QR of Gaussian)."""
    A = jax.random.normal(key, (n, r, d), dtype)
    Q, R = jnp.linalg.qr(A)
    s = jnp.sign(jnp.diagonal(R, axis1=-2, axis2=-1))
    s = jnp.where(s == 0, 1.0, s)
    return Q * s[..., None, :]


def random_lifting_matrix(key, r: int, d: int, dtype=jnp.float64) -> jnp.ndarray:
    """Sample the shared r×d lifting matrix YLift ∈ St(d, r).

    The reference leader samples it once and broadcasts it to the team
    (``src/PGOAgentROS.cpp:402-410``, ``setLiftingMatrix``).
    """
    return random_stiefel(key, 1, r, d, dtype)[0]


def lift_trajectory(T: jnp.ndarray, Ylift: jnp.ndarray) -> jnp.ndarray:
    """Lift a (n, d, d+1) SE(d) trajectory to (n, r, d+1) via X_i = YLift T_i.

    Matches DPGO's lifting semantics (SURVEY.md §2.3 'Rank relaxation'):
    rotations map to YLift R_i ∈ St(d, r), translations to YLift t_i.
    """
    return jnp.einsum("rd,ndk->nrk", Ylift, T)


def tangent_norm(V: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.sum(V * V))


def inner(U: jnp.ndarray, V: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(U * V)


def check_on_manifold(X: jnp.ndarray, atol: float = 1e-6) -> jnp.ndarray:
    """Max deviation of Y_i^T Y_i from identity (diagnostic)."""
    Y, _ = split(X)
    d = Y.shape[-1]
    G = jnp.einsum("nra,nrb->nab", Y, Y)
    return jnp.max(jnp.abs(G - jnp.eye(d, dtype=X.dtype)))
