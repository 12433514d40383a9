"""Chordal initialization: rotation averaging + translation recovery.

Matrix-free replacement for DPGO's ``localInitializationMethod=Chordal``
(reference ``src/PGOAgentROSNode.cpp:104-117``; used by the demos,
``launch/dpgo_demo.launch:9``). Instead of a sparse direct solve, both stages
are matrix-free conjugate-gradient solves whose matvecs are the same
edge-parallel gather/scatter pipeline as the main objective — so the whole
initialization jit-compiles into a single XLA program with `lax.while_loop`.

Stage 1 (rotation chordal relaxation): minimize
    Σ_e κ_e ||R_j − R_i R_e||_F²  over unconstrained R_i ∈ R^{d×d}, R_0 = I
then project each solution block to SO(d).

Stage 2 (translation recovery): with rotations fixed, minimize
    Σ_e τ_e ||t_j − t_i − R_i t_e||²  over t_i ∈ R^d, t_0 = 0,
a graph-Laplacian linear least squares.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from dpgo_ros_tpu.ops.lie import project_to_so
from dpgo_ros_tpu.ops.quadratic import EdgeSet


def _rotation_operator(V: jnp.ndarray, e: EdgeSet) -> jnp.ndarray:
    """Half-gradient linear operator of the rotation chordal objective.

    L(V)_i += κ (V_i − V_j R_eᵀ) for edges with src i;
    L(V)_j += κ (V_j − V_i R_e) for edges with dst j.  V is (n, d, d).
    """
    kw, _ = e.effective_weights()
    Vi, Vj = V[e.src], V[e.dst]
    ci = kw[:, None, None] * (Vi - jnp.einsum("eab,ekb->eak", Vj, e.R))
    cj = kw[:, None, None] * (Vj - jnp.einsum("eab,ebk->eak", Vi, e.R))
    out = jnp.zeros_like(V)
    out = out.at[e.src].add(ci)
    out = out.at[e.dst].add(cj)
    return out


def _translation_operator(V: jnp.ndarray, e: EdgeSet) -> jnp.ndarray:
    """Weighted graph Laplacian: L(V)_i += τ (V_i − V_j); L(V)_j += τ (V_j − V_i).
    V is (n, d)."""
    _, tw = e.effective_weights()
    diff = V[e.src] - V[e.dst]
    out = jnp.zeros_like(V)
    out = out.at[e.src].add(tw[:, None] * diff)
    out = out.at[e.dst].add(-tw[:, None] * diff)
    return out


class _CGState(NamedTuple):
    x: jnp.ndarray
    r: jnp.ndarray
    p: jnp.ndarray
    rs: jnp.ndarray
    it: jnp.ndarray


def _cg(matvec, b, x0, max_iters: int, tol: float):
    """Plain CG with `lax.while_loop` (static trip bound, data-dependent
    early exit — no host syncs inside jit)."""
    r0 = b - matvec(x0)
    st = _CGState(x0, r0, r0, jnp.sum(r0 * r0), jnp.array(0, jnp.int32))
    b2 = jnp.maximum(jnp.sum(b * b), 1e-30)

    def cond(s):
        return (s.it < max_iters) & (s.rs > tol * tol * b2)

    def body(s):
        Ap = matvec(s.p)
        denom = jnp.sum(s.p * Ap)
        alpha = jnp.where(denom > 0, s.rs / jnp.maximum(denom, 1e-30), 0.0)
        x = s.x + alpha * s.p
        r = s.r - alpha * Ap
        rs_new = jnp.sum(r * r)
        beta = rs_new / jnp.maximum(s.rs, 1e-30)
        return _CGState(x, r, r + beta * s.p, rs_new, s.it + 1)

    return jax.lax.while_loop(cond, body, st).x


def _anchored_solve(operator, e: EdgeSet, target0, shape, dtype,
                    max_iters: int, tol: float):
    """Solve L x = 0 with x[anchor]=target0 pinned, via masked CG.

    Substitution: x = x_a + z with x_a the anchor-only vector and z supported
    off-anchor; solve  M L(z) = −M L(x_a)  with M zeroing the anchor row.
    """
    n = shape[0]
    mask = jnp.ones((n,) + (1,) * (len(shape) - 1), dtype).at[0].set(0.0)
    xa = jnp.zeros(shape, dtype).at[0].set(target0)

    def mv(z):
        return mask * operator(mask * z, e)

    b = -mask * operator(xa, e)
    z = _cg(mv, b, jnp.zeros(shape, dtype), max_iters, tol)
    return xa + mask * z


def chordal_rotations(
    e: EdgeSet, n: int, max_iters: int = 200, tol: float = 1e-8,
    dtype=None,
) -> jnp.ndarray:
    """Chordal rotation initialization → (n, d, d) in SO(d), pose 0 = I."""
    d = e.d
    dtype = dtype or e.R.dtype
    Z = _anchored_solve(
        _rotation_operator, e, jnp.eye(d, dtype=dtype), (n, d, d), dtype,
        max_iters, tol,
    )
    return project_to_so(Z)


def recover_translations(
    R: jnp.ndarray, e: EdgeSet, max_iters: int = 200, tol: float = 1e-8
) -> jnp.ndarray:
    """Translation recovery given rotations → (n, d), pose 0 = 0."""
    n, d = R.shape[0], R.shape[-1]
    dtype = R.dtype
    mask = jnp.ones((n, 1), dtype).at[0].set(0.0)
    _, tw = e.effective_weights()
    # Stationarity of Σ τ||t_j − t_i − R_i t_e||²: half-gradient splits into
    # the Laplacian part L(t) plus the data term g with
    # g_i = +Σ_{src=i} τ R_i t_e, g_j = −Σ_{dst=j} τ R_i t_e; solve L(t) = −g.
    Rt = jnp.einsum("eab,eb->ea", R[e.src], e.t)
    b = jnp.zeros((n, d), dtype)
    b = b.at[e.src].add(-tw[:, None] * Rt)
    b = b.at[e.dst].add(tw[:, None] * Rt)

    def mv(z):
        return mask * _translation_operator(mask * z, e)

    b = mask * b  # anchor value is 0 so no x_a correction term
    t = _cg(mv, b, jnp.zeros((n, d), dtype), max_iters, tol)
    return mask * t


def chordal_initialization(
    e: EdgeSet, n: int, max_iters: int = 200, tol: float = 1e-8
) -> jnp.ndarray:
    """Full chordal init → (n, d, d+1) trajectory with pose 0 at identity."""
    R = chordal_rotations(e, n, max_iters, tol)
    t = recover_translations(R, e, max_iters, tol)
    return jnp.concatenate([R, t[..., None]], axis=-1)
