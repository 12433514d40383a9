"""Local Riemannian optimizers: preconditioned RGD and trust-region (RTR/tCG).

Capability parity with DPGO's ``ROptParameters{method∈{RTR,RGD}, RGD_stepsize,
RGD_use_preconditioner, RTR_iterations, RTR_tCG_iterations, gradnorm_tol}``
(reference ``src/PGOAgentROSNode.cpp:80-100``; per-update budget
``RTR_iterations=3, RTR_tCG_iterations=50, gradnorm_tol=0.5`` in
``launch/dpgo_demo.launch:33-35``). The reference delegates to ROPTLIB's
trust-region; here both solvers are pure JAX programs — every iteration is a
`lax.while_loop` step over edge-parallel operators, so an entire local solve
(the per-update hot loop, SURVEY.md §3 'hot loops ranked' #1) compiles to one
XLA executable with zero host synchronization.

Block-coordinate support: every tangent vector is multiplied by a per-pose
``mask`` (n, 1, 1). Because mask∘Hess∘mask is exactly the block Hessian, a
masked tCG performs the *local* (single-robot) trust-region solve of RBCD
while operating on the global state — one code path for single-robot full
solves, sequential RBCD, and parallel block updates.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from dpgo_ros_tpu.ops import quadratic, stiefel
from dpgo_ros_tpu.ops.quadratic import EdgeSet


@dataclasses.dataclass(frozen=True)
class RGDParams:
    """Riemannian gradient descent knobs (``RGD_stepsize``,
    ``RGD_use_preconditioner``, reference ``launch/PGOAgent.launch:17-18``)."""

    stepsize: float = 1e-3
    use_preconditioner: bool = True
    precond_damping: float = 1e-2


@dataclasses.dataclass(frozen=True)
class RTRParams:
    """Trust-region knobs (reference ``launch/PGOAgent.launch:19-21``)."""

    max_iterations: int = 3
    max_tcg_iterations: int = 50
    gradnorm_tol: float = 1e-2
    initial_radius: float = 1e1
    max_radius: float = 1e4
    use_preconditioner: bool = True
    precond_damping: float = 1e-2
    # tCG relative/superlinear residual targets (Steihaug–Toint defaults)
    tcg_kappa: float = 0.1
    tcg_theta: float = 1.0


class OptResult(NamedTuple):
    """Parity with DPGO's ``mLocalOptResult{success,fInit,fOpt,gradNormInit,
    gradNormOpt}`` telemetry (reference ``src/PGOAgentROS.cpp:166-172``)."""

    success: jnp.ndarray
    f_init: jnp.ndarray
    f_opt: jnp.ndarray
    gradnorm_init: jnp.ndarray
    gradnorm_opt: jnp.ndarray
    iterations: jnp.ndarray


def _masked_rgrad(X, e: EdgeSet, mask):
    return mask * quadratic.rgrad(X, e)


def _masked_precond(Pinv, X, V, mask):
    """Tangent-projected, masked application of the block-Jacobi inverse.

    ``Pinv`` is the precomputed inverse (``quadratic.precond_inverse``) —
    application is one batched matmul instead of a factorization per tCG
    iteration."""
    W = quadratic.precond_apply(Pinv, V)
    return mask * stiefel.proj_tangent(X, W)


def rgd_step(
    X: jnp.ndarray,
    e: EdgeSet,
    mask: jnp.ndarray,
    Pinv: jnp.ndarray | None,
    params: RGDParams,
) -> jnp.ndarray:
    """One preconditioned Riemannian gradient step on the masked block."""
    g = _masked_rgrad(X, e, mask)
    if params.use_preconditioner and Pinv is not None:
        d = _masked_precond(Pinv, X, g, mask)
    else:
        d = g
    return stiefel.retract_polar_ns(X, -params.stepsize * d)


class _TCGState(NamedTuple):
    eta: jnp.ndarray
    Heta: jnp.ndarray
    r: jnp.ndarray
    z: jnp.ndarray
    delta: jnp.ndarray
    r_z: jnp.ndarray
    k: jnp.ndarray
    done: jnp.ndarray


def _tcg(X, e, mask, G, Pinv, radius, params: RTRParams):
    """Steihaug–Toint truncated CG for the trust-region subproblem

      min_η  <g, η> + ½ <η, Hess[η]>   s.t.  ||η|| ≤ radius

    restricted to the masked block. Static trip bound ``max_tcg_iterations``
    with data-dependent early exit (negative curvature / boundary / residual
    tolerance) — all inside jit.
    """
    g = mask * stiefel.proj_tangent(X, G)
    r0 = g

    def prec(v):
        if params.use_preconditioner and Pinv is not None:
            return _masked_precond(Pinv, X, v, mask)
        return v

    z0 = prec(r0)
    r_z0 = stiefel.inner(r0, z0)
    eta0 = jnp.zeros_like(X)
    st = _TCGState(
        eta=eta0,
        Heta=jnp.zeros_like(X),
        r=r0,
        z=z0,
        delta=-z0,
        r_z=r_z0,
        k=jnp.array(0, jnp.int32),
        done=jnp.array(False),
    )
    r0_norm = jnp.sqrt(jnp.maximum(stiefel.inner(r0, r0), 1e-300))
    # Steihaug stopping: ||r|| ≤ ||r0|| min(kappa, ||r0||^theta)
    target = r0_norm * jnp.minimum(params.tcg_kappa, r0_norm**params.tcg_theta)

    def hess(v):
        return mask * quadratic.rhess_vp(X, v, e, G)

    def boundary_step(eta, delta, radius):
        """τ ≥ 0 with ||eta + τ delta|| = radius."""
        ee = stiefel.inner(eta, eta)
        ed = stiefel.inner(eta, delta)
        dd = jnp.maximum(stiefel.inner(delta, delta), 1e-300)
        disc = jnp.maximum(ed * ed + dd * (radius * radius - ee), 0.0)
        return (-ed + jnp.sqrt(disc)) / dd

    def cond(s):
        return (~s.done) & (s.k < params.max_tcg_iterations)

    def body(s):
        Hd = hess(s.delta)
        dHd = stiefel.inner(s.delta, Hd)
        alpha = s.r_z / jnp.where(dHd > 0, dHd, 1.0)
        eta_try = s.eta + alpha * s.delta
        eta_norm2 = stiefel.inner(eta_try, eta_try)
        neg_curv = dHd <= 0
        outside = eta_norm2 >= radius * radius
        hit_boundary = neg_curv | outside
        tau = boundary_step(s.eta, s.delta, radius)
        eta_new = jnp.where(
            hit_boundary, s.eta + tau * s.delta, eta_try
        )
        Heta_new = jnp.where(
            hit_boundary, s.Heta + tau * Hd, s.Heta + alpha * Hd
        )
        r_new = s.r + alpha * Hd
        r_norm = jnp.sqrt(jnp.maximum(stiefel.inner(r_new, r_new), 0.0))
        converged = r_norm <= target
        z_new = prec(r_new)
        r_z_new = stiefel.inner(r_new, z_new)
        beta = r_z_new / jnp.maximum(s.r_z, 1e-300)
        delta_new = -z_new + beta * s.delta
        done = hit_boundary | converged
        return _TCGState(
            eta=eta_new,
            Heta=Heta_new,
            r=jnp.where(done, s.r, r_new),
            z=jnp.where(done, s.z, z_new),
            delta=jnp.where(done, s.delta, delta_new),
            r_z=jnp.where(done, s.r_z, r_z_new),
            k=s.k + 1,
            done=done,
        )

    out = jax.lax.while_loop(cond, body, st)
    return out.eta, out.Heta, g


class _TRState(NamedTuple):
    X: jnp.ndarray
    G: jnp.ndarray  # Euclidean gradient at X (carried — one egrad/iteration)
    f: jnp.ndarray
    radius: jnp.ndarray
    k: jnp.ndarray
    gradnorm: jnp.ndarray
    done: jnp.ndarray


def rtr_solve(
    X: jnp.ndarray,
    e: EdgeSet,
    mask: jnp.ndarray,
    Pinv: jnp.ndarray | None,
    params: RTRParams,
) -> Tuple[jnp.ndarray, OptResult]:
    """Riemannian trust-region on the masked block.

    Standard RTR acceptance (ρ test with 0.1 threshold, radius ×¼ / ×2
    updates), iteration cap ``max_iterations`` matching the reference's
    per-update budget semantics.
    """
    f0 = quadratic.cost(X, e)
    G0 = quadratic.egrad(X, e)
    g0 = mask * stiefel.proj_tangent(X, G0)
    gn0 = stiefel.tangent_norm(g0)

    st = _TRState(
        X=X,
        G=G0,
        f=f0,
        radius=jnp.asarray(params.initial_radius, X.dtype),
        k=jnp.array(0, jnp.int32),
        gradnorm=gn0,
        done=gn0 <= params.gradnorm_tol,
    )

    def cond(s):
        return (~s.done) & (s.k < params.max_iterations)

    def body(s):
        eta, Heta, g = _tcg(s.X, e, mask, s.G, Pinv, s.radius, params)
        # model decrease: m(0) − m(η) = −<g,η> − ½<η,Hη>
        pred = -(stiefel.inner(g, eta) + 0.5 * stiefel.inner(eta, Heta))
        X_try = stiefel.retract_polar_ns(s.X, eta)
        f_try = quadratic.cost(X_try, e)
        ared = s.f - f_try
        rho = ared / jnp.where(jnp.abs(pred) > 1e-300, pred, 1e-300)
        accept = (rho > 0.1) & (pred > 0)
        eta_norm = stiefel.tangent_norm(eta)
        radius_new = jnp.where(
            rho < 0.25,
            0.25 * s.radius,
            jnp.where(
                (rho > 0.75) & (eta_norm >= 0.99 * s.radius),
                jnp.minimum(2.0 * s.radius, params.max_radius),
                s.radius,
            ),
        )
        X_new = jnp.where(accept, X_try, s.X)
        f_new = jnp.where(accept, f_try, s.f)
        G_new = jnp.where(accept, quadratic.egrad(X_try, e), s.G)
        gn = stiefel.tangent_norm(
            mask * stiefel.proj_tangent(X_new, G_new)
        )
        return _TRState(
            X=X_new,
            G=G_new,
            f=f_new,
            radius=radius_new,
            k=s.k + 1,
            gradnorm=gn,
            done=gn <= params.gradnorm_tol,
        )

    out = jax.lax.while_loop(cond, body, st)
    res = OptResult(
        success=jnp.asarray(True),
        f_init=f0,
        f_opt=out.f,
        gradnorm_init=gn0,
        gradnorm_opt=out.gradnorm,
        iterations=out.k,
    )
    return out.X, res


def rgd_solve(
    X: jnp.ndarray,
    e: EdgeSet,
    mask: jnp.ndarray,
    Pinv: jnp.ndarray | None,
    params: RGDParams,
    num_steps: int = 1,
) -> Tuple[jnp.ndarray, OptResult]:
    """num_steps preconditioned RGD steps (the ASAPP local loop,
    reference ``asynchronous_rate`` semantics)."""
    f0 = quadratic.cost(X, e)
    gn0 = stiefel.tangent_norm(_masked_rgrad(X, e, mask))

    def body(_, Xc):
        return rgd_step(Xc, e, mask, Pinv, params)

    Xn = jax.lax.fori_loop(0, num_steps, body, X)
    res = OptResult(
        success=jnp.asarray(True),
        f_init=f0,
        f_opt=quadratic.cost(Xn, e),
        gradnorm_init=gn0,
        gradnorm_opt=stiefel.tangent_norm(_masked_rgrad(Xn, e, mask)),
        iterations=jnp.asarray(num_steps, jnp.int32),
    )
    return Xn, res
