"""Certifiably-correct centralized solve: the Riemannian staircase.

The reference's accuracy claims rest on the SE-Sync certifiable-correctness
line of work (reference ``README.md:79-112``), but the reference stack
never *checks* its answers. This module closes the loop: solve the rank-r
relaxation tight, run the dual certificate (:mod:`dpgo_ros_tpu.ops
.certificate`), and if S has negative curvature, ascend one rank along the
escape eigenvector and re-solve — terminating with a *certified global
optimum* of the SDP relaxation (and, when rank(X) = d, of the original
SE(d) synchronization problem).

Used by the golden-optima pipeline (``scripts/golden_solves.py``) to prove
the optima in ``golden_optima.json`` are the global optima of the generated
worlds.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dpgo_ros_tpu.models.local_solvers import RTRParams, rtr_solve
from dpgo_ros_tpu.ops import certificate, chordal, quadratic, rounding, stiefel
from dpgo_ros_tpu.ops.quadratic import EdgeSet


class CertifiedResult(NamedTuple):
    X: jnp.ndarray  # final lifted solution (n, r_final, d+1)
    T: np.ndarray  # rounded(+refined) SE(d) trajectory (n, d, d+1)
    cost: float  # f(X) — the certified SDP optimum when certified
    rounded_cost: float  # f of the raw rank-d rounding
    refined_cost: float  # f after rank-d local refinement of the rounding;
    # == cost (to solver tolerance) ⟺ the relaxation is tight and T is the
    # certified global SE(d) optimum (parking-garage: the SDP face contains
    # a rank-4 optimizer the staircase lands on, raw rounding gives 1.77,
    # refinement recovers the rank-3 optimizer at the SDP value 1.26256)
    certified: bool
    rank: int
    min_eig: float
    crit_residual: float
    ranks_tried: tuple
    # second-shift margin guard (ops/certificate.py, round 4)
    min_eig_check: Optional[float] = None
    margin_verified: bool = True


def _newton_polish(
    X,
    e,
    gradnorm_tol: float,
    max_newton: int = 25,
    verbose: bool = False,
):
    """Host sparse-KKT Riemannian Newton polish (round 5).

    The fp64 tight-solve tail dominated certified solves: parking-garage
    needs ~1,300 s of truncated-CG to reach gradnorm 1e-6 because its SDP
    optimal face makes the Hessian nearly singular (fp32 warm starts do
    not help — the cost IS the ill-conditioned final approach). But the
    Riemannian Hessian of the lifted PGO cost is exactly

        Hess f[V] = 2·Proj_X(S V),   S = Q − Λ̂,

    (compare ``quadratic.rhess_vp``: egrad(V) − V_Y·sym(Yᵀegrad(X)_Y) =
    2(QV − Λ̂V)), and round 5's :func:`certificate.s_sparse` materializes
    S as a host CSR matrix. A tangent-space Newton step is then one
    sparse KKT solve

        [S ⊗ I_r + τI,  Cᵀ] [v]   [−proj(Q X)]
        [C,             0 ] [λ] = [0],

    with C the per-pose Stiefel tangency constraints sym(Yᵢᵀ V_Yᵢ) = 0
    and τ a Levenberg damping doubled until the retracted step descends
    the gradient norm. scipy splu factors the ~40k-dim system in ~1 s —
    quadratic convergence replaces the 20-minute tCG tail.

    Returns (X, gradnorm) — callers fall back to :func:`_tight_rtr` if
    the target tolerance was not reached.
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as sla

    n, r, dp1 = X.shape
    d = dp1 - 1
    N = n * dp1
    m_per = d * (d + 1) // 2

    def rgrad_norm(Xc):
        g = quadratic.rgrad(Xc, e)
        return g, float(jnp.linalg.norm(g))

    X = jnp.asarray(X)
    g, gn = rgrad_norm(X)
    tau_carry = None  # successful damping carried across iterations
    for it in range(max_newton):
        if gn <= gradnorm_tol:
            break
        Lam = certificate.lambda_blocks(X, e)
        S = certificate.s_sparse(X, Lam, e)
        A = sp.kron(sp.identity(r, format="csr"), S, format="csr")
        # tangency constraints: for pose i, a <= b:
        #   sum_rho Y[i,rho,a] V[i,rho,b] + Y[i,rho,b] V[i,rho,a] = 0
        # column index of V[i,rho,c] in v = vec over (rho, i, c):
        #   rho*N + i*dp1 + c
        Xn = np.asarray(X, np.float64)
        rows, cols, vals = [], [], []
        ci = 0
        pair_list = [(a, b) for a in range(d) for b in range(a, d)]
        for a, b in pair_list:
            # vectorized over poses: constraint row ci + i
            for rho in range(r):
                base = rho * N + np.arange(n) * dp1
                rows.append(ci + np.arange(n))
                cols.append(base + b)
                vals.append(Xn[:, rho, a])
                if b != a:
                    rows.append(ci + np.arange(n))
                    cols.append(base + a)
                    vals.append(Xn[:, rho, b])
                else:
                    rows.append(ci + np.arange(n))
                    cols.append(base + a)
                    vals.append(Xn[:, rho, a])
            ci += n
        m = ci
        C = sp.coo_matrix(
            (
                np.concatenate(vals),
                (np.concatenate(rows), np.concatenate(cols)),
            ),
            shape=(m, r * N),
        ).tocsr()
        # rhs: -proj(Q X) rows, laid out as vec over (rho, i, c)
        gp = np.asarray(g, np.float64) / 2.0  # g = 2·proj(QX)
        rhs = np.concatenate(
            [
                np.transpose(gp, (1, 0, 2)).reshape(r, N).ravel() * -1.0,
                np.zeros(m),
            ]
        )
        scale = max(float(abs(S).max()), 1.0)
        # start from one notch below the last accepted damping — each
        # rejected try costs a full KKT factorization
        tau = (
            max(tau_carry / 100.0, 1e-10 * scale)
            if tau_carry is not None
            else 1e-10 * scale
        )
        accepted = False
        for _try in range(8):
            K = sp.bmat(
                [
                    [A + tau * sp.identity(r * N, format="csr"), C.T],
                    [C, None],
                ],
                format="csc",
            )
            try:
                sol = sla.splu(K).solve(rhs)
            except RuntimeError:
                tau = max(tau * 100.0, 1e-8 * scale)
                continue
            v = sol[: r * N].reshape(r, n, dp1).transpose(1, 0, 2)
            V = stiefel.proj_tangent(X, jnp.asarray(v, X.dtype))
            X_try = stiefel.retract_polar(X, V)
            g_try, gn_try = rgrad_norm(X_try)
            if np.isfinite(gn_try) and gn_try < gn:
                X, g, gn = X_try, g_try, gn_try
                accepted = True
                tau_carry = tau
                break
            tau = max(tau * 100.0, 1e-8 * scale)
        if verbose:
            print(
                f"[newton_polish] it={it} gn={gn:.3e} tau={tau:.1e} "
                f"accepted={accepted}",
                flush=True,
            )
        if not accepted:
            break
    return X, gn


def _tight_rtr(
    X, e, params: RTRParams, rounds: int, use_newton: bool = True,
    verbose: bool = False,
):
    """Reach the gradient tolerance: a loose RTR phase into the Newton
    basin, then the sparse-KKT Newton polish (:func:`_newton_polish` —
    quadratic convergence where the ill-conditioned tCG tail used to burn
    ~20 minutes on parking-garage), with full-budget RTR rounds as the
    safeguarded fallback."""
    mask = jnp.ones((X.shape[0], 1, 1), X.dtype)
    Pinv = quadratic.precond_inverse(
        quadratic.precond_blocks(e, X.shape[0], damping=1e-2)
    )
    res = None
    g0 = float(jnp.linalg.norm(quadratic.rgrad(X, e)))
    # RTR marches to the Newton basin (4 orders off the initial
    # gradient), then the sparse-KKT Newton finishes the quadratic tail.
    # Measured boundary (round 5, parking-garage): ENTERING EARLIER does
    # not help — on its flat SDP-face valley the damped Newton crawls at
    # the same rate as tCG (gn −1.3 %/iter at the stable damping), so the
    # march is left to RTR and Newton only replaces the tail.
    loose_tol = max(params.gradnorm_tol, 1e-4 * max(g0, 1.0))
    lp = dataclasses.replace(params, gradnorm_tol=loose_tol)
    for rd in range(rounds):
        X, res = rtr_solve(X, e, mask, Pinv, lp)
        if verbose:
            print(
                f"[tight_rtr] loose round {rd}: f={float(res.f_opt):.6f} "
                f"gn={float(res.gradnorm_opt):.3e}",
                flush=True,
            )
        if float(res.gradnorm_opt) <= loose_tol:
            break
    if use_newton and float(res.gradnorm_opt) > params.gradnorm_tol:
        X, gn = _newton_polish(
            X, e, params.gradnorm_tol, verbose=verbose
        )
        res = res._replace(
            gradnorm_opt=jnp.asarray(gn, X.dtype),
            f_opt=quadratic.cost(X, e),
        )
    if float(res.gradnorm_opt) > params.gradnorm_tol:
        for _ in range(rounds):
            X, res = rtr_solve(X, e, mask, Pinv, params)
            if float(res.gradnorm_opt) <= params.gradnorm_tol:
                break
    return X, res


def certified_solve(
    data,
    r0: Optional[int] = None,
    max_rank: Optional[int] = None,
    gradnorm_tol: float = 1e-6,
    eig_tol: float = 1e-5,
    crit_tol: float = 1e-4,
    rtr_iterations: int = 200,
    rtr_tcg_iterations: int = 400,
    rtr_rounds: int = 20,
    escape_step: float = 1e-2,
    dtype=jnp.float64,
    verbose: bool = False,
    lanczos_maxiter: Optional[int] = None,
    init: str = "chordal",
    init_seed: int = 0,
) -> CertifiedResult:
    """Centralized certified solve of a PoseGraphData problem.

    Init at rank ``r0`` (default d+2, the SE-Sync starting rung) →
    tight RTR → dual certificate → on failure, rank-ascend along the
    negative eigenvector with a backtracking step and re-solve.

    ``init="random"`` starts from a random point instead of chordal —
    with ``r0=d`` this reliably lands in suboptimal critical points and
    exercises the staircase's escape path (round 4).
    """
    from dpgo_ros_tpu.models.problem import LiftedProblem

    d = data.d
    r = r0 or d + 2
    max_rank = max_rank or d + 6
    prob = LiftedProblem.from_data(data, r=r, dtype=dtype)
    e = prob.edges
    params = RTRParams(
        max_iterations=rtr_iterations,
        max_tcg_iterations=rtr_tcg_iterations,
        gradnorm_tol=gradnorm_tol,
    )

    if init == "random":
        key = jax.random.PRNGKey(init_seed)
        Y0 = stiefel.random_stiefel(key, prob.n, r, d, dtype)
        p0 = 2.0 * jax.random.normal(
            jax.random.fold_in(key, 1), (prob.n, r, 1), dtype
        )
        X = jnp.concatenate([Y0, p0], axis=-1)
    elif init == "perturbed":
        # chordal init + a large tangent kick: lands in suboptimal basins
        # at r0=d (exercising the staircase escape on real datasets)
        # while staying well-conditioned enough for RTR to reach a
        # critical point — fully-random inits were observed to stall
        # short of criticality on smallGrid3D (round 4)
        key = jax.random.PRNGKey(init_seed)
        T0 = chordal.chordal_initialization(e, prob.n)
        T0 = rounding.anchor_to_first_pose(jnp.asarray(T0, dtype))
        Ylift = (
            jnp.eye(d, dtype=dtype)
            if r == d
            else stiefel.random_lifting_matrix(key, r, d, dtype)
        )
        X = stiefel.lift_trajectory(T0, Ylift)
        noise = jax.random.normal(
            jax.random.fold_in(key, 2), X.shape, dtype
        )
        X = stiefel.retract_polar(
            X, 3.0 * stiefel.proj_tangent(X, noise)
        )
    else:
        T0 = chordal.chordal_initialization(e, prob.n)
        T0 = rounding.anchor_to_first_pose(jnp.asarray(T0, dtype))
        if r == d:
            Ylift = jnp.eye(d, dtype=dtype)
        else:
            Ylift = stiefel.random_lifting_matrix(
                jax.random.PRNGKey(0), r, d, dtype
            )
        X = stiefel.lift_trajectory(T0, Ylift)

    ranks = []
    cert = None
    crit_retries = 0
    while True:
        if not ranks or ranks[-1] != X.shape[1]:
            ranks.append(X.shape[1])
        X, res = _tight_rtr(X, e, params, rtr_rounds, verbose=verbose)
        cert = certificate.certify(
            X, e, eig_tol=eig_tol, crit_tol=crit_tol,
            maxiter=lanczos_maxiter,
        )
        if verbose:
            print(
                f"[certified_solve] rank={X.shape[1]} "
                f"f={float(quadratic.cost(X, e)):.6f} "
                f"gradnorm={float(res.gradnorm_opt):.2e} "
                f"crit={cert.crit_residual:.2e} "
                f"min_eig={cert.min_eig:.3e} global={cert.is_global}",
                flush=True,
            )
        if cert.is_global or X.shape[1] >= max_rank:
            break
        if cert.eigvec is None:
            # not yet critical to crit_tol (adversarial inits can need
            # more than one tight-RTR budget at a rank) — keep solving at
            # the SAME rank; an escape needs the certificate eigenvector
            crit_retries += 1
            if crit_retries > 5:
                break  # give up: report the uncertified point honestly
            continue
        crit_retries = 0
        # staircase: ascend one rank along the negative eigenvector with a
        # backtracking step (guaranteed descent for small enough alpha)
        Xp, dirn = certificate.escape_direction(X, cert)
        f0 = float(quadratic.cost(Xp, e))
        scale = float(jnp.linalg.norm(X)) / max(
            1.0, float(jnp.linalg.norm(dirn))
        )
        alpha = escape_step * scale
        for _ in range(30):
            X_try = stiefel.retract_polar(Xp, alpha * dirn)
            if float(quadratic.cost(X_try, e)) < f0:
                break
            alpha *= 0.5
        X = X_try

    T = np.asarray(
        rounding.anchor_to_first_pose(rounding.round_solution(X))
    )
    # cost of the rank-d rounding: evaluate at r = d — the PGO cost is
    # gauge-invariant, so lift by I_d
    eye_d = jnp.eye(d, dtype=dtype)
    Xr = stiefel.lift_trajectory(jnp.asarray(T, dtype), eye_d)
    rounded_cost = float(quadratic.cost(Xr, e))
    # SE-Sync-style local refinement of the rounding at rank d: when the
    # SDP face contains optimizers of rank > d, the raw SVD rounding is a
    # nearby but suboptimal SE(d) point; a rank-d RTR from it recovers the
    # rank-d optimizer (refined == cost ⟹ tight ⟹ T is certified optimal)
    Xr, _res = _tight_rtr(Xr, e, params, rtr_rounds)
    refined_cost = float(quadratic.cost(Xr, e))
    if refined_cost < rounded_cost:
        T = np.asarray(
            rounding.anchor_to_first_pose(
                rounding.round_solution(Xr)
            )
        )
    return CertifiedResult(
        X=X,
        T=T,
        cost=float(quadratic.cost(X, e)),
        rounded_cost=rounded_cost,
        refined_cost=refined_cost,
        certified=bool(cert.is_global),
        rank=int(X.shape[1]),
        min_eig=float(cert.min_eig),
        crit_residual=float(cert.crit_residual),
        ranks_tried=tuple(ranks),
        min_eig_check=(
            None if cert.min_eig_check is None
            else float(cert.min_eig_check)
        ),
        margin_verified=bool(cert.margin_verified),
    )
