"""Global-optimality certificate + Riemannian staircase tests.

The certificate (ops/certificate.py) is the capability the reference cites
but never implements (reference ``README.md:79-112`` — SE-Sync-style
certifiable correctness): S = Q − Λ̂ must be PSD at a global optimum. These
tests pin the operator against a dense materialization, certify the known
tinyGrid3D optimum, and run the full staircase escape from a genuinely
suboptimal rank-d critical point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dpgo_ros_tpu.io.datasets import golden_optimum, load_dataset
from dpgo_ros_tpu.models.certified import _tight_rtr, certified_solve
from dpgo_ros_tpu.models.local_solvers import RTRParams
from dpgo_ros_tpu.ops import certificate, quadratic, stiefel

TINY_OPT = golden_optimum("synthetic_grid9")


def _tiny_problem(r):
    from dpgo_ros_tpu.models.problem import LiftedProblem

    data = load_dataset("synthetic_grid9", num_robots=1)
    return LiftedProblem.from_data(data, r=r)


def _dense_S(X, Lam, e):
    n, _, dp1 = X.shape
    N = n * dp1
    S = np.zeros((N, N))
    for i in range(N):
        v = np.zeros(N)
        v[i] = 1.0
        V = jnp.asarray(v).reshape(n, dp1)[:, None, :]
        S[:, i] = np.asarray(
            certificate.s_matvec(V, X, Lam, e)
        ).reshape(N)
    return S


@pytest.mark.slow
def test_certificate_operator_matches_dense():
    """S is symmetric, annihilates Xᵀ at criticality, and the shifted
    Lanczos min-eig agrees with a dense eigensolve."""
    prob = _tiny_problem(r=5)
    e = prob.edges
    res = certified_solve(prob.data, gradnorm_tol=1e-9)
    X = res.X
    Lam = certificate.lambda_blocks(X, e)
    S = _dense_S(X, Lam, e)
    assert np.abs(S - S.T).max() < 1e-10
    SX = certificate.s_matvec(X, X, Lam, e)
    assert float(jnp.linalg.norm(SX)) < 1e-8
    w = np.linalg.eigvalsh(S)
    vals, vecs = certificate.min_eig_lanczos(X, Lam, e)
    assert abs(vals[0] - w[0]) < 1e-6 * max(1.0, abs(w[-1]))
    # eigvec sanity: Rayleigh quotient reproduces the eigenvalue
    v = vecs[:, 0]
    assert abs(v @ (S @ v) - vals[0]) < 1e-6 * max(1.0, abs(w[-1]))


def test_certified_solve_tinygrid_is_global():
    res = certified_solve(
        load_dataset("synthetic_grid9", num_robots=1)
    )
    assert res.certified
    assert res.cost == pytest.approx(TINY_OPT, abs=1e-3)
    # tight relaxation: the rank-d rounding achieves the SDP optimum
    assert res.rounded_cost == pytest.approx(res.cost, rel=1e-6)
    assert res.refined_cost == pytest.approx(res.cost, rel=1e-6)
    assert res.min_eig > -1e-6 * res.cost


def test_certify_rejects_noncritical_point():
    prob = _tiny_problem(r=5)
    key = jax.random.PRNGKey(3)
    Y = stiefel.random_stiefel(key, prob.n, 5, 3)
    p = jax.random.normal(jax.random.PRNGKey(4), (prob.n, 5, 1))
    X = jnp.concatenate([Y, p], axis=-1)
    cert = certificate.certify(X, prob.edges)
    assert not cert.is_global
    assert cert.crit_residual > 1e-3
    assert cert.eigvec is None  # fails fast, no eigensolve


@pytest.mark.slow
def test_staircase_escapes_suboptimal_critical_point():
    """A rank-d (= 3) solve from an adversarial random init lands in a
    genuinely suboptimal critical point (f ≈ 355 vs optimum 18.5); the
    certificate must reject it with negative curvature and the staircase
    escape must reach the certified global optimum one rank up."""
    prob = _tiny_problem(r=3)
    e = prob.edges
    params = RTRParams(
        max_iterations=100, max_tcg_iterations=200, gradnorm_tol=1e-10
    )
    Y = stiefel.random_stiefel(jax.random.PRNGKey(9), prob.n, 3, 3)
    p = jax.random.normal(jax.random.PRNGKey(109), (prob.n, 3, 1)) * 2.0
    X, _ = _tight_rtr(jnp.concatenate([Y, p], axis=-1), e, params, 10)
    f_stuck = float(quadratic.cost(X, e))
    assert f_stuck > 10 * TINY_OPT  # genuinely suboptimal
    cert = certificate.certify(X, e)
    assert not cert.is_global
    assert cert.min_eig < -1.0  # strict negative curvature
    # second-order escape: the certificate eigenvector is a descent
    # direction at the lifted point
    Xp, dirn = certificate.escape_direction(X, cert)
    f0 = float(quadratic.cost(Xp, e))
    alpha = 1e-2 * float(jnp.linalg.norm(X)) / float(jnp.linalg.norm(dirn))
    for _ in range(30):
        X_try = stiefel.retract_polar(Xp, alpha * dirn)
        if float(quadratic.cost(X_try, e)) < f0:
            break
        alpha *= 0.5
    assert float(quadratic.cost(X_try, e)) < f0
    X2, _ = _tight_rtr(X_try, e, params, 10)
    cert2 = certificate.certify(X2, e)
    assert cert2.is_global
    assert float(quadratic.cost(X2, e)) == pytest.approx(
        TINY_OPT, abs=1e-3
    )


def test_margin_guard_second_shift_agreement():
    """Thin-margin certificates (within MARGIN_GUARD_BAND·scale of the
    accept threshold) trigger an independent second-shift Lanczos run
    whose verdict must agree (round 4: several golden certificates carry
    1e-9-scale min-eig margins where a Lanczos wobble could flip them)."""
    prob = _tiny_problem(r=5)
    e = prob.edges
    params = RTRParams(
        max_iterations=100, max_tcg_iterations=200, gradnorm_tol=1e-8
    )
    from dpgo_ros_tpu.ops import chordal, rounding

    T0 = rounding.anchor_to_first_pose(
        jnp.asarray(chordal.chordal_initialization(e, prob.n), jnp.float32)
    )
    Y = stiefel.random_lifting_matrix(jax.random.PRNGKey(0), 5, 3)
    X, _ = _tight_rtr(stiefel.lift_trajectory(T0, Y), e, params, 10)
    base = certificate.certify(X, e)
    assert base.is_global
    # wide margin: no second shift spent
    assert base.min_eig_check is None and base.margin_verified
    # force a thin margin: put the accept threshold right at -min_eig
    eig_tol_thin = max(-base.min_eig / base.scale, 0.0) + 1e-9
    thin = certificate.certify(X, e, eig_tol=eig_tol_thin)
    assert thin.min_eig_check is not None  # second shift ran
    assert thin.margin_verified  # both shifts agree on the verdict
    # the two independently-shifted eigensolves agree numerically
    assert abs(thin.min_eig_check - thin.min_eig) <= 1e-4 * max(
        1.0, abs(thin.min_eig)
    ) + 1e-5 * thin.scale


def test_sparse_S_matches_operator():
    """Round 5 (VERDICT r4 #9): the host-assembled sparse S (the fast
    certify path — one CSR build instead of one device matvec per Lanczos
    iteration) multiplies identically to the jitted s_matvec operator."""
    prob = _tiny_problem(r=5)
    e = prob.edges
    rng = np.random.default_rng(3)
    from dpgo_ros_tpu.parallel.rbcd import RBCDEngine
    from dpgo_ros_tpu.utils.config import AgentConfig

    eng = RBCDEngine(prob, AgentConfig(num_robots=1))
    X = eng.initialize().X
    Lam = certificate.lambda_blocks(X, e)
    S = certificate.s_sparse(X, Lam, e)
    n, _, dp1 = X.shape
    N = n * dp1
    assert abs(S - S.T).max() < 1e-9  # symmetric
    for _ in range(5):
        v = rng.normal(size=N)
        V = jnp.asarray(v).reshape(n, dp1)[:, None, :]
        ref = np.asarray(certificate.s_matvec(V, X, Lam, e)).reshape(N)
        np.testing.assert_allclose(S @ v, ref, rtol=1e-9, atol=1e-9)
    # both Lanczos paths agree on the min eigenvalue
    v1, _ = certificate.min_eig_lanczos(X, Lam, e, host_sparse=True)
    v2, _ = certificate.min_eig_lanczos(X, Lam, e, host_sparse=False)
    assert abs(float(v1[0]) - float(v2[0])) < 1e-5 * max(1.0, abs(float(v1[0])))
