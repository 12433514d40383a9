"""Numeric unit tests for the manifold math core (SURVEY.md §4: the test
layer the reference lacks — golden-value checks on manifold ops and the
quadratic operator)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dpgo_ros_tpu.io.datasets import load_dataset
from dpgo_ros_tpu.models.problem import LiftedProblem
from dpgo_ros_tpu.ops import chordal, lie, quadratic, rounding, stiefel


@pytest.fixture(scope="module")
def tiny():
    data = load_dataset("synthetic_grid9", num_robots=1)
    return LiftedProblem.from_data(data, r=5)


def _random_X(key, n, r, d):
    k1, k2 = jax.random.split(key)
    Y = stiefel.random_stiefel(k1, n, r, d)
    p = jax.random.normal(k2, (n, r))
    return stiefel.join(Y, p)


def test_stiefel_projection_and_retraction():
    key = jax.random.PRNGKey(0)
    n, r, d = 7, 5, 3
    X = _random_X(key, n, r, d)
    assert stiefel.check_on_manifold(X) < 1e-9
    V = jax.random.normal(jax.random.PRNGKey(1), X.shape)
    Vt = stiefel.proj_tangent(X, V)
    # tangency: Y^T V_Y skew-symmetric
    Y, _ = stiefel.split(X)
    VY, _ = stiefel.split(Vt)
    S = jnp.einsum("nra,nrb->nab", Y, VY)
    assert jnp.max(jnp.abs(S + jnp.swapaxes(S, -1, -2))) < 1e-9
    # projection is idempotent
    assert jnp.max(jnp.abs(stiefel.proj_tangent(X, Vt) - Vt)) < 1e-9
    # retractions stay on manifold and agree to first order
    for retr in (stiefel.retract_polar, stiefel.retract_qr):
        X2 = retr(X, 1e-4 * Vt)
        assert stiefel.check_on_manifold(X2) < 1e-6
        assert jnp.max(jnp.abs(X2 - (X + 1e-4 * Vt))) < 1e-6


def test_egrad_matches_autodiff(tiny):
    """The hand-derived edge-parallel gradient must equal JAX autodiff."""
    X = _random_X(jax.random.PRNGKey(2), tiny.n, tiny.r, tiny.d)
    g_manual = quadratic.egrad(X, tiny.edges)
    g_auto = jax.grad(lambda Z: quadratic.cost(Z, tiny.edges))(X)
    assert jnp.max(jnp.abs(g_manual - g_auto)) < 1e-8


def test_cost_is_quadratic_form(tiny):
    X = _random_X(jax.random.PRNGKey(3), tiny.n, tiny.r, tiny.d)
    f = quadratic.cost(X, tiny.edges)
    q = jnp.sum(X * quadratic.apply_Q(X, tiny.edges))
    assert jnp.abs(f - q) < 1e-8 * (1 + jnp.abs(f))


def test_hessian_linearity(tiny):
    """ehess[V] == egrad(V) (operator linearity) vs jvp of grad."""
    X = _random_X(jax.random.PRNGKey(4), tiny.n, tiny.r, tiny.d)
    V = jax.random.normal(jax.random.PRNGKey(5), X.shape)
    hv_lin = quadratic.egrad(V, tiny.edges)
    _, hv_jvp = jax.jvp(
        lambda Z: quadratic.egrad(Z, tiny.edges), (X,), (V,)
    )
    assert jnp.max(jnp.abs(hv_lin - hv_jvp)) < 1e-8


def test_rhess_symmetry(tiny):
    """The Riemannian Hessian is self-adjoint on the tangent space."""
    X = _random_X(jax.random.PRNGKey(6), tiny.n, tiny.r, tiny.d)
    U = stiefel.proj_tangent(
        X, jax.random.normal(jax.random.PRNGKey(7), X.shape)
    )
    W = stiefel.proj_tangent(
        X, jax.random.normal(jax.random.PRNGKey(8), X.shape)
    )
    G = quadratic.egrad(X, tiny.edges)
    hU = quadratic.rhess_vp(X, U, tiny.edges, G)
    hW = quadratic.rhess_vp(X, W, tiny.edges, G)
    a = stiefel.inner(W, hU)
    b = stiefel.inner(U, hW)
    assert jnp.abs(a - b) < 1e-7 * (1 + jnp.abs(a))


def test_zero_cost_at_exact_solution():
    """Build a synthetic noise-free graph; lifted ground truth has cost ~0
    and zero Riemannian gradient."""
    rng = np.random.default_rng(0)
    n, d, r = 6, 3, 5
    R = np.stack([_rand_rot(rng) for _ in range(n)])
    t = rng.normal(size=(n, d))
    edges = []
    for i in range(n - 1):
        edges.append((i, i + 1))
    edges.append((0, n - 1))
    src = np.array([e[0] for e in edges], np.int32)
    dst = np.array([e[1] for e in edges], np.int32)
    Rrel = np.einsum("eji,ejk->eik", R[src], R[dst])  # R_i^T R_j
    trel = np.einsum("eji,ej->ei", R[src], t[dst] - t[src])
    E = len(edges)
    es = quadratic.EdgeSet(
        src=jnp.asarray(src),
        dst=jnp.asarray(dst),
        R=jnp.asarray(Rrel),
        t=jnp.asarray(trel),
        kappa=jnp.full((E,), 10.0),
        tau=jnp.full((E,), 100.0),
        weight=jnp.ones((E,)),
        mask=jnp.ones((E,)),
        is_loop=jnp.zeros((E,)),
    )
    Ylift = stiefel.random_lifting_matrix(jax.random.PRNGKey(0), r, d)
    T = jnp.asarray(np.concatenate([R, t[..., None]], axis=-1))
    X = stiefel.lift_trajectory(T, Ylift)
    assert stiefel.check_on_manifold(X) < 1e-9
    assert quadratic.cost(X, es) < 1e-16
    g = quadratic.rgrad(X, es)
    assert jnp.max(jnp.abs(g)) < 1e-8


def _rand_rot(rng):
    A = rng.normal(size=(3, 3))
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q


def test_padding_edges_are_inert(tiny):
    """Padded EdgeSet must produce identical cost/grad."""
    data = load_dataset("synthetic_grid9", num_robots=1)
    padded = LiftedProblem.from_data(data, r=5, pad_edges_to=32)
    X = _random_X(jax.random.PRNGKey(9), tiny.n, tiny.r, tiny.d)
    assert jnp.abs(
        quadratic.cost(X, tiny.edges) - quadratic.cost(X, padded.edges)
    ) < 1e-9
    assert jnp.max(
        jnp.abs(quadratic.egrad(X, tiny.edges) - quadratic.egrad(X, padded.edges))
    ) < 1e-9


def test_precond_blocks_match_operator_diagonal(tiny):
    """Diagonal blocks must agree with Q applied to single-pose indicators."""
    e = tiny.edges
    n, d = tiny.n, tiny.d
    P = quadratic.precond_blocks(e, n, damping=0.0)
    # probe pose 2: Q restricted to pose i acting on row basis vectors
    i = 2
    for col in range(d + 1):
        V = jnp.zeros((n, 1, d + 1)).at[i, 0, col].set(1.0)
        QV = quadratic.apply_Q(jnp.broadcast_to(V, (n, 1, d + 1)), e)
        assert jnp.max(jnp.abs(QV[i, 0] - P[i, col])) < 1e-8


def test_pull_path_matches_scatter(tiny):
    """The gather-sum ('pull') accumulation must equal scatter-add exactly,
    including under edge padding."""
    import dataclasses

    from dpgo_ros_tpu.io.datasets import load_dataset
    from dpgo_ros_tpu.models.problem import LiftedProblem

    for pad in (None, 40):
        data = load_dataset("synthetic_grid9", num_robots=2)
        prob = LiftedProblem.from_data(data, r=5, pad_edges_to=pad)
        assert prob.edges.pull is not None
        e_pull = prob.edges
        e_scat = dataclasses.replace(prob.edges, pull=None)
        X = _random_X(jax.random.PRNGKey(12), prob.n, prob.r, prob.d)
        g1 = quadratic.egrad(X, e_pull)
        g2 = quadratic.egrad(X, e_scat)
        assert jnp.max(jnp.abs(g1 - g2)) < 1e-10
        P1 = quadratic.precond_blocks(e_pull, prob.n)
        P2 = quadratic.precond_blocks(e_scat, prob.n)
        assert jnp.max(jnp.abs(P1 - P2)) < 1e-10


def test_precond_solve_roundtrip(tiny):
    P = quadratic.precond_blocks(tiny.edges, tiny.n)
    V = jax.random.normal(jax.random.PRNGKey(10), (tiny.n, tiny.r, tiny.d + 1))
    W = quadratic.precond_solve(P, V)
    back = jnp.einsum("nrk,nkj->nrj", W, P)
    assert jnp.max(jnp.abs(back - V)) < 1e-6


def test_odometry_chain_matches_sequential():
    rng = np.random.default_rng(1)
    n = 17
    rel = np.stack(
        [
            np.concatenate([_rand_rot(rng), rng.normal(size=(3, 1))], axis=-1)
            for _ in range(n - 1)
        ]
    )
    T = lie.odometry_chain(jnp.asarray(rel))
    # sequential reference
    acc = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=-1)
    seq = [acc]
    for k in range(n - 1):
        acc = np.asarray(lie.se_compose(jnp.asarray(acc), jnp.asarray(rel[k])))
        seq.append(acc)
    assert np.allclose(np.asarray(T), np.stack(seq), atol=1e-9)


def test_chordal_exact_on_noise_free_graph(tiny):
    """tinyGrid3D is not noise-free, so test on a synthetic exact graph:
    chordal must recover ground truth up to the anchored gauge."""
    rng = np.random.default_rng(3)
    n, d = 8, 3
    R = np.stack([_rand_rot(rng) for _ in range(n)])
    t = rng.normal(size=(n, d))
    pairs = [(i, i + 1) for i in range(n - 1)] + [(0, 4), (2, 7)]
    src = np.array([p[0] for p in pairs], np.int32)
    dst = np.array([p[1] for p in pairs], np.int32)
    Rrel = np.einsum("eji,ejk->eik", R[src], R[dst])
    trel = np.einsum("eji,ej->ei", R[src], t[dst] - t[src])
    E = len(pairs)
    es = quadratic.EdgeSet(
        src=jnp.asarray(src), dst=jnp.asarray(dst),
        R=jnp.asarray(Rrel), t=jnp.asarray(trel),
        kappa=jnp.full((E,), 5.0), tau=jnp.full((E,), 50.0),
        weight=jnp.ones((E,)), mask=jnp.ones((E,)), is_loop=jnp.zeros((E,)),
    )
    T = chordal.chordal_initialization(es, n, max_iters=500, tol=1e-12)
    # gauge: solution anchored at pose0=I ⇒ compare to R_0^T R_i etc.
    Tgt = np.concatenate([R, t[..., None]], axis=-1)
    Tgt = np.asarray(
        rounding.anchor_to_first_pose(jnp.asarray(Tgt))
    )
    assert np.max(np.abs(np.asarray(T) - Tgt)) < 1e-6


def test_rounding_recovers_lifted_ground_truth(tiny):
    """Lift an SE(3) trajectory to rank r, round back: must recover it
    exactly (up to gauge)."""
    rng = np.random.default_rng(4)
    n, d, r = 9, 3, 5
    R = np.stack([_rand_rot(rng) for _ in range(n)])
    t = rng.normal(size=(n, d))
    T = jnp.asarray(np.concatenate([R, t[..., None]], axis=-1))
    Ylift = stiefel.random_lifting_matrix(jax.random.PRNGKey(11), r, d)
    X = stiefel.lift_trajectory(T, Ylift)
    Tr = rounding.round_solution(X)
    # rounding is defined up to a global O(d) gauge; anchor both
    a = rounding.anchor_to_first_pose(Tr)
    b = rounding.anchor_to_first_pose(T)
    assert jnp.max(jnp.abs(a - b)) < 1e-6


def test_ate_alignment():
    rng = np.random.default_rng(5)
    n, d = 20, 3
    R = np.stack([_rand_rot(rng) for _ in range(n)])
    t = rng.normal(size=(n, d)) * 5
    T = jnp.asarray(np.concatenate([R, t[..., None]], axis=-1))
    # apply a random rigid transform — ATE after alignment must be ~0
    g = jnp.asarray(
        np.concatenate([_rand_rot(rng), rng.normal(size=(3, 1))], axis=-1)
    )
    T2 = lie.se_compose(jnp.broadcast_to(g, T.shape[:1] + (3, 4)), T)
    assert rounding.ate_translation(T2, T) < 1e-9
    assert rounding.ate_translation(T2, T, align=False) > 0.1


def test_separator_mask():
    data = load_dataset("synthetic_grid125", num_robots=2)
    prob = LiftedProblem.from_data(data, r=5)
    m = prob.separator_mask()
    assert m.shape == (125,)
    assert 0 < float(jnp.sum(m)) < 125
