"""2D (SE(2)) support: the lifted machinery is dimension-generic (the
reference supports d=2 via the ``dimension`` parameter,
``launch/PGOAgent.launch:11``)."""

import numpy as np
import pytest

from dpgo_ros_tpu.models.problem import LiftedProblem
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu.types import EdgeType, MeasurementBatch, PoseGraphData
from dpgo_ros_tpu.utils.config import AgentConfig, InitMethod, UpdateRule


def _rot2(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s], [s, c]])


def _se2_dataset(n=20, num_robots=2, seed=0, noise=0.02):
    rng = np.random.default_rng(seed)
    th = np.cumsum(rng.normal(scale=0.4, size=n))
    t = np.cumsum(rng.normal(scale=1.0, size=(n, 2)), axis=0)
    R = np.stack([_rot2(a) for a in th])
    pairs = [(i, i + 1) for i in range(n - 1)] + [(0, n // 2), (2, n - 1)]
    src = np.array([p[0] for p in pairs], np.int32)
    dst = np.array([p[1] for p in pairs], np.int32)
    Rrel = np.einsum("eji,ejk->eik", R[src], R[dst])
    trel = np.einsum("eji,ej->ei", R[src], t[dst] - t[src])
    for k in range(len(pairs)):
        Rrel[k] = Rrel[k] @ _rot2(rng.normal(scale=noise))
        trel[k] += rng.normal(scale=noise, size=2)
    E = len(pairs)
    per = n // num_robots
    robot = np.minimum(src // per, num_robots - 1), np.minimum(
        dst // per, num_robots - 1
    )
    sr = np.minimum(src // per, num_robots - 1).astype(np.int32)
    dr = np.minimum(dst // per, num_robots - 1).astype(np.int32)
    sf = (src - sr * per).astype(np.int32)
    df = (dst - dr * per).astype(np.int32)
    same = sr == dr
    et = np.where(
        same & (sf + 1 == df),
        EdgeType.ODOMETRY,
        np.where(same, EdgeType.PRIVATE_LOOP_CLOSURE, EdgeType.SHARED_LOOP_CLOSURE),
    ).astype(np.int32)
    m = MeasurementBatch(
        src_robot=sr, src_frame=sf, dst_robot=dr, dst_frame=df,
        R=Rrel, t=trel,
        kappa=np.full(E, 50.0), tau=np.full(E, 100.0),
        weight=np.ones(E), fixed_weight=et == EdgeType.ODOMETRY,
        edge_type=et,
    )
    num_poses = np.array([per] * (num_robots - 1) + [n - per * (num_robots - 1)])
    return PoseGraphData(measurements=m, num_poses=num_poses, d=2)


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.slow
def test_se2_single_and_two_robot(r):
    data = _se2_dataset()
    prob = LiftedProblem.from_data(data, r=r)
    assert prob.d == 2
    cfg = AgentConfig(
        num_robots=2,
        dimension=2,
        relaxation_rank=r,
        update_rule=UpdateRule.ROUND_ROBIN,
        local_initialization_method=InitMethod.ODOMETRY,
        relative_change_tolerance=1e-2,
        max_iteration_number=60,
        RTR_gradnorm_tol=0.1,
    )
    eng = RBCDEngine(prob, cfg)
    st = eng.initialize()
    f0 = float(st.cost)
    st, info = eng.run(st)
    assert info["final_cost"] < 0.5 * f0 + 1.0
    T, _ = eng.finalize(st)
    assert T.shape == (20, 2, 3)
    # valid SO(2) blocks
    RtR = np.einsum("nij,nik->njk", T[:, :, :2], T[:, :, :2])
    assert np.allclose(RtR, np.eye(2)[None], atol=1e-6)


def test_se2_engine_smoke():
    """Fast SE(2) pin: d=2 problem builds, initializes, and a short XLA-path
    run decreases the cost (the fused-kernel equivalence pin is the slow
    ``test_fused_kernel_se2_matches_xla``)."""
    data = _se2_dataset(n=16, num_robots=2)
    prob = LiftedProblem.from_data(data, r=3)
    assert prob.d == 2
    eng = RBCDEngine(
        prob,
        AgentConfig(
            num_robots=2,
            dimension=2,
            relaxation_rank=3,
            update_rule=UpdateRule.ROUND_ROBIN,
            local_initialization_method=InitMethod.ODOMETRY,
            relative_change_tolerance=0.0,
            max_iteration_number=4,
            RTR_gradnorm_tol=0.1,
        ),
    )
    st = eng.initialize()
    f0 = float(st.cost)
    st, info = eng.run(st)
    assert np.isfinite(info["final_cost"]) and info["final_cost"] <= f0


def test_rtr_block_solve_se2_fp32_matches_fp64():
    """Fast-suite d=2 numerical pin: one masked RTR block solve on a small
    SE(2) world in fp32 lands on the fp64 solve from the same input."""
    import jax
    import jax.numpy as jnp

    from dpgo_ros_tpu.models.local_solvers import RTRParams, rtr_solve
    from dpgo_ros_tpu.ops import quadratic, stiefel

    data = _se2_dataset(n=16, num_robots=2)
    params = RTRParams(
        max_iterations=2, max_tcg_iterations=12, gradnorm_tol=0.1
    )
    key = jax.random.PRNGKey(2)
    out = {}
    for dt in (jnp.float64, jnp.float32):
        prob = LiftedProblem.from_data(data, r=3, dtype=dt)
        e = prob.edges
        Y = stiefel.random_stiefel(key, prob.n, prob.r, prob.d, jnp.float64)
        p = 0.1 * jax.random.normal(key, (prob.n, prob.r, 1), jnp.float64)
        X = jnp.concatenate([Y, p], axis=-1).astype(dt)
        mask = prob.block_mask(0, dt)
        Pinv = quadratic.precond_inverse(quadratic.precond_blocks(e, prob.n))
        X_new, res = rtr_solve(X, e, mask, Pinv, params)
        # only the masked block moves (the retraction of a zero step
        # returns the pose to rounding)
        eps = float(jnp.finfo(dt).eps)
        assert float(jnp.max(jnp.abs((1 - mask) * (X_new - X)))) < 10 * eps
        assert float(res.f_opt) < float(res.f_init)
        out[dt] = (np.asarray(X_new, np.float64), float(res.f_opt))
    (X64, f64), (X32, f32) = out[jnp.float64], out[jnp.float32]
    assert f32 == pytest.approx(f64, rel=1e-4)
    assert np.max(np.abs(X32 - X64)) < 1e-3 * np.max(np.abs(X64))
