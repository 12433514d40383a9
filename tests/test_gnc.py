"""GNC robustness tests with known outlier labels (the quantitative oracle
the reference lacks — SURVEY.md §4)."""

import numpy as np
import pytest

from dpgo_ros_tpu.io.datasets import load_dataset
from dpgo_ros_tpu.models.problem import LiftedProblem
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu.types import EdgeType, MeasurementBatch
from dpgo_ros_tpu.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    UpdateRule,
)


def inject_outliers(data, frac: float, seed: int = 0):
    """Append random gross-outlier loop closures (uniformly random rotation,
    large random translation) between random pose pairs. Returns (data,
    outlier_mask_over_measurements)."""
    rng = np.random.default_rng(seed)
    m = data.measurements
    E = len(m)
    num_out = int(frac * E)
    rows = []
    for _ in range(num_out):
        while True:
            ra, rb = rng.integers(data.num_robots, size=2)
            fa = rng.integers(data.num_poses[ra])
            fb = rng.integers(data.num_poses[rb])
            if (ra, fa) != (rb, fb):
                break
        A = rng.normal(size=(3, 3))
        Q, _ = np.linalg.qr(A)
        if np.linalg.det(Q) < 0:
            Q[:, 0] = -Q[:, 0]
        rows.append((ra, fa, rb, fb, Q, rng.normal(size=3) * 10.0))
    out = MeasurementBatch(
        src_robot=np.asarray([r[0] for r in rows], np.int32),
        src_frame=np.asarray([r[1] for r in rows], np.int32),
        dst_robot=np.asarray([r[2] for r in rows], np.int32),
        dst_frame=np.asarray([r[3] for r in rows], np.int32),
        R=np.stack([r[4] for r in rows]),
        t=np.stack([r[5] for r in rows]),
        kappa=np.full(num_out, float(np.median(m.kappa))),
        tau=np.full(num_out, float(np.median(m.tau))),
        weight=np.ones(num_out),
        fixed_weight=np.zeros(num_out, bool),
        edge_type=np.where(
            np.asarray([r[0] for r in rows]) == np.asarray([r[2] for r in rows]),
            EdgeType.PRIVATE_LOOP_CLOSURE,
            EdgeType.SHARED_LOOP_CLOSURE,
        ).astype(np.int32),
    )
    data.measurements = m.concat(out)
    is_outlier = np.zeros(E + num_out, bool)
    is_outlier[E:] = True
    return data, is_outlier


@pytest.mark.slow
def test_gnc_tls_local_init_beats_odometry_under_outliers():
    """GNC_TLS robust local initialization (reference
    ``localInitializationMethod=GNC_TLS``) must produce a lower-cost init
    than plain chordal when private loop closures contain gross outliers."""
    data = load_dataset("synthetic_grid125", num_robots=1)
    data, is_outlier = inject_outliers(data, frac=0.15, seed=3)
    prob = LiftedProblem.from_data(data, r=5)

    def init_cost(method):
        cfg = AgentConfig(
            num_robots=1,
            local_initialization_method=method,
            robust_cost_type=RobustCostType.GNC_TLS,
            GNC_use_probability=False,
            GNC_barc=3.0,
        )
        eng = RBCDEngine(prob, cfg)
        st = eng.initialize()
        # evaluate on the inlier-only objective
        import dataclasses as dc

        import jax.numpy as jnp

        from dpgo_ros_tpu.ops import quadratic

        w = jnp.asarray(~is_outlier, st.X.dtype)
        e = dc.replace(prob.edges, weight=w)
        return float(quadratic.cost(st.X, e))

    f_chordal = init_cost(InitMethod.CHORDAL)
    f_robust = init_cost(InitMethod.GNC_TLS)
    assert f_robust < f_chordal


@pytest.mark.slow
def test_gnc_engine_outlier_precision_recall():
    """smallGrid3D + 20% injected gross outliers: GNC must reject (almost)
    all outliers and keep (almost) all true loop closures."""
    data = load_dataset("synthetic_grid125", num_robots=2)
    data, is_outlier = inject_outliers(data, frac=0.2, seed=1)
    prob = LiftedProblem.from_data(data, r=5)
    cfg = AgentConfig(
        num_robots=2,
        update_rule=UpdateRule.ROUND_ROBIN,
        local_initialization_method=InitMethod.ODOMETRY,
        robust_cost_type=RobustCostType.GNC_TLS,
        GNC_use_probability=False,
        GNC_barc=3.0,
        robust_opt_num_weight_updates=4,
        robust_opt_inner_iters_per_robot=15,
        robust_opt_num_resets=1,
        relative_change_tolerance=0.05,
        RTR_gradnorm_tol=0.5,
    )
    eng = RBCDEngine(prob, cfg)
    st, info = eng.run()
    T, st = eng.finalize(st)
    w = np.asarray(st.weights)[: len(data.measurements)]
    loops = np.asarray(prob.edges.is_loop)[: len(data.measurements)] > 0
    accepted = w > 0.5
    # all outliers are loops
    out = is_outlier
    inl_loops = loops & ~out
    # recall: accepted true loops / true loops; precision on outliers:
    # rejected outliers / outliers
    rejected_outliers = np.sum(~accepted & out) / max(np.sum(out), 1)
    accepted_inliers = np.sum(accepted & inl_loops) / max(np.sum(inl_loops), 1)
    assert rejected_outliers >= 0.95, rejected_outliers
    assert accepted_inliers >= 0.8, accepted_inliers
    # the robust solution should be close to the clean-data optimum
    assert info["final_cost"] < 1e5


def test_fused_runner_fires_convergence_gated_weight_rounds():
    """The ``robust_opt_inner_tol`` clause fires GNC weight rounds in the
    one-program runner (``make_fused_run``) well before the cadence cap,
    and every scheduled weight round completes."""
    import jax.numpy as jnp

    data = load_dataset("synthetic_grid9", num_robots=1)
    data, _ = inject_outliers(data, frac=0.2, seed=3)
    prob = LiftedProblem.from_data(data, r=5, dtype=jnp.float32)
    cfg = AgentConfig(
        num_robots=1,
        local_initialization_method=InitMethod.ODOMETRY,
        robust_cost_type=RobustCostType.GNC_TLS,
        GNC_use_probability=False,
        GNC_barc=3.0,
        robust_opt_num_weight_updates=2,
        robust_opt_inner_iters_per_robot=20,
        robust_opt_inner_tol=0.5,
        relative_change_tolerance=1e-3,
        RTR_gradnorm_tol=0.5,
        max_iteration_number=60,
        dtype="float32",
    )
    cadence = cfg.robust_opt_inner_iters_per_robot * cfg.num_robots
    eng = RBCDEngine(prob, cfg)
    st, _, ev = eng.make_fused_run(60, record=True)(eng.initialize())
    fires = np.flatnonzero(ev)
    assert int(st.weight_update_count) == 2
    assert fires.size >= 1 and fires[0] < cadence, fires


@pytest.mark.parametrize("rtype", [RobustCostType.TLS, RobustCostType.GM,
                                   RobustCostType.HUBER])
@pytest.mark.slow
def test_irls_robust_costs_reject_outliers(rtype):
    """The non-GNC robust kernels (IRLS reweighting rounds) must also
    suppress gross outliers (reference RobustCost family)."""
    data = load_dataset("synthetic_grid9", num_robots=1)
    data, is_outlier = inject_outliers(data, frac=0.2, seed=2)
    prob = LiftedProblem.from_data(data, r=5)
    cfg = AgentConfig(
        num_robots=1,
        local_initialization_method=InitMethod.ODOMETRY,
        robust_cost_type=rtype,
        GNC_use_probability=False,
        GNC_barc=3.0,
        robust_opt_num_weight_updates=3,
        robust_opt_inner_iters_per_robot=5,
        relative_change_tolerance=0.05,
        RTR_gradnorm_tol=0.5,
        max_iteration_number=40,
    )
    eng = RBCDEngine(prob, cfg)
    st, info = eng.run()
    w = np.asarray(st.weights)[: len(data.measurements)]
    # outlier edges end up with (much) smaller weights than inliers
    loops = np.asarray(prob.edges.is_loop)[: len(data.measurements)] > 0
    inl = loops & ~is_outlier
    if inl.sum() and is_outlier.sum():
        assert w[is_outlier].mean() < 0.25 * max(w[inl].mean(), 1e-9)
