"""SPMD device-mesh tests on the virtual 8-device CPU mesh (SURVEY.md §7
step 8: multi-host path validated via xla_force_host_platform_device_count)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from dpgo_ros_tpu.io.datasets import golden_optimum, load_dataset

SMALL_OPT = golden_optimum("synthetic_grid125")
from dpgo_ros_tpu.models.problem import LiftedProblem
from dpgo_ros_tpu.ops import quadratic
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu.parallel.spmd import (
    ShardedProblem,
    build_spmd_step,
    gather_trajectory,
)
from dpgo_ros_tpu.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    UpdateRule,
)


def _setup(num_robots, **cfg_kw):
    data = load_dataset("synthetic_grid125", num_robots=num_robots)
    prob = LiftedProblem.from_data(data, r=5, dtype=jnp.float32)
    cfg_kw.setdefault("local_initialization_method", InitMethod.ODOMETRY)
    cfg = AgentConfig(
        num_robots=num_robots,
        update_rule=UpdateRule.PARALLEL,
        RTR_gradnorm_tol=0.5,
        dtype="float32",
        **cfg_kw,
    )
    eng = RBCDEngine(prob, cfg)
    st0 = eng.initialize()
    sp = ShardedProblem.build(
        prob,
        np.asarray(st0.X, np.float32),
        eng.robot_colors,
        num_devices=num_robots,
    )
    mesh = Mesh(np.array(jax.devices()[:num_robots]), ("robots",))
    init, step = build_spmd_step(sp, mesh, cfg)
    return data, prob, eng, st0, sp, init, step


def test_spmd_matches_centralized_cost():
    data, prob, eng, st0, sp, st, step = _setup(8)
    for it in range(60):
        st = step(np.int32(it), np.int32(0), st)
        st.X.block_until_ready()
    Xg = gather_trajectory(sp, st, prob.num_poses)
    f = float(
        quadratic.cost(jnp.asarray(Xg, jnp.float64), eng._edges(st0.weights))
    )
    # centralized fp64 optimum (certified)
    assert f < SMALL_OPT * 1.01


def test_spmd_accelerated_runs_and_descends():
    data, prob, eng, st0, sp, st, step = _setup(8, acceleration=True)
    f0 = float(quadratic.cost(st0.X, eng._edges(st0.weights)))
    for it in range(30):
        st = step(np.int32(it), np.int32(0), st)
        st.X.block_until_ready()
    Xg = gather_trajectory(sp, st, prob.num_poses)
    f = float(
        quadratic.cost(jnp.asarray(Xg, jnp.float64), eng._edges(st0.weights))
    )
    assert f < 0.1 * f0
    assert np.all(np.isfinite(np.asarray(st.X)))


def test_spmd_gnc_weight_round():
    data, prob, eng, st0, sp, st, step = _setup(
        4,
        robust_cost_type=RobustCostType.GNC_TLS,
        GNC_use_probability=False,
        GNC_barc=3.0,
    )
    for it in range(10):
        st = step(np.int32(it), np.int32(0), st)
    st = step(np.int32(10), np.int32(1), st)  # weight round
    st.X.block_until_ready()
    w = np.asarray(st.weights)
    assert np.all((w >= 0) & (w <= 1))
    mu = float(np.asarray(st.mu)[0, 0])
    assert mu > 1e-5  # mu advanced

    # regression (round-1 verdict): the reported final cost must use the
    # FINAL weights — reassembled globally via gather_weights — and the
    # replicated copies of each shared edge must agree exactly
    from dpgo_ros_tpu.parallel.spmd import gather_weights

    wg = gather_weights(sp, st, prob.edges.num_edges)
    sel = sp.gidx >= 0
    flat_g, flat_w = sp.gidx[sel], w[sel]
    for gid in np.unique(flat_g):
        vals = flat_w[flat_g == gid]
        assert np.allclose(vals, vals[0]), "shared-edge copies disagree"
        assert np.isclose(wg[gid], vals[0])
    Xg = gather_trajectory(sp, st, prob.num_poses)
    f_final = float(
        quadratic.cost(jnp.asarray(Xg), eng._edges(jnp.asarray(wg)))
    )
    assert np.isfinite(f_final)


def _skewed_world(n=1000, num_robots=5):
    """A 5-robot sphere world whose loop closures all start in robot 0's
    block: equal-pose blocks carry very unequal edge work."""
    from dpgo_ros_tpu.io.datasets import load_world
    from dpgo_ros_tpu.io.partition import (
        contiguous_partition,
        partition_measurements,
    )
    from dpgo_ros_tpu.types import EdgeType, PoseGraphData

    data, _, _ = load_world("synthetic_sphere2500", num_robots=1, n=n)
    m = data.measurements
    m = m.select((m.edge_type == EdgeType.ODOMETRY) | (m.src_frame < 200))
    robot, local = contiguous_partition(n, num_robots)
    return PoseGraphData(
        measurements=partition_measurements(m, n, num_robots, robot, local),
        num_poses=np.bincount(robot, minlength=num_robots).astype(np.int64),
        d=3,
    )


def _work_skew(data):
    """max/mean of per-block lane work (poses + owned edges) — the
    lane-cost load-balance model."""
    num_poses = np.asarray(data.num_poses, np.int64)
    offs = np.concatenate([[0], np.cumsum(num_poses)])
    m = data.measurements
    gsrc = offs[m.src_robot] + m.src_frame
    owner = np.searchsorted(offs[1:], gsrc, side="right")
    edges = np.bincount(owner, minlength=data.num_robots)
    work = num_poses + edges
    return float(work.max() / work.mean())


def test_repartition_slots_cost_invariant_and_balanced():
    """Round 5 (VERDICT r4 #6): work-balanced slot repartition — splits
    hot robots / co-schedules cold ones. The measurement set is label-
    invariant (identical cost on the same global trajectory), the work
    skew drops to ~1, and the mesh program still converges to the
    centralized optimum."""
    from dpgo_ros_tpu.parallel.spmd import repartition_slots

    data = load_dataset("synthetic_grid125", num_robots=2)
    data3 = repartition_slots(
        load_dataset("synthetic_grid125", num_robots=2), 3
    )
    assert data3.num_robots == 3
    prob2 = LiftedProblem.from_data(data, r=5, dtype=jnp.float32)
    prob3 = LiftedProblem.from_data(data3, r=5, dtype=jnp.float32)
    cfg2 = AgentConfig(
        num_robots=2,
        local_initialization_method=InitMethod.ODOMETRY,
        dtype="float32",
    )
    st2 = RBCDEngine(prob2, cfg2).initialize()
    # identical global pose ordering → identical cost for the same X
    f2 = float(quadratic.cost(st2.X, prob2.edges))
    f3 = float(quadratic.cost(st2.X, prob3.edges))
    assert f3 == pytest.approx(f2, rel=1e-5)
    # the dataset-fixed skew case (as parking-garage@5): loop closures
    # concentrated in robot 0's block (~1.36 → ~1.0)
    pg = _skewed_world()
    s_before = _work_skew(pg)
    s_after = _work_skew(repartition_slots(_skewed_world(), 5))
    assert s_before > 1.3 and s_after < 1.1, (s_before, s_after)
    # the repartitioned mesh still converges to the centralized optimum
    cfg3 = AgentConfig(
        num_robots=3,
        update_rule=UpdateRule.PARALLEL,
        local_initialization_method=InitMethod.ODOMETRY,
        RTR_gradnorm_tol=0.5,
        dtype="float32",
    )
    eng3 = RBCDEngine(prob3, cfg3)
    st0 = eng3.initialize()
    sp = ShardedProblem.build(
        prob3, np.asarray(st0.X, np.float32), eng3.robot_colors,
        num_devices=3,
    )
    mesh = Mesh(np.array(jax.devices()[:3]), ("robots",))
    st, step = build_spmd_step(sp, mesh, cfg3)
    for it in range(60):
        st = step(np.int32(it), np.int32(0), st)
    Xg = gather_trajectory(sp, st, prob3.num_poses)
    f = float(
        quadratic.cost(jnp.asarray(Xg, jnp.float64), eng3._edges(st0.weights))
    )
    assert f < SMALL_OPT * 1.01


def test_spmd_separator_only_exchange_matches_full():
    """Round 5: exchanging ONLY separator slabs (the PublicPoses payload —
    the reference's core bandwidth idea) must reproduce the full-block
    exchange: a device's edge set touches nothing but its own block and
    separators, so the inert template lanes are mathematically invisible
    to the masked solves."""
    outs = {}
    for flag in (False, True):
        data, prob, eng, st0, sp, st, step = _setup(
            4, spmd_separator_only=flag
        )
        assert sp.S_max >= 1
        for it in range(12):
            st = step(np.int32(it), np.int32(0), st)
        outs[flag] = gather_trajectory(sp, st, prob.num_poses)
    np.testing.assert_allclose(outs[True], outs[False], rtol=1e-6, atol=1e-6)


@pytest.mark.slow
def test_spmd_more_robots_than_devices_via_grouping():
    """8 robots on a 4-device mesh: robots group into super-blocks."""
    from dpgo_ros_tpu.parallel.spmd import group_robots

    data = load_dataset("synthetic_grid125", num_robots=8)
    grouped = group_robots(data, 4)
    assert grouped.num_robots == 4
    assert grouped.total_poses == data.total_poses
    assert len(grouped.measurements) == len(data.measurements)
    prob = LiftedProblem.from_data(grouped, r=5, dtype=jnp.float32)
    cfg = AgentConfig(
        num_robots=4,
        update_rule=UpdateRule.PARALLEL,
        local_initialization_method=InitMethod.ODOMETRY,
        RTR_gradnorm_tol=0.5,
        dtype="float32",
    )
    eng = RBCDEngine(prob, cfg)
    st0 = eng.initialize()
    sp = ShardedProblem.build(
        prob, np.asarray(st0.X, np.float32), eng.robot_colors, num_devices=4
    )
    mesh = Mesh(np.array(jax.devices()[:4]), ("robots",))
    st, step = build_spmd_step(sp, mesh, cfg)
    for it in range(60):
        st = step(np.int32(it), np.int32(0), st)
        st.X.block_until_ready()
    Xg = gather_trajectory(sp, st, prob.num_poses)
    f = float(
        quadratic.cost(jnp.asarray(Xg, jnp.float64), eng._edges(st0.weights))
    )
    assert f < SMALL_OPT * 1.01  # centralized optimum


@pytest.mark.slow
def test_spmd_more_devices_than_robots():
    """Empty mesh slots (8 devices, 5 robots) must be inert."""
    data = load_dataset("synthetic_grid125", num_robots=5)
    prob = LiftedProblem.from_data(data, r=5, dtype=jnp.float32)
    cfg = AgentConfig(
        num_robots=5,
        update_rule=UpdateRule.PARALLEL,
        local_initialization_method=InitMethod.ODOMETRY,
        RTR_gradnorm_tol=0.5,
        dtype="float32",
    )
    eng = RBCDEngine(prob, cfg)
    st0 = eng.initialize()
    sp = ShardedProblem.build(
        prob, np.asarray(st0.X, np.float32), eng.robot_colors, num_devices=8
    )
    mesh = Mesh(np.array(jax.devices()[:8]), ("robots",))
    st, step = build_spmd_step(sp, mesh, cfg)
    for it in range(20):
        st = step(np.int32(it), np.int32(0), st)
        st.X.block_until_ready()
    Xg = gather_trajectory(sp, st, prob.num_poses)
    f = float(
        quadratic.cost(jnp.asarray(Xg, jnp.float64), eng._edges(st0.weights))
    )
    f0 = float(quadratic.cost(st0.X, eng._edges(st0.weights)))
    assert f < 0.05 * f0
    assert np.all(np.isfinite(np.asarray(st.X)))
