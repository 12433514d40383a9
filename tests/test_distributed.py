"""Distributed-protocol tests: the deterministic multi-agent simulation and
fault-injection coverage the reference lacks (SURVEY.md §4)."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest

from dpgo_ros_tpu.io.datasets import golden_optimum, load_dataset

TINY_OPT = golden_optimum("synthetic_grid9")
from dpgo_ros_tpu.models.problem import LiftedProblem
from dpgo_ros_tpu.ops import quadratic, stiefel
from dpgo_ros_tpu.parallel.comm import LossyTransport, PerfectTransport
from dpgo_ros_tpu.parallel.controller import DistributedController
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu.types import EdgeType
from dpgo_ros_tpu.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    UpdateRule,
)


def _cfg(num_robots, **kw):
    return AgentConfig(
        num_robots=num_robots,
        update_rule=UpdateRule.ROUND_ROBIN,
        local_initialization_method=InitMethod.ODOMETRY,
        relative_change_tolerance=kw.pop("tol", 0.05),
        max_iteration_number=kw.pop("max_iters", 100),
        RTR_gradnorm_tol=0.5,
        **kw,
    )


def _global_cost(data, T):
    prob = LiftedProblem.from_data(data, r=3)
    X = stiefel.lift_trajectory(
        jnp.asarray(T), jnp.eye(3, dtype=jnp.float64)
    )
    return float(quadratic.cost(X, prob.edges))


def test_fleet_matches_centralized():
    data = load_dataset("synthetic_grid9", num_robots=2)
    ctl = DistributedController(data, _cfg(2))
    res = ctl.run(max_ticks=2000)
    assert all(res["terminated"])
    T = ctl.global_trajectory(res)
    assert T is not None and T.shape == (9, 3, 4)
    # distributed protocol reaches the centralized optimum (certified)
    assert _global_cost(data, T) < TINY_OPT * 1.05
    assert res["messages_sent"] > 0


def test_fleet_telemetry_csv(tmp_path):
    data = load_dataset("synthetic_grid9", num_robots=2)
    cfg = _cfg(2, log_directory=str(tmp_path))
    ctl = DistributedController(data, cfg)
    ctl.run(max_ticks=2000)
    files = glob.glob(str(tmp_path / "agent*" / "dpgo_log_*.csv"))
    assert len(files) == 2
    with open(files[0]) as f:
        header = f.readline().strip()
    assert header == (
        "robot_id,cluster_id,num_active_robots,iteration,num_poses,"
        "bytes_received,iter_time_sec,total_time_sec,rel_change"
    )


def test_fleet_lossy_transport_still_converges():
    """20% message drops + 1-tick delay: the retry/timeout machinery must
    still drive the round to completion."""
    data = load_dataset("synthetic_grid9", num_robots=2)
    cfg = _cfg(2, timeout_threshold=10.0)
    tr = LossyTransport(2, drop_prob=0.2, delay_ticks=1, seed=3)
    ctl = DistributedController(data, cfg, transport=tr)
    res = ctl.run(max_ticks=4000)
    assert all(res["terminated"])
    T = ctl.global_trajectory(res)
    assert T is not None
    assert _global_cost(data, T) < TINY_OPT * 1.10


@pytest.mark.slow
def test_dead_robot_recovery():
    """Kill a robot mid-solve: the leader must time out, shrink the active
    set, broadcast RECOVER, and finish with the survivors (reference
    ``checkTimeout`` semantics, ``PGOAgentROS.cpp:1515-1575``)."""
    data = load_dataset("synthetic_grid125", num_robots=3)
    cfg = _cfg(3, enable_recovery=True, timeout_threshold=8.0, tol=0.3)
    tr = LossyTransport(3)
    ctl = DistributedController(data, cfg, transport=tr)

    killed = {"done": False}
    orig_run = ctl.agents[2].runOnce

    def run_and_maybe_die():
        if (
            not killed["done"]
            and ctl.agents[2].solved_iterations >= 1
        ):
            tr.kill_robot(2)
            killed["done"] = True
            return
        orig_run()

    ctl.agents[2].runOnce = run_and_maybe_die
    res = ctl.run(max_ticks=4000)
    # survivors finish; dead robot excluded from the active set
    assert res["terminated"][0] and res["terminated"][1]
    assert 2 not in res["active_robots"]
    assert res["trajectories"].get(0) is not None
    assert res["trajectories"].get(1) is not None


@pytest.mark.slow
def test_gnc_fleet_rejects_outlier():
    """Inject a gross outlier shared loop closure; the distributed GNC
    rounds must drive its weight to 0 while keeping true edges."""
    data = load_dataset("synthetic_grid9", num_robots=2)
    m = data.measurements
    # fabricate an outlier between robot0 pose1 and robot1 pose2
    out = m.select(np.asarray([len(m) - 1]))
    out.src_robot[:] = 0
    out.src_frame[:] = 1
    out.dst_robot[:] = 1
    out.dst_frame[:] = 2
    out.R[:] = np.eye(3)
    out.t[:] = np.array([25.0, -13.0, 8.0])  # grossly wrong
    out.edge_type[:] = EdgeType.SHARED_LOOP_CLOSURE
    out.fixed_weight[:] = False
    data.measurements = m.concat(out)
    cfg = _cfg(
        2,
        tol=0.05,
        robust_cost_type=RobustCostType.GNC_TLS,
        GNC_use_probability=False,
        GNC_barc=3.0,
        robust_opt_num_weight_updates=3,
        robust_opt_inner_iters_per_robot=4,
        max_iters=60,
    )
    ctl = DistributedController(data, cfg)
    res = ctl.run(max_ticks=6000)
    assert all(res["terminated"])
    # the outlier edge weight must be rejected on both robots
    for rid in (0, 1):
        w = res["weights"][rid]
        assert w is not None
        agent_m = None
        # find the outlier row in each agent's measurement order
        a = ctl.agents[rid]
        # weights were cached before reset; use the cached map
        key = (0, 1, 1, 2)
        assert a.cached_weights is not None
        assert a.cached_weights[key] <= 1e-6
    # global_weights maps the fleet's final weights back onto the global
    # measurement order (feeds the TERMINATE-time export): planted outlier
    # rejected, odometry untouched
    gm = data.measurements
    gw = ctl.global_weights(res, gm)
    assert gw is not None and len(gw) == len(gm)
    planted = [
        k for k in range(len(gm))
        if (int(gm.src_robot[k]), int(gm.src_frame[k]),
            int(gm.dst_robot[k]), int(gm.dst_frame[k])) == (0, 1, 1, 2)
    ]
    assert len(planted) == 1 and gw[planted[0]] <= 1e-6
    odo = np.asarray(gm.edge_type) == EdgeType.ODOMETRY
    assert np.all(gw[odo] == 1.0)


def test_gnc_weight_freezing_and_fixed_replication():
    """Round-1 verdict item: converged weights must freeze
    (``weightConvergenceThreshold``) and the ``fixed`` flags must replicate
    to the non-owner (reference ``PGOAgentROS.cpp:1315-1353``); a frozen
    weight survives later weight rounds unchanged."""
    data = load_dataset("synthetic_grid9", num_robots=2)
    m = data.measurements
    out = m.select(np.asarray([len(m) - 1]))
    out.src_robot[:] = 0
    out.src_frame[:] = 1
    out.dst_robot[:] = 1
    out.dst_frame[:] = 2
    out.R[:] = np.eye(3)
    out.t[:] = np.array([25.0, -13.0, 8.0])  # gross outlier
    out.edge_type[:] = EdgeType.SHARED_LOOP_CLOSURE
    out.fixed_weight[:] = False
    data.measurements = m.concat(out)
    cfg = _cfg(
        2,
        tol=0.05,
        robust_cost_type=RobustCostType.GNC_TLS,
        GNC_use_probability=False,
        GNC_barc=3.0,
        robust_opt_num_weight_updates=3,
        robust_opt_inner_iters_per_robot=4,
        weight_convergence_threshold=0.4,
        robust_opt_num_resets=1,
        max_iters=60,
    )
    ctl = DistributedController(data, cfg)
    a1 = ctl.agents[1]  # NON-owner of shared edge (0,1)->(1,2); owner = 0
    history = []
    orig = a1._on_weights

    def spy(msg):
        orig(msg)
        idx = getattr(a1, "_edge_index", None)
        if idx and (0, 1, 1, 2) in idx and hasattr(a1, "_fixed_np"):
            k = idx[(0, 1, 1, 2)]
            history.append(
                (bool(a1._fixed_np[k]), float(np.asarray(a1.edges.weight)[k]))
            )

    a1._on_weights = spy
    res = ctl.run(max_ticks=6000)
    assert all(res["terminated"])
    # the replicated fixed flag arrived at the non-owner
    assert any(f for f, _ in history), history
    # once frozen, the weight never changes again
    first_frozen = next(i for i, (f, _) in enumerate(history) if f)
    frozen_w = history[first_frozen][1]
    for f, w in history[first_frozen:]:
        assert f and w == frozen_w
    # the outlier ends rejected on both agents
    for rid in (0, 1):
        assert ctl.agents[rid].cached_weights[(0, 1, 1, 2)] <= 1e-6


def test_warm_start_across_rounds():
    """Round 2 must reuse the cached optimized trajectory (reference
    warm-start across instances) and converge in fewer block updates."""
    data = load_dataset("synthetic_grid9", num_robots=2)
    ctl = DistributedController(data, _cfg(2))
    res1 = ctl.run(max_ticks=2000)
    it1 = sum(res1["iterations"].values())
    assert all(res1["terminated"])
    assert ctl.agents[0].instance == 1  # bumped by reset(complete=False)
    assert ctl.agents[0].cached_trajectory is not None
    ctl.start_new_round()
    res2 = ctl.run(max_ticks=2000)
    it2 = sum(res2["iterations"].values())
    assert all(res2["terminated"])
    assert it2 <= it1
    T = ctl.global_trajectory(res2)
    assert _global_cost(data, T) < TINY_OPT * 1.05


@pytest.mark.slow
def test_partitioned_fleet_forms_two_clusters():
    """A link partition splits the fleet: each component elects its lowest
    id as leader (reference cluster re-election, ``PGOAgentROS.cpp:1478-1486``)
    and solves independently."""
    data = load_dataset("synthetic_grid125", num_robots=3)
    cfg = _cfg(3, tol=0.3, timeout_threshold=8.0)
    # robot 2 unreachable from 0 and 1
    tr = LossyTransport(3, partitioned=[(0, 2), (1, 2)])
    ctl = DistributedController(data, cfg, transport=tr)
    res = ctl.run(max_ticks=4000)
    assert ctl.agents[2].cluster_id == 2
    assert ctl.agents[2].is_leader()
    assert ctl.agents[0].cluster_id == 0
    # both clusters terminate and produce their own trajectories
    assert all(res["terminated"])
    assert res["trajectories"].get(0) is not None
    assert res["trajectories"].get(2) is not None


def test_cluster_id_is_min_active():
    data = load_dataset("synthetic_grid9", num_robots=2)
    ctl = DistributedController(data, _cfg(2))
    a = ctl.agents[1]
    assert a.cluster_id == 0
    a.active_robots = {1}
    assert a.cluster_id == 1
    assert a.is_leader()
