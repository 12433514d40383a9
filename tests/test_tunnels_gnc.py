"""Tunnels 8-robot GNC validation on the real dataset, read from
``DPGO_TPU_DATA_DIR`` (the generated GNC world's tests are in
``test_gnc.py``).

Ground-truth note (established against the raw reference data): the
``is_known_inlier`` column of ``data/tunnels/robot*/measurements.csv`` marks
ONLY the 1,247 odometry edges — every one of the 7,192 loop-closure rows
(3,644 after owner-side dedup) carries ``is_known_inlier=0``. Per-edge
precision/recall against ground-truth labels is therefore NOT computable
from the shipped data; the loader maps the column to ``fixedWeight``
(reference ``utils.cpp:141-149``) exactly as the reference does.

What IS verifiable, and what these tests pin:

* the GNC solve converges (rel-change tolerance met, all weight rounds done)
  well inside the reference demo budget;
* the accept/reject split is a *stable fixed point* with real residual
  separation at the converged trajectory — accepted loop closures sit below
  the barc threshold, rejected ones above it, and re-solving on the accepted
  set does not re-admit a hidden mass of wrongly-rejected inliers
  (~95% of tunnels loop closures are genuine outliers: the centralized fp64
  oracle with the reference barc rejects 3,334/3,644, and the distributed
  runs agree).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

import jax.numpy as jnp

from dpgo_ros_tpu.io.datasets import load_dataset
from dpgo_ros_tpu.models import robust
from dpgo_ros_tpu.models.problem import LiftedProblem
from dpgo_ros_tpu.ops import quadratic, rounding
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu.types import EdgeType
from dpgo_ros_tpu.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    UpdateRule,
)

BARC = 3.0  # reference launch/dpgo_gnc_demo.launch:37


@pytest.fixture(scope="module")
def tunnels_solution():
    data = load_dataset("tunnels", num_robots=8)
    prob = LiftedProblem.from_data(data, r=5, dtype=jnp.float64)
    cfg = AgentConfig(
        num_robots=8,
        update_rule=UpdateRule.PARALLEL,
        local_initialization_method=InitMethod.ODOMETRY,
        robust_cost_type=RobustCostType.GNC_TLS,
        GNC_use_probability=False,
        GNC_barc=BARC,
        robust_opt_num_weight_updates=3,
        robust_opt_num_resets=0,
        robust_opt_inner_iters_per_robot=30,
        relative_change_tolerance=0.2,
        RTR_gradnorm_tol=0.5,
        dtype="float64",
    )
    eng = RBCDEngine(prob, cfg)
    st, info = eng.run(eng.initialize())
    return prob, eng, st, info


def test_known_inlier_labels_cover_only_odometry():
    data = load_dataset("tunnels", num_robots=8)
    m = data.measurements
    odo = m.edge_type == EdgeType.ODOMETRY
    # loader parity: fixed_weight == is_known_inlier | odometry; in this
    # dataset every known inlier IS an odometry edge, so no loop closure is
    # fixed — all 3,644 deduped loops are GNC candidates
    assert np.all(m.fixed_weight[odo])
    assert not np.any(m.fixed_weight[~odo])
    assert int((~odo).sum()) == 3644


def test_tunnels_gnc_converges_within_reference_budget(tunnels_solution):
    prob, eng, st, info = tunnels_solution
    ref_budget = (3 + 1) * 50 * 8 - 2  # reference derived maxNumIters = 1598
    assert info["converged"]
    assert info["iterations"] <= ref_budget
    assert int(st.weight_update_count) == 3
    gs = info["gnc_stats"]
    # the reference demo's convergence-ratio gate
    assert gs["convergence_ratio"] >= 0.9
    # ~95% of tunnels loop closures are genuine outliers (oracle-verified);
    # the split must be in that regime, not all-accept or all-reject
    assert 100 <= gs["accepted"] <= 400
    assert gs["rejected"] >= 3000


def test_tunnels_accept_reject_separation(tunnels_solution):
    """Residual separation + fixed-point stability at the converged
    trajectory — the verifiable substitute for per-edge precision/recall
    (no loop-closure ground-truth labels exist in the dataset)."""
    prob, eng, st, info = tunnels_solution
    e = prob.edges
    T = rounding.round_solution(st.X)
    r = np.asarray(robust.measurement_residuals(T, e))
    loop = (np.asarray(e.is_loop) > 0) & (np.asarray(e.mask) > 0)
    w = np.asarray(st.weights)
    acc = loop & (w >= 1 - 1e-6)
    rej = loop & (w <= 1e-6)
    # accepted edges fit the trajectory at the barc scale
    assert np.percentile(r[acc], 90) <= 1.25 * BARC
    # rejected edges genuinely do not (bulk separation)
    assert np.percentile(r[rej], 10) >= BARC
    assert np.median(r[rej]) >= 1.5 * BARC
    # fixed point: every loop passing barc at the final trajectory is
    # either accepted or in the undecided pool (which TERMINATE resolves by
    # this same residual test, gnc_finalize_by_residual) — no hidden mass of
    # re-admittable edges among the hard-rejected ones
    und = loop & ~acc & ~rej
    n_pass = int((r[loop] < BARC).sum())
    assert n_pass <= int(acc.sum()) + int(und.sum())
    assert n_pass >= 0.8 * int(acc.sum())
    n_pass_rejected = int((r[rej] < BARC).sum())
    assert n_pass_rejected <= 0.02 * int(rej.sum())


@pytest.fixture(scope="module")
def tunnels_two_schedules():
    """RoundRobin + Uniform solves at the schedule-stable config
    (convergence-gated weight rounds
    'innertol_tight'): weight rounds fire once every robot's block has
    settled below robust_opt_inner_tol, so GNC residuals are evaluated at
    the weighted optimum — which does not depend on the update order."""
    out = {}
    for rule in (UpdateRule.ROUND_ROBIN, UpdateRule.UNIFORM):
        data = load_dataset("tunnels", num_robots=8)
        prob = LiftedProblem.from_data(data, r=5, dtype=jnp.float64)
        cfg = AgentConfig(
            num_robots=8,
            update_rule=rule,
            local_initialization_method=InitMethod.ODOMETRY,
            robust_cost_type=RobustCostType.GNC_TLS,
            GNC_use_probability=False,
            GNC_barc=BARC,
            robust_opt_num_weight_updates=3,
            robust_opt_num_resets=0,
            robust_opt_inner_iters_per_robot=100,
            robust_opt_inner_tol=0.15,
            relative_change_tolerance=0.1,
            RTR_gradnorm_tol=0.5,
            dtype="float64",
        )
        eng = RBCDEngine(prob, cfg)
        st, info = eng.run(eng.initialize())
        T, st = eng.finalize(st)
        out[rule] = (prob, np.asarray(T), st, info)
    return out


def test_tunnels_gnc_schedule_independence(tunnels_two_schedules):
    """VERDICT r2 #3 acceptance: cross-schedule accept/reject agreement
    >= 99% and cross-schedule ATE <= 0.5% of the trajectory span.
    (Round-2 state: 97.7% / 1.39%; measured round-3: 99.5% / 0.15%,
    exp_tunnels_schedule.json.)"""
    (prob, T_rr, st_rr, info_rr) = tunnels_two_schedules[
        UpdateRule.ROUND_ROBIN
    ]
    (_, T_un, st_un, info_un) = tunnels_two_schedules[UpdateRule.UNIFORM]
    assert info_rr["converged"] and info_un["converged"]
    e = prob.edges
    loop = (np.asarray(e.is_loop) > 0) & (np.asarray(e.mask) > 0)
    acc_rr = np.asarray(st_rr.weights)[loop] >= 0.5
    acc_un = np.asarray(st_un.weights)[loop] >= 0.5
    agreement = float((acc_rr == acc_un).mean())
    assert agreement >= 0.99
    ate = float(
        rounding.ate_translation(jnp.asarray(T_rr), jnp.asarray(T_un))
    )
    span = float(np.ptp(T_rr[:, :, 3], axis=0).max())
    assert ate <= 0.005 * span
    # the disputed edges are exactly the threshold-boundary set: their
    # residuals sit at barc (coherently ambiguous, not random instability)
    flipped = np.flatnonzero(acc_rr != acc_un)
    if flipped.size:
        from dpgo_ros_tpu.models import robust as _robust

        r = np.asarray(
            _robust.measurement_residuals(
                jnp.asarray(rounding.round_solution(st_rr.X)), e
            )
        )[loop][flipped]
        assert np.median(np.abs(r / BARC - 1.0)) < 0.5
