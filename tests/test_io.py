"""Dataset ingestion parity tests (SURVEY.md §7 step 1).

Shapes come from the registry of generated worlds (``io/datasets.py``) and
the reference's partitioning rules (``PGODatasetPublisherNode.cpp:84-135``).
g2o and CSV parsing run on files written from those worlds.
"""

import numpy as np
import pytest

from dpgo_ros_tpu.io import datasets
from dpgo_ros_tpu.io.csv_loader import load_multi_robot_csv
from dpgo_ros_tpu.io.datasets import load_dataset, load_world
from dpgo_ros_tpu.io.g2o import read_g2o, rot_to_quat, write_g2o, _quat_to_rot
from dpgo_ros_tpu.io.partition import contiguous_partition, partition_g2o
from dpgo_ros_tpu.types import EdgeType
from world_files import world_g2o, write_robot_csvs


def test_tinygrid_counts(tmp_path):
    path, _, _ = world_g2o(tmp_path, "synthetic_grid9")
    m, n, vertices = read_g2o(path)
    assert n == 9
    assert len(m) == 14
    assert vertices is not None and len(vertices) == 9
    # rotations are valid
    RtR = np.einsum("eij,eik->ejk", m.R, m.R)
    assert np.allclose(RtR, np.eye(3)[None], atol=1e-6)
    # SE-Sync kappa/tau extraction inverts the writer's isotropic
    # information: noise 0.1 (trans) / 0.05 (rot) => tau 100, kappa 400
    assert np.allclose(m.tau, 100.0, rtol=1e-6)
    assert np.allclose(m.kappa, 400.0, rtol=1e-6)


@pytest.mark.parametrize("name,poses,edges,loops", [
    ("synthetic_grid9", 9, 14, 6),
    ("synthetic_grid125", 125, 244, 120),
    # sphere2500's shape: 50 rings of 50 poses
    ("synthetic_sphere2500", 2500, 4949, 2450),
    ("synthetic_gnc8", 2000, 3954, 1955),
])
def test_dataset_counts(name, poses, edges, loops):
    data, T_gt, out = load_world(name, num_robots=1)
    assert data.total_poses == poses == T_gt.shape[0]
    assert len(data.measurements) == edges
    odo, priv, shared = data.counts_by_type()
    assert (odo, priv + shared) == (poses - 1, loops)
    # only the GNC world plants outliers, all of them loop closures
    assert out.sum() == (round(0.2 * loops) if name == "synthetic_gnc8" else 0)
    assert not out[:poses - 1].any()


def test_bundled_names_need_the_data_dir(monkeypatch, tmp_path):
    """A bundled name reads DPGO_TPU_DATA_DIR and never falls back to a
    generated world."""
    monkeypatch.delenv("DPGO_TPU_DATA_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="DPGO_TPU_DATA_DIR"):
        load_dataset("sphere2500", num_robots=5)
    monkeypatch.setenv("DPGO_TPU_DATA_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="not found"):
        load_dataset("sphere2500", num_robots=5)
    with pytest.raises(KeyError):
        load_dataset("no_such_world")
    path, _, _ = world_g2o(tmp_path, "synthetic_grid9")
    (tmp_path / "tinyGrid3D.g2o").write_text(open(path).read())
    assert load_dataset("tinyGrid3D", num_robots=2).total_poses == 9


def test_contiguous_partition_matches_reference_rule():
    # n=10, 3 robots -> per=3; last robot absorbs remainder (4 poses)
    robot, local = contiguous_partition(10, 3)
    assert list(robot) == [0, 0, 0, 1, 1, 1, 2, 2, 2, 2]
    assert list(local) == [0, 1, 2, 0, 1, 2, 0, 1, 2, 3]


def test_partition_edge_classification():
    data = load_dataset("synthetic_grid125", num_robots=2)
    assert data.num_robots == 2
    assert data.total_poses == 125
    assert list(data.num_poses) == [62, 63]
    n_odo, n_priv, n_shared = data.counts_by_type()
    assert n_odo + n_priv + n_shared == 244
    # every odometry edge is consecutive within one robot
    m = data.measurements
    odo = m.edge_type == EdgeType.ODOMETRY
    assert np.all(m.src_robot[odo] == m.dst_robot[odo])
    assert np.all(m.src_frame[odo] + 1 == m.dst_frame[odo])
    shared = m.edge_type == EdgeType.SHARED_LOOP_CLOSURE
    assert np.all(m.src_robot[shared] != m.dst_robot[shared])
    # odometry edges are GNC-fixed
    assert np.all(m.fixed_weight[odo])
    # a cross-robot odometry-like edge (robot0 pose61 -> robot1 pose0 in the
    # original chain) must be classified shared
    assert n_shared >= 1


def test_partition_initial_guess_shapes():
    data = load_dataset("synthetic_grid9", num_robots=2)
    assert data.initial_guess is not None
    assert data.initial_guess[0].shape == (4, 3, 4)
    assert data.initial_guess[1].shape == (5, 3, 4)


def test_quat_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = _quat_to_rot(*q)
        q2 = rot_to_quat(R)
        assert np.allclose(q, q2, atol=1e-9) or np.allclose(q, -q2, atol=1e-9)


def test_g2o_write_read_roundtrip(tmp_path):
    path, _, _ = world_g2o(tmp_path, "synthetic_grid9")
    m, n, vertices = read_g2o(path)
    traj = np.stack([vertices[i] for i in range(n)])
    p = tmp_path / "out.g2o"
    write_g2o(str(p), traj, m)
    m2, n2, v2 = read_g2o(str(p))
    assert n2 == n and len(m2) == len(m)
    traj2 = np.stack([v2[i] for i in range(n)])
    assert np.allclose(traj, traj2, atol=1e-6)
    assert np.allclose(m.R, m2.R, atol=1e-6)
    assert np.allclose(m.kappa, m2.kappa, rtol=1e-4)
    assert np.allclose(m.tau, m2.tau, rtol=1e-4)


def test_tunnels_loader(tmp_path):
    """The tunnels loader path (per-robot CSVs, shared edges listed by both
    endpoints) on CSVs written from the 8-robot GNC world."""
    world = load_dataset("synthetic_gnc8", num_robots=8)
    data = load_multi_robot_csv(write_robot_csvs(tmp_path, world))
    assert data.num_robots == 8
    # dedup keeps one copy of every shared loop closure
    assert len(data.measurements) == len(world.measurements)
    assert data.counts_by_type() == world.counts_by_type()
    np.testing.assert_array_equal(data.num_poses, world.num_poses)
    # known-inlier column respected
    assert data.measurements.fixed_weight.any()
    assert (~data.measurements.fixed_weight).any()


def test_balanced_contiguous_partition(tmp_path):
    """Work-balanced contiguous cuts: contiguity, non-empty blocks, and a
    bottleneck no worse than the equal-count split (the linear-partition
    optimum is <= any other contiguous split's max block sum)."""
    import numpy as np

    from dpgo_ros_tpu.io.datasets import load_dataset
    from dpgo_ros_tpu.io.partition import (
        balanced_contiguous_partition,
        contiguous_partition,
        pose_work_weights,
    )

    rng = np.random.default_rng(0)
    for R in (2, 3, 7):
        w = rng.uniform(0.5, 5.0, size=200)
        robot, local = balanced_contiguous_partition(w, R)
        assert robot.shape == (200,)
        # contiguous and non-decreasing, all robots present
        assert np.all(np.diff(robot) >= 0)
        assert set(robot.tolist()) == set(range(R))
        # local frames restart at 0 per block
        starts = np.flatnonzero(np.r_[1, np.diff(robot)])
        assert np.all(local[starts] == 0)
        sums_b = np.bincount(robot, weights=w, minlength=R)
        eq_r, _ = contiguous_partition(200, R)
        sums_e = np.bincount(eq_r, weights=w, minlength=R)
        assert sums_b.max() <= sums_e.max() + 1e-9

    # loop closures concentrated in the first two fifths of the sphere
    # world (as parking-garage concentrates them): work skew drops from
    # ~1.25 (equal poses) to ~1.0 (balanced)
    data, T_gt, _ = load_world("synthetic_sphere2500", num_robots=1)
    m = data.measurements
    keep = (m.edge_type == EdgeType.ODOMETRY) | (m.src_frame < 1000)
    path = str(tmp_path / "skewed.g2o")
    write_g2o(path, T_gt, m.select(keep))
    data_eq = partition_g2o(path, 5)
    data_bal = partition_g2o(path, 5, balance="work")

    def skew(data):
        from dpgo_ros_tpu.models.problem import LiftedProblem

        prob = LiftedProblem.from_data(data, r=5)
        src = np.asarray(prob.edges.src)
        msk = np.asarray(prob.edges.mask) > 0
        owner = (
            np.searchsorted(np.asarray(prob.offsets), src[msk], "right") - 1
        )
        work = np.asarray(prob.num_poses, float) + np.bincount(
            owner, minlength=prob.num_robots
        )
        return work.max() / work.mean()

    assert skew(data_eq) > 1.2
    assert skew(data_bal) < 1.05
    # same problem: identical measurement count and total poses
    assert int(np.sum(data_bal.num_poses)) == int(np.sum(data_eq.num_poses))
    assert len(data_bal.measurements) == len(data_eq.measurements)


def test_balanced_partition_solves_to_same_optimum():
    """Different cut points, same global problem: a 2-robot balanced-
    partition solve reaches the same tinyGrid3D optimum."""
    import jax.numpy as jnp

    from dpgo_ros_tpu.io.datasets import load_dataset
    from dpgo_ros_tpu.parallel.rbcd import RBCDEngine
    from dpgo_ros_tpu.models.problem import LiftedProblem
    from dpgo_ros_tpu.utils.config import AgentConfig, UpdateRule

    data = load_dataset("synthetic_grid9", num_robots=2, balance="work")
    prob = LiftedProblem.from_data(data, r=5)
    eng = RBCDEngine(
        prob,
        AgentConfig(
            num_robots=2, update_rule=UpdateRule.ROUND_ROBIN,
            relative_change_tolerance=1e-2, max_iteration_number=100,
            RTR_gradnorm_tol=0.1,
        ),
    )
    _, info = eng.run(eng.initialize())
    assert info["final_cost"] < (
        datasets.golden_optimum("synthetic_grid9") * 1.02
    )
