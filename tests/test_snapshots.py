"""Mid-run observability (utils/snapshots.py + --viz_interval, round 4).

The reference republishes trajectories every 30 s while solving
(``src/PGOAgentROS.cpp:85-86``); these tests pin the snapshot analog on
budget-capped solves."""

import glob
import os

import numpy as np

from dpgo_ros_tpu import cli as cli_mod


def test_engine_mid_run_snapshots(tmp_path):
    snap_dir = str(tmp_path / "snaps")
    rc = cli_mod.main([
        "--dataset", "synthetic_grid9", "--num_robots", "2",
        "--platform", "cpu",
        "--max_iteration_number", "8",
        "--relative_change_tolerance", "0",
        "--viz_interval_iters", "2",
        "--viz_dir", snap_dir,
    ])
    assert rc == 0
    tums = sorted(glob.glob(os.path.join(snap_dir, "snap_iter*.tum")))
    assert len(tums) >= 2, f"expected >=2 mid-run snapshots, got {tums}"
    # progressive HTML frame + manifest
    assert os.path.exists(os.path.join(snap_dir, "latest.html"))
    man = open(os.path.join(snap_dir, "snapshots.csv")).read().splitlines()
    assert man[0] == "iteration,wall_sec,cost,file"
    assert len(man) - 1 == len(tums)
    # snapshots are valid trajectories (TUM: t x y z qx qy qz qw)
    rows = np.loadtxt(tums[0])
    assert rows.shape[1] == 8 and np.all(np.isfinite(rows))
    # distinct iterations, increasing
    its = [int(line.split(",")[0]) for line in man[1:]]
    assert its == sorted(its) and len(set(its)) == len(its)


def test_spmd_mid_run_snapshots(tmp_path):
    snap_dir = str(tmp_path / "snaps_spmd")
    rc = cli_mod.main([
        "--dataset", "synthetic_grid9", "--num_robots", "2",
        "--mode", "spmd", "--platform", "cpu",
        "--max_iteration_number", "8",
        "--relative_change_tolerance", "0",
        "--viz_interval_iters", "3",
        "--viz_dir", snap_dir,
    ])
    assert rc == 0
    tums = sorted(glob.glob(os.path.join(snap_dir, "snap_iter*.tum")))
    assert len(tums) >= 2


def test_fleet_mid_run_snapshots(tmp_path):
    """Round 5 (VERDICT r4 #8): the fleet protocol simulation — the mode
    that runs longest — streams mid-run snapshots too."""
    snap_dir = str(tmp_path / "fleet_snaps")
    rc = cli_mod.main([
        "--dataset", "synthetic_grid9", "--num_robots", "2",
        "--platform", "cpu", "--mode", "fleet",
        "--viz_interval_iters", "3",  # ticks, in fleet mode
        "--viz_dir", snap_dir,
    ])
    assert rc == 0
    tums = sorted(glob.glob(os.path.join(snap_dir, "snap_iter*.tum")))
    assert len(tums) >= 2, f"expected >=2 mid-run snapshots, got {tums}"
    assert os.path.exists(os.path.join(snap_dir, "latest.html"))
    rows = np.loadtxt(tums[-1])
    assert rows.shape[1] == 8 and np.all(np.isfinite(rows))
