"""Out-of-process front-end service (parallel/frontend.py, round 4).

The reference's ingestion is a network service a real SLAM stack calls
(``src/PGODatasetPublisherNode.cpp:46-51``, ``src/PGOAgentROS.cpp:246-261``).
These tests run the publisher in a SEPARATE PROCESS and drive solves
against it across the socket.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from dpgo_ros_tpu.io.datasets import load_dataset
from dpgo_ros_tpu.parallel.agent_node import DatasetServer
from dpgo_ros_tpu.parallel.frontend import (
    PoseGraphPublisher,
    RemoteDatasetServer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn_server(dataset, num_robots, output=None):
    """Launch the front-end as a real separate process; returns
    (Popen, host, port)."""
    cmd = [
        sys.executable, "-m", "dpgo_ros_tpu.parallel.frontend",
        "--dataset", dataset, "--num_robots", str(num_robots),
        "--port", "0",
    ]
    if output:
        cmd += ["--output", output]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, cwd=REPO, env=env,
    )
    line = proc.stdout.readline()
    assert "serving" in line, f"server failed to start: {line!r}"
    hostport = line.rsplit(" on ", 1)[1].strip()
    host, _, port = hostport.rpartition(":")
    return proc, host, int(port)


def test_frontend_two_process_pose_graphs_match_local():
    """Per-robot pose graphs served across the process boundary are
    field-exact equal to the in-process DatasetServer's."""
    proc, host, port = _spawn_server("synthetic_grid9", 2)
    try:
        cli = RemoteDatasetServer(host, port)
        nR, d, num_poses = cli.meta()
        data = load_dataset("synthetic_grid9", num_robots=2)
        assert nR == 2 and d == data.d
        np.testing.assert_array_equal(num_poses, data.num_poses)
        local = DatasetServer(data)
        for k in range(2):
            m_r, n_r = cli.request_pose_graph(k)
            m_l, n_l = local.request_pose_graph(k)
            assert n_r == n_l
            import dataclasses

            for f in dataclasses.fields(m_l):
                np.testing.assert_array_equal(
                    getattr(m_r, f.name), getattr(m_l, f.name)
                )
        # return path: publish a trajectory, server acks the row count
        T = np.zeros((int(num_poses[0]), data.d, data.d + 1))
        assert cli.publish_trajectory(0, T) == int(num_poses[0])
        cli.shutdown_server()
        cli.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_frontend_two_process_fleet_solve(tmp_path):
    """Process A serves the dataset; process B (this one) runs the FULL
    fleet protocol against it via ``--frontend`` — every agent's
    pose-graph pull crosses the socket — then publishes the solved
    trajectories back; the server writes them to disk."""
    out_dir = str(tmp_path / "served")
    proc, host, port = _spawn_server("synthetic_grid9", 2, output=out_dir)
    try:
        from dpgo_ros_tpu import cli as cli_mod

        out = str(tmp_path / "sol")
        rc = cli_mod.main([
            "--frontend", f"{host}:{port}",
            "--mode", "fleet",
            "--num_robots", "2",
            "--platform", "cpu",
            "--output", out,
        ])
        assert rc == 0
        # the server-side process received and stored both trajectories
        deadline = time.time() + 10
        want = [
            os.path.join(out_dir, "robot0_trajectory.npy"),
            os.path.join(out_dir, "robot1_trajectory.npy"),
        ]
        while time.time() < deadline and not all(
            os.path.exists(p) for p in want
        ):
            time.sleep(0.1)
        data = load_dataset("synthetic_grid9", num_robots=2)
        for k, p in enumerate(want):
            T = np.load(p)
            assert T.shape == (int(data.num_poses[k]), data.d, data.d + 1)
            assert np.all(np.isfinite(T))
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_frontend_serves_tunnels():
    """The GNC demo's 8-robot world served across the process boundary:
    per-robot slices match the local loader's measurement counts and
    full-data fetch is exact."""
    proc, host, port = _spawn_server("synthetic_gnc8", 8)
    try:
        cli = RemoteDatasetServer(host, port)
        nR, d, num_poses = cli.meta()
        assert nR == 8 and d == 3
        data = load_dataset("synthetic_gnc8", num_robots=8)
        E = len(data.measurements)
        assert E == 3954
        local = DatasetServer(data)
        for k in (0, 3, 7):
            m_r, n_r = cli.request_pose_graph(k)
            m_l, n_l = local.request_pose_graph(k)
            assert n_r == n_l and len(m_r) == len(m_l)
        full = cli.fetch_data()
        assert len(full.measurements) == E
        np.testing.assert_array_equal(full.num_poses, data.num_poses)
        np.testing.assert_allclose(
            full.measurements.R, data.measurements.R
        )
        cli.shutdown_server()
        cli.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)
