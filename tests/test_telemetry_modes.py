"""Per-iteration CSV telemetry parity in EVERY run mode.

The reference writes the 9-column per-agent CSV + event rows for every run
(``src/PGOAgentROS.cpp:853-907``, per-agent dirs at ``:1017-1022``); here
``--log_directory`` must produce the same schema from engine, fused, spmd
and async runs (fleet/agent mode already wires IterationLogger directly).
"""

import csv
import glob
import os

import numpy as np
import pytest

from dpgo_ros_tpu.cli import main
from dpgo_ros_tpu.utils.telemetry import HEADER

BASE = [
    "--dataset", "synthetic_grid9", "--num_robots", "2",
    "--platform", "cpu", "--update_rule", "RoundRobin",
    "--local_initialization_method", "Odometry",
    "--max_iteration_number", "6",
    "--relative_change_tolerance", "0",
]


def _read_agent_logs(log_dir, num_robots=2):
    """Returns {robot_id: (data_rows, event_rows)} and checks the header."""
    out = {}
    for k in range(num_robots):
        paths = glob.glob(os.path.join(log_dir, f"agent{k}", "*.csv"))
        assert paths, f"no CSV for agent{k} under {log_dir}"
        with open(paths[0]) as f:
            lines = [ln.rstrip("\n") for ln in f]
        assert lines[0] == HEADER
        data, events = [], []
        for ln in lines[1:]:
            parts = ln.split(",")
            if len(parts) == len(HEADER.split(",")):
                data.append(parts)
            else:
                events.append(parts)
        out[k] = (data, events)
    return out


def _check_rows(rows, robot_id):
    ncol = len(HEADER.split(","))
    for row in rows:
        assert len(row) == ncol
        assert int(row[0]) == robot_id
        assert int(row[3]) >= 1  # iteration
        assert int(row[4]) > 0  # num_poses
        assert int(row[5]) > 0  # bytes_received
        float(row[6])  # iter_time_sec parses
        float(row[8])  # rel_change parses


@pytest.mark.parametrize("mode", ["engine", "fused"])
def test_engine_and_fused_mode_write_reference_schema(tmp_path, mode):
    log_dir = str(tmp_path / mode)
    assert main(BASE + ["--mode", mode, "--log_directory", log_dir]) == 0
    logs = _read_agent_logs(log_dir)
    for k, (data, events) in logs.items():
        assert len(data) == 6
        _check_rows(data, k)
        # terminal event row like the reference logString
        assert any(e[1] == "TERMINATE" for e in events)


def test_spmd_mode_writes_reference_schema(tmp_path):
    log_dir = str(tmp_path / "spmd")
    assert main(BASE + ["--mode", "spmd", "--log_directory", log_dir]) == 0
    logs = _read_agent_logs(log_dir)
    for k, (data, events) in logs.items():
        assert len(data) == 6
        _check_rows(data, k)


def test_async_mode_writes_reference_schema(tmp_path):
    log_dir = str(tmp_path / "async")
    args = BASE + [
        "--mode", "async", "--log_directory", log_dir,
        "--max_iteration_number", "8",
        "--asapp_tolerance", "0",  # no early stop: exactly 8 ticks
    ]
    assert main(args) == 0
    logs = _read_agent_logs(log_dir)
    for k, (data, events) in logs.items():
        assert len(data) == 8  # one row per tick
        _check_rows(data, k)


@pytest.mark.slow
def test_gnc_event_rows_interleaved(tmp_path):
    """UPDATE_WEIGHT event rows appear at weight-round iterations (engine +
    fused agree on positions; reference logString interleaving)."""
    positions = {}
    for mode in ("engine", "fused"):
        log_dir = str(tmp_path / ("gnc_" + mode))
        args = [
            "--dataset", "synthetic_grid125", "--num_robots", "2",
            "--platform", "cpu", "--update_rule", "RoundRobin",
            "--local_initialization_method", "Odometry",
            "--robust_cost_type", "GNC_TLS",
            "--robust_opt_num_weight_updates", "2",
            "--robust_opt_inner_iters_per_robot", "2",
            "--max_iteration_number", "12",
            "--relative_change_tolerance", "0",
            "--mode", mode, "--log_directory", log_dir,
        ]
        assert main(args) == 0
        paths = glob.glob(os.path.join(log_dir, "agent0", "*.csv"))
        with open(paths[0]) as f:
            lines = [ln.rstrip("\n") for ln in f]
        pos = [
            i for i, ln in enumerate(lines)
            if ln.split(",")[1:2] == ["UPDATE_WEIGHT"]
        ]
        assert pos, f"no UPDATE_WEIGHT rows in {mode} log"
        positions[mode] = pos
    assert positions["engine"] == positions["fused"]
