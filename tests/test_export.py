"""Export / visualization layer tests (rviz-replacement, SURVEY.md §1-L7)."""

import json
import os

import numpy as np

from dpgo_ros_tpu.io.datasets import load_dataset
from dpgo_ros_tpu.io.g2o import read_g2o
from dpgo_ros_tpu.utils import export
from dpgo_ros_tpu.utils.telemetry import public_poses_msg_bytes


def test_export_solution_files(tmp_path):
    data = load_dataset("synthetic_grid9", num_robots=2)
    n = data.total_poses
    T = np.zeros((n, 3, 4))
    T[:, :, :3] = np.eye(3)
    T[:, :, 3] = np.cumsum(np.ones((n, 3)) * 0.5, axis=0)
    w = np.ones(len(data.measurements))
    w[-1] = 0.0
    prefix = str(tmp_path / "sol")
    export.export_solution(prefix, T, data.num_poses, data.measurements, w)
    assert os.path.exists(prefix + "_global.g2o")
    assert os.path.exists(prefix + "_robot0.tum")
    assert os.path.exists(prefix + "_robot1.tum")
    assert os.path.exists(prefix + "_loops.json")
    assert os.path.exists(prefix + ".html")
    # g2o round-trips
    m2, n2, v2 = read_g2o(prefix + "_global.g2o")
    assert n2 == n
    # TUM line count
    with open(prefix + "_robot0.tum") as f:
        assert len(f.readlines()) == int(data.num_poses[0])
    # loop report consistency
    rep = json.load(open(prefix + "_loops.json"))
    assert (
        rep["accept_loop_closures"]
        + rep["reject_loop_closures"]
        + rep["undecided_loop_closures"]
        == len(rep["edges"])
    )
    # html mentions robots and loop classes
    html = open(prefix + ".html").read()
    assert "robot0" in html and "accepted" in html and "<svg" in html


def test_public_poses_msg_size_positive():
    assert public_poses_msg_bytes(10, r=5, d=3) > 10 * 5 * 4 * 8


def test_show_loops_gates_html_overlay(tmp_path):
    """``show_loops=False`` (reference ``visualize_loop_closures`` false,
    ``PGOAgent.launch:42``) omits the loop-closure polylines from the HTML
    while leaving the g2o/TUM/JSON dumps untouched."""
    data = load_dataset("synthetic_grid9", num_robots=2)
    n = data.total_poses
    T = np.zeros((n, 3, 4))
    T[:, :, :3] = np.eye(3)
    T[:, :, 3] = np.cumsum(np.ones((n, 3)) * 0.5, axis=0)
    w = np.ones(len(data.measurements))
    w[-1] = 0.0  # one rejected loop
    on = str(tmp_path / "on")
    off = str(tmp_path / "off")
    export.export_solution(on, T, data.num_poses, data.measurements, w,
                           show_loops=True)
    export.export_solution(off, T, data.num_poses, data.measurements, w,
                           show_loops=False)
    h_on = open(on + ".html").read()
    h_off = open(off + ".html").read()
    # rejected-loop stroke (#d62728) appears as a polyline only when on
    assert h_on.count('stroke="#d62728"') > 0
    assert h_off.count('stroke="#d62728"') == 0
    # report still written in both cases
    assert os.path.exists(off + "_loops.json")
