"""Test helpers: bundled-format files (g2o, per-robot CSV) written from the
generated worlds, so the parsers are tested without the bundled data."""

import numpy as np

from dpgo_ros_tpu.io.datasets import load_world
from dpgo_ros_tpu.io.g2o import rot_to_quat, write_g2o
from dpgo_ros_tpu.types import EdgeType


def world_g2o(tmp_path, name, **overrides):
    """Write a generated world (one robot: frames are global ids) to g2o."""
    data, T_gt, _ = load_world(name, num_robots=1, **overrides)
    path = str(tmp_path / f"{name}.g2o")
    write_g2o(path, T_gt, data.measurements)
    return path, data, T_gt


def write_robot_csvs(tmp_path, data):
    """Per-robot measurements.csv files in the reference schema: each robot
    lists every measurement it touches (shared edges appear twice)."""
    m = data.measurements
    head = ("robot_src,pose_src,robot_dst,pose_dst,qx,qy,qz,qw,tx,ty,tz,"
            "kappa,tau,is_known_inlier,weight")
    paths = []
    for r in range(data.num_robots):
        rows = []
        for k in np.flatnonzero((m.src_robot == r) | (m.dst_robot == r)):
            q = rot_to_quat(m.R[k])
            rows.append(
                [m.src_robot[k], m.src_frame[k], m.dst_robot[k],
                 m.dst_frame[k], *q, *m.t[k], m.kappa[k], m.tau[k],
                 int(m.edge_type[k] == EdgeType.ODOMETRY), 1.0]
            )
        p = tmp_path / f"robot{r}.csv"
        np.savetxt(p, np.asarray(rows, np.float64), delimiter=",",
                   header=head, comments="", fmt="%.12g")
        paths.append(str(p))
    return paths
