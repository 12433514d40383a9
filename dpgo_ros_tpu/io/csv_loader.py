"""Per-robot ``measurements.csv`` loader.

Replaces the reference's ``PGOLogger::loadMeasurements`` path
(``src/PGODatasetPublisherNode.cpp:161-177``). Schema (see
the reference's ``data/tunnels/robot0/measurements.csv``)::

  robot_src,pose_src,robot_dst,pose_dst,qx,qy,qz,qw,tx,ty,tz,kappa,tau,
  is_known_inlier,weight
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from dpgo_ros_tpu.io.g2o import _quat_to_rot
from dpgo_ros_tpu.types import EdgeType, MeasurementBatch, PoseGraphData


def load_measurements_csv(path: str) -> MeasurementBatch:
    """Load one robot's measurement CSV into a MeasurementBatch.

    ``is_known_inlier`` maps to ``fixed_weight`` (a known-inlier edge keeps
    weight 1 under GNC, exactly the reference's fixedWeight semantics,
    ``src/utils.cpp:141-149``). Uses the native C++ parser when available
    (``DPGO_TPU_NO_NATIVE=1`` forces the Python path).
    """
    import os

    if os.environ.get("DPGO_TPU_NO_NATIVE") != "1":
        from dpgo_ros_tpu.io import native

        m = native.read_csv_native(path) if native.available() else None
        if m is not None and len(m) > 0:
            return m
    raw = np.genfromtxt(path, delimiter=",", names=True, dtype=np.float64)
    raw = np.atleast_1d(raw)
    E = raw.shape[0]
    R = np.stack(
        [
            _quat_to_rot(row["qx"], row["qy"], row["qz"], row["qw"])
            for row in raw
        ],
        axis=0,
    )
    t = np.stack([raw["tx"], raw["ty"], raw["tz"]], axis=-1)
    src_robot = raw["robot_src"].astype(np.int32)
    dst_robot = raw["robot_dst"].astype(np.int32)
    src_frame = raw["pose_src"].astype(np.int32)
    dst_frame = raw["pose_dst"].astype(np.int32)
    from dpgo_ros_tpu.io.partition import classify_edge_types

    edge_type = classify_edge_types(src_robot, src_frame, dst_robot, dst_frame)
    return MeasurementBatch(
        src_robot=src_robot,
        src_frame=src_frame,
        dst_robot=dst_robot,
        dst_frame=dst_frame,
        R=R,
        t=t,
        kappa=raw["kappa"].astype(np.float64),
        tau=raw["tau"].astype(np.float64),
        weight=raw["weight"].astype(np.float64),
        fixed_weight=raw["is_known_inlier"].astype(bool)
        | (edge_type == EdgeType.ODOMETRY),
        edge_type=edge_type,
    )


def load_multi_robot_csv(
    paths: Sequence[str], dedup_shared: bool = True
) -> PoseGraphData:
    """Load a fleet's CSVs (e.g. ``tunnels/robot0..7``) into one PoseGraphData.

    Each robot's file lists all measurements it knows about; a shared loop
    closure appears in both endpoint files, so we de-duplicate by
    (src_robot, src_frame, dst_robot, dst_frame), keeping the copy from the
    lower-ID robot (the reference's weight-owner convention,
    ``src/PGOAgentROS.cpp:732,1340``).
    """
    batch: Optional[MeasurementBatch] = None
    for p in paths:
        b = load_measurements_csv(p)
        batch = b if batch is None else batch.concat(b)
    assert batch is not None, "no measurement files given"

    if dedup_shared:
        keys = {}
        keep = np.ones(len(batch), dtype=bool)
        for k in range(len(batch)):
            key = (
                int(batch.src_robot[k]),
                int(batch.src_frame[k]),
                int(batch.dst_robot[k]),
                int(batch.dst_frame[k]),
            )
            if key in keys:
                keep[k] = False
            else:
                keys[key] = k
        batch = batch.select(keep)

    num_robots = int(max(batch.src_robot.max(), batch.dst_robot.max())) + 1
    num_poses = np.zeros((num_robots,), np.int64)
    for k in range(len(batch)):
        r1, f1 = int(batch.src_robot[k]), int(batch.src_frame[k])
        r2, f2 = int(batch.dst_robot[k]), int(batch.dst_frame[k])
        num_poses[r1] = max(num_poses[r1], f1 + 1)
        num_poses[r2] = max(num_poses[r2], f2 + 1)
    return PoseGraphData(measurements=batch, num_poses=num_poses, d=3)
