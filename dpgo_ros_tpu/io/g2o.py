"""g2o pose-graph file reader/writer.

Replaces the reference's ``DPGO::read_g2o_file`` (called at
``src/PGODatasetPublisherNode.cpp:80``), which follows the SE-Sync convention
for extracting isotropic concentration parameters (kappa, tau) from the g2o
information matrix.

Format (see the reference's ``data/tinyGrid3D.g2o``):
  ``VERTEX_SE3:QUAT id x y z qx qy qz qw``
  ``EDGE_SE3:QUAT i j tx ty tz qx qy qz qw  <21 upper-triangular 6x6 info>``
and the 2D variants ``VERTEX_SE2`` / ``EDGE_SE2``.

The information-matrix ordering for EDGE_SE3:QUAT is [translation; rotation].
SE-Sync extracts::

  tau   = 3 / (1/I11 + 1/I22 + 1/I33)          (translational precision)
  kappa = 3 / (2 * (1/I44 + 1/I55 + 1/I66))     (rotational concentration)

This is a pure NumPy host-side loader — parsing is not on the hot path; the
result feeds static-shape device tensors.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from dpgo_ros_tpu.types import EdgeType, MeasurementBatch


def _quat_to_rot(qx: float, qy: float, qz: float, qw: float) -> np.ndarray:
    """Unit quaternion (x, y, z, w) -> 3x3 rotation matrix."""
    q = np.array([qx, qy, qz, qw], dtype=np.float64)
    n = np.linalg.norm(q)
    if n == 0:
        return np.eye(3)
    x, y, z, w = q / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> unit quaternion (x, y, z, w)."""
    m = np.asarray(R, dtype=np.float64)
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w], dtype=np.float64)


def read_g2o(
    path: str,
) -> Tuple[MeasurementBatch, int, Optional[Dict[int, np.ndarray]]]:
    """Parse a g2o file.

    Returns ``(measurements, num_poses, vertices)`` where measurements carry
    global pose ids in ``src_frame``/``dst_frame`` (robot ids are all 0 until
    partitioning) and ``vertices`` maps pose id -> (d, d+1) [R | t] matrix (or
    None if the file has no VERTEX lines). ``num_poses`` is
    ``max(pose id seen) + 1``, matching the reference's
    ``read_g2o_file(filename, num_poses)`` contract
    (``src/PGODatasetPublisherNode.cpp:80-83``).

    Uses the native C++ parser (native/g2o_parser.cpp, 3D files only) when
    available; set ``DPGO_TPU_NO_NATIVE=1`` to force the Python path.
    """
    if os.environ.get("DPGO_TPU_NO_NATIVE") != "1":
        from dpgo_ros_tpu.io import native

        if native.available():
            out = native.read_g2o_native(path)
            if out is not None and (len(out[0]) > 0 or out[2] is not None):
                return out
    src, dst = [], []
    Rs, ts, kappas, taus = [], [], [], []
    vertices: Dict[int, np.ndarray] = {}
    d = 3
    max_id = -1

    with open(path, "r") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            tag = tok[0]
            if tag == "EDGE_SE3:QUAT":
                i, j = int(tok[1]), int(tok[2])
                vals = [float(v) for v in tok[3:]]
                tx, ty, tz, qx, qy, qz, qw = vals[:7]
                info = vals[7:28]  # 21 upper-triangular entries of 6x6
                I11, I22, I33 = info[0], info[6], info[11]
                I44, I55, I66 = info[15], info[18], info[20]
                tau = 3.0 / (1.0 / I11 + 1.0 / I22 + 1.0 / I33)
                kappa = 3.0 / (2.0 * (1.0 / I44 + 1.0 / I55 + 1.0 / I66))
                src.append(i)
                dst.append(j)
                Rs.append(_quat_to_rot(qx, qy, qz, qw))
                ts.append([tx, ty, tz])
                kappas.append(kappa)
                taus.append(tau)
                max_id = max(max_id, i, j)
            elif tag == "VERTEX_SE3:QUAT":
                i = int(tok[1])
                x, y, z, qx, qy, qz, qw = (float(v) for v in tok[2:9])
                T = np.zeros((3, 4), dtype=np.float64)
                T[:, :3] = _quat_to_rot(qx, qy, qz, qw)
                T[:, 3] = [x, y, z]
                vertices[i] = T
                max_id = max(max_id, i)
            elif tag == "EDGE_SE2":
                d = 2
                i, j = int(tok[1]), int(tok[2])
                dx, dy, dth = (float(v) for v in tok[3:6])
                I11, I12, I13, I22, I23, I33 = (float(v) for v in tok[6:12])
                tau = 2.0 / (1.0 / I11 + 1.0 / I22)
                kappa = I33
                c, s = np.cos(dth), np.sin(dth)
                src.append(i)
                dst.append(j)
                Rs.append(np.array([[c, -s], [s, c]]))
                ts.append([dx, dy])
                kappas.append(kappa)
                taus.append(tau)
                max_id = max(max_id, i, j)
            elif tag == "VERTEX_SE2":
                d = 2
                i = int(tok[1])
                x, y, th = (float(v) for v in tok[2:5])
                c, s = np.cos(th), np.sin(th)
                T = np.array([[c, -s, x], [s, c, y]], dtype=np.float64)
                vertices[i] = T
                max_id = max(max_id, i)

    E = len(src)
    m = MeasurementBatch(
        src_robot=np.zeros((E,), np.int32),
        src_frame=np.asarray(src, np.int32),
        dst_robot=np.zeros((E,), np.int32),
        dst_frame=np.asarray(dst, np.int32),
        R=np.stack(Rs, axis=0) if E else np.zeros((0, d, d)),
        t=np.asarray(ts, np.float64) if E else np.zeros((0, d)),
        kappa=np.asarray(kappas, np.float64),
        tau=np.asarray(taus, np.float64),
        weight=np.ones((E,), np.float64),
        fixed_weight=np.zeros((E,), bool),
        edge_type=np.zeros((E,), np.int32),  # classified during partitioning
    )
    return m, max_id + 1, (vertices if vertices else None)


def write_g2o(path: str, trajectory: np.ndarray, measurements=None) -> None:
    """Write a trajectory (n, d, d+1) — and optionally its measurements — to g2o.

    Counterpart of the reference's rviz-based trajectory output
    (``src/PGOAgentROS.cpp:629-642``); files are the framework's
    visualization/export interchange format.
    """
    traj = np.asarray(trajectory)
    d = traj.shape[1]
    with open(path, "w") as f:
        for i in range(traj.shape[0]):
            R, t = traj[i, :, :d], traj[i, :, d]
            if d == 3:
                qx, qy, qz, qw = rot_to_quat(R)
                f.write(
                    f"VERTEX_SE3:QUAT {i} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                    f"{qx:.9f} {qy:.9f} {qz:.9f} {qw:.9f}\n"
                )
            else:
                th = np.arctan2(R[1, 0], R[0, 0])
                f.write(f"VERTEX_SE2 {i} {t[0]:.9f} {t[1]:.9f} {th:.9f}\n")
        if measurements is not None:
            mb = measurements
            for k in range(len(mb)):
                i, j = int(mb.src_frame[k]), int(mb.dst_frame[k])
                t = mb.t[k]
                if d == 3:
                    qx, qy, qz, qw = rot_to_quat(mb.R[k])
                    # isotropic information from kappa/tau (inverse of the
                    # SE-Sync extraction above)
                    It, Ir = mb.tau[k], 2.0 * mb.kappa[k]
                    info = np.zeros(21)
                    info[0], info[6], info[11] = It, It, It
                    info[15], info[18], info[20] = Ir, Ir, Ir
                    f.write(
                        f"EDGE_SE3:QUAT {i} {j} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                        f"{qx:.9f} {qy:.9f} {qz:.9f} {qw:.9f} "
                        + " ".join(f"{v:.6f}" for v in info)
                        + "\n"
                    )
