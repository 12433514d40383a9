"""Core data types for the distributed pose-graph-optimization framework.

Capability parity targets (see SURVEY.md §2.3): the reference framework's
``DPGO::RelativeSEMeasurement {r1,r2,p1,p2,R,t,kappa,tau,weight,fixedWeight}``
(reference ``src/utils.cpp:128-152``) and ``PoseID {robot_id, frame_id}``
(reference ``include/dpgo_ros/PGOAgentROS.h:189``).

Design note: measurements are stored struct-of-arrays with static
shapes so the whole problem lowers to XLA with no per-edge Python objects.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple

import numpy as np


class EdgeType(enum.IntEnum):
    """Edge classification, mirroring the reference's partitioning semantics.

    Reference: ``src/PGODatasetPublisherNode.cpp:108-135`` classifies each
    measurement as odometry (same robot, consecutive frames), private loop
    closure (same robot, non-consecutive), or shared loop closure
    (different robots).
    """

    ODOMETRY = 0
    PRIVATE_LOOP_CLOSURE = 1
    SHARED_LOOP_CLOSURE = 2


@dataclasses.dataclass
class MeasurementBatch:
    """A batch of relative SE(d) measurements in struct-of-arrays layout.

    Each row k encodes the relative measurement ``(R_k, t_k)`` from pose
    ``(src_robot[k], src_frame[k])`` to pose ``(dst_robot[k], dst_frame[k])``
    with concentration parameters ``kappa`` (rotation) and ``tau``
    (translation), plus a robust weight and fixed-weight flag — the same
    fields as the reference's ``RelativeSEMeasurement``
    (``src/utils.cpp:128-152``).

    Convention (SE-Sync / DPGO): ``R_dst ≈ R_src @ R`` and
    ``t_dst ≈ t_src + R_src @ t``.
    """

    src_robot: np.ndarray  # (E,) int32
    src_frame: np.ndarray  # (E,) int32
    dst_robot: np.ndarray  # (E,) int32
    dst_frame: np.ndarray  # (E,) int32
    R: np.ndarray  # (E, d, d) float
    t: np.ndarray  # (E, d) float
    kappa: np.ndarray  # (E,) float
    tau: np.ndarray  # (E,) float
    weight: np.ndarray  # (E,) float, robust weight in [0, 1]
    fixed_weight: np.ndarray  # (E,) bool — True ⇒ weight never updated by GNC
    edge_type: np.ndarray  # (E,) int32 of EdgeType

    def __len__(self) -> int:
        return int(self.src_robot.shape[0])

    @property
    def dim(self) -> int:
        return int(self.R.shape[-1])

    def select(self, mask: np.ndarray) -> "MeasurementBatch":
        """Return the sub-batch where ``mask`` is True (host-side op)."""
        return MeasurementBatch(
            **{
                f.name: getattr(self, f.name)[mask]
                for f in dataclasses.fields(self)
            }
        )

    def concat(self, other: "MeasurementBatch") -> "MeasurementBatch":
        return MeasurementBatch(
            **{
                f.name: np.concatenate(
                    [getattr(self, f.name), getattr(other, f.name)], axis=0
                )
                for f in dataclasses.fields(self)
            }
        )

    @staticmethod
    def empty(d: int = 3, dtype=np.float64) -> "MeasurementBatch":
        return MeasurementBatch(
            src_robot=np.zeros((0,), np.int32),
            src_frame=np.zeros((0,), np.int32),
            dst_robot=np.zeros((0,), np.int32),
            dst_frame=np.zeros((0,), np.int32),
            R=np.zeros((0, d, d), dtype),
            t=np.zeros((0, d), dtype),
            kappa=np.zeros((0,), dtype),
            tau=np.zeros((0,), dtype),
            weight=np.zeros((0,), dtype),
            fixed_weight=np.zeros((0,), bool),
            edge_type=np.zeros((0,), np.int32),
        )


@dataclasses.dataclass
class PoseGraphData:
    """A (possibly multi-robot) pose graph: measurements + per-robot pose counts.

    ``num_poses[k]`` is the number of poses owned by robot ``k``; frames are
    local indices ``0..num_poses[k]-1`` (reference local-ID convention,
    ``src/PGODatasetPublisherNode.cpp:92-103``).
    """

    measurements: MeasurementBatch
    num_poses: np.ndarray  # (num_robots,) int64
    d: int = 3
    # Optional ground-truth / initial-guess trajectory per robot, in the
    # global frame of the source file: dict robot -> (n_k, d, d+1) [R | t].
    initial_guess: Optional[Dict[int, np.ndarray]] = None

    @property
    def num_robots(self) -> int:
        return int(len(self.num_poses))

    @property
    def total_poses(self) -> int:
        return int(np.sum(self.num_poses))

    def counts_by_type(self) -> Tuple[int, int, int]:
        et = self.measurements.edge_type
        return (
            int(np.sum(et == EdgeType.ODOMETRY)),
            int(np.sum(et == EdgeType.PRIVATE_LOOP_CLOSURE)),
            int(np.sum(et == EdgeType.SHARED_LOOP_CLOSURE)),
        )

    def robot_measurements(self, robot_id: int) -> MeasurementBatch:
        """All measurements involving ``robot_id`` (reference: a robot stores
        odometry + private LCs + every shared LC it participates in,
        ``src/PGOAgentROS.cpp:262-281``)."""
        m = self.measurements
        mask = (m.src_robot == robot_id) | (m.dst_robot == robot_id)
        return m.select(mask)


# Enum parity with the reference wire protocol -------------------------------


class AgentState(enum.IntEnum):
    """Per-robot lifecycle state (reference ``msg/Status.msg`` and
    ``DPGO::PGOAgentState``; values must agree — tested like
    ``tests/testUtils.cpp:54-70``)."""

    WAIT_FOR_DATA = 0
    WAIT_FOR_INITIALIZATION = 1
    INITIALIZED = 2


class CommandType(enum.IntEnum):
    """Control-plane commands (reference ``msg/Command.msg``)."""

    REQUEST_POSE_GRAPH = 0
    UPDATE = 1
    TERMINATE = 2
    HARD_TERMINATE = 3
    INITIALIZE = 4
    UPDATE_WEIGHT = 5
    RECOVER = 6
    SET_ACTIVE_ROBOTS = 7
    NOOP = 8


@dataclasses.dataclass
class AgentStatus:
    """Per-robot heartbeat + convergence telemetry (reference
    ``msg/Status.msg`` / ``PGOAgentStatus``, ``src/utils.cpp:262-281``)."""

    robot_id: int
    cluster_id: int = 0
    state: AgentState = AgentState.WAIT_FOR_DATA
    instance_number: int = 0
    iteration_number: int = 0
    ready_to_terminate: bool = False
    relative_change: float = float("inf")
