"""LiftedProblem: static-shape device tensors for a multi-robot pose graph.

The device-side analogue of DPGO's ``PoseGraph`` object (SURVEY.md §2.3):
owns the edge tensors, pose-block offsets, and bookkeeping required by the
solvers (numOdometry / numPrivateLoopClosures / numSharedLoopClosures,
active-robot masking, GNC weight state). Unlike the reference — one
``PoseGraph`` per robot process — this container holds the *fleet* problem
with per-robot block structure, which is what an SPMD program wants.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from dpgo_ros_tpu.ops.quadratic import EdgeSet
from dpgo_ros_tpu.types import EdgeType, MeasurementBatch, PoseGraphData


@dataclasses.dataclass
class LiftedProblem:
    """A multi-robot lifted PGO problem with flattened global pose indexing.

    Pose (robot k, frame f) ↦ global index offsets[k] + f. The EdgeSet indices
    use this flattening; ``robot_of_pose`` maps back.
    """

    edges: EdgeSet
    n: int  # total poses
    d: int
    r: int
    num_robots: int
    offsets: np.ndarray  # (num_robots,) int64 — start of each block
    num_poses: np.ndarray  # (num_robots,) int64
    robot_of_pose: np.ndarray  # (n,) int32 — HOST (static structure)
    data: Optional[PoseGraphData] = None
    # host (numpy) mirror of the static edge structure. Host-side prep
    # (robot coloring, telemetry manifests) reads THIS, not ``edges``, so
    # the prep path needs no device-to-host transfer.
    edges_np: Optional[EdgeSet] = None

    @property
    def host_edges(self) -> EdgeSet:
        """Numpy edge mirror for host-side prep (falls back to the device
        arrays — with a d2h cost — for hand-built problems)."""
        return self.edges_np if self.edges_np is not None else self.edges

    @staticmethod
    def from_data(
        data: PoseGraphData,
        r: int = 5,
        dtype=jnp.float64,
        pad_edges_to: Optional[int] = None,
    ) -> "LiftedProblem":
        m = data.measurements
        d = data.d
        offsets = np.zeros((data.num_robots,), np.int64)
        np.cumsum(data.num_poses[:-1], out=offsets[1:])
        src = offsets[m.src_robot] + m.src_frame
        dst = offsets[m.dst_robot] + m.dst_frame
        E = len(m)
        Epad = pad_edges_to or E
        assert Epad >= E

        def pad1(x, fill=0.0):
            out = np.full((Epad,) + x.shape[1:], fill, dtype=x.dtype)
            out[:E] = x
            return out

        is_loop = (m.edge_type != EdgeType.ODOMETRY) & (~m.fixed_weight)
        from dpgo_ros_tpu.ops.quadratic import build_pull_index

        pull = build_pull_index(src, dst, data.total_poses, num_edge_rows=Epad)
        np_dt = np.float64 if dtype == jnp.float64 else np.float32
        edges_np = EdgeSet(
            src=pad1(src.astype(np.int32)),
            dst=pad1(dst.astype(np.int32)),
            R=pad1(m.R).astype(np_dt),
            t=pad1(m.t).astype(np_dt),
            kappa=pad1(m.kappa).astype(np_dt),
            tau=pad1(m.tau).astype(np_dt),
            weight=pad1(m.weight).astype(np_dt),
            mask=np.concatenate(
                [np.ones(E), np.zeros(Epad - E)]
            ).astype(np_dt),
            is_loop=pad1(is_loop.astype(np.float64)).astype(np_dt),
            pull=pull,
        )
        edges = EdgeSet(
            src=jnp.asarray(edges_np.src),
            dst=jnp.asarray(edges_np.dst),
            R=jnp.asarray(edges_np.R, dtype),
            t=jnp.asarray(edges_np.t, dtype),
            kappa=jnp.asarray(edges_np.kappa, dtype),
            tau=jnp.asarray(edges_np.tau, dtype),
            weight=jnp.asarray(edges_np.weight, dtype),
            mask=jnp.asarray(edges_np.mask, dtype),
            is_loop=jnp.asarray(edges_np.is_loop, dtype),
            pull=jnp.asarray(pull),
        )
        robot_of_pose = np.repeat(
            np.arange(data.num_robots, dtype=np.int32), data.num_poses
        )
        return LiftedProblem(
            edges=edges,
            n=data.total_poses,
            d=d,
            r=r,
            num_robots=data.num_robots,
            offsets=offsets,
            num_poses=np.asarray(data.num_poses, np.int64),
            robot_of_pose=robot_of_pose,
            data=data,
            edges_np=edges_np,
        )

    # --- bookkeeping parity with DPGO::PoseGraph (SURVEY.md §2.3) ---

    def num_measurements(self) -> int:
        return int(np.sum(np.asarray(self.edges.mask) > 0))

    def counts_by_type(self) -> Tuple[int, int, int]:
        assert self.data is not None
        return self.data.counts_by_type()

    def block_mask(self, robot_id: int, dtype=jnp.float64) -> jnp.ndarray:
        """(n, 1, 1) mask selecting robot_id's pose block — the RBCD
        'only my block moves' projector."""
        m = jnp.asarray(
            (np.asarray(self.robot_of_pose) == robot_id), dtype
        )
        return m[:, None, None]

    def pose_block(self, X: jnp.ndarray, robot_id: int) -> jnp.ndarray:
        o = int(self.offsets[robot_id])
        return X[o : o + int(self.num_poses[robot_id])]

    def global_trajectory(self, data: PoseGraphData) -> Optional[np.ndarray]:
        """Stack per-robot initial-guess trajectories into (n, d, d+1)."""
        if data.initial_guess is None:
            return None
        return np.concatenate(
            [data.initial_guess[k] for k in range(data.num_robots)], axis=0
        )

    def separator_mask(self, dtype=jnp.float64) -> jnp.ndarray:
        """(n,) mask of poses touched by inter-robot edges — the 'public
        poses' the reference exchanges between robots (``msg/PublicPoses.msg``,
        SURVEY.md §2.2). Used for communication-volume telemetry."""
        rop = jnp.asarray(self.robot_of_pose)
        src_r = rop[self.edges.src]
        dst_r = rop[self.edges.dst]
        shared = (src_r != dst_r) & (self.edges.mask > 0)
        m = jnp.zeros((self.n,), dtype)
        m = m.at[self.edges.src].max(shared.astype(dtype))
        m = m.at[self.edges.dst].max(shared.astype(dtype))
        return m
