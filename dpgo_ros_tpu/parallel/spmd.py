"""Multi-chip SPMD distributed PGO: pose blocks sharded over a device mesh.

This is the device-mesh replacement for the reference's per-robot ROS
processes and TCPROS topics (SURVEY.md §1-L3, §5.8): one robot block per mesh
slot along a ``robots`` axis; the separator-pose exchange
(``msg/PublicPoses.msg``) becomes a single ``all_gather`` across the mesh; GNC
weight replication (``msg/RelativeMeasurementWeights.msg``) is implicit —
every device recomputes identical weights from the gathered state; and
termination gossip (``msg/Status.msg``) is a ``psum`` of per-robot
relative-change flags.

Layout: with M mesh slots and per-robot padding n_max,
  * ``X_block``  (M, n_max, r, d+1)  — sharded along ``robots``
  * edge tensors (M, E_max, ...)      — each device holds every edge incident
    to its block (odometry + private + its copies of shared LCs), with
    endpoint indices in *global padded* coordinates robot·n_max + frame.

Each step: all_gather X → masked local trust-region solve (the mask selects
the device's own block ∩ the active color class; a color class's joint
Hessian is block-diagonal so the masked solve IS the independent per-robot
solves) → keep own block. All control flow is jit-compatible; one XLA
program per step, no host round-trips.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dpgo_ros_tpu.models.local_solvers import RTRParams, rtr_solve
from dpgo_ros_tpu.models.problem import LiftedProblem
from dpgo_ros_tpu.models import robust
from dpgo_ros_tpu.ops import quadratic, rounding, stiefel
from dpgo_ros_tpu.ops.quadratic import EdgeSet
from dpgo_ros_tpu.utils.config import AgentConfig, RobustCostType


def group_robots(data, num_groups: int):
    """Remap a fleet onto ``num_groups`` "super-robots" (contiguous robot
    ranges) so a fleet larger than the mesh fits: each device owns one group
    and its masked solve jointly optimizes the whole group's poses (a larger
    block — strictly better conditioning than per-robot updates).

    Returns a new PoseGraphData with robots relabeled to groups.
    """
    import numpy as _np

    from dpgo_ros_tpu.types import EdgeType, MeasurementBatch, PoseGraphData

    nR = data.num_robots
    assert 1 <= num_groups <= nR
    per = nR // num_groups
    group_of = _np.minimum(_np.arange(nR) // per, num_groups - 1)
    # frame offset of each original robot within its group
    frame_off = _np.zeros(nR, _np.int64)
    for g in range(num_groups):
        members = _np.where(group_of == g)[0]
        off = 0
        for m in members:
            frame_off[m] = off
            off += int(data.num_poses[m])
    mb = data.measurements
    src_robot = group_of[mb.src_robot].astype(_np.int32)
    dst_robot = group_of[mb.dst_robot].astype(_np.int32)
    src_frame = (frame_off[mb.src_robot] + mb.src_frame).astype(_np.int32)
    dst_frame = (frame_off[mb.dst_robot] + mb.dst_frame).astype(_np.int32)
    same = src_robot == dst_robot
    # standard classification in group coordinates: consecutive same-group
    # edges are odometry (this heals odometry chains across original-robot
    # boundaries inside a group — crucial for odometry initialization)
    odo = same & (src_frame + 1 == dst_frame) & (
        mb.edge_type != EdgeType.PRIVATE_LOOP_CLOSURE
    )
    et = _np.where(
        odo,
        EdgeType.ODOMETRY,
        _np.where(
            same, EdgeType.PRIVATE_LOOP_CLOSURE, EdgeType.SHARED_LOOP_CLOSURE
        ),
    ).astype(_np.int32)
    grouped = MeasurementBatch(
        src_robot=src_robot,
        src_frame=src_frame,
        dst_robot=dst_robot,
        dst_frame=dst_frame,
        R=mb.R,
        t=mb.t,
        kappa=mb.kappa,
        tau=mb.tau,
        weight=mb.weight,
        fixed_weight=mb.fixed_weight | (et == EdgeType.ODOMETRY),
        edge_type=et,
    )
    num_poses = _np.array(
        [
            int(sum(data.num_poses[m] for m in _np.where(group_of == g)[0]))
            for g in range(num_groups)
        ],
        _np.int64,
    )
    return PoseGraphData(
        measurements=grouped, num_poses=num_poses, d=data.d,
        initial_guess=None,
    )


def repartition_slots(data, num_slots: int):
    """Work-balanced contiguous re-partition of the GLOBAL pose sequence
    into ``num_slots`` slot blocks — SPLITS hot robots across mesh slots
    and co-schedules cold ones.

    Dataset-fixed fleets (tunnels' per-robot CSV split,
    ``params/robot_measurements.yaml``) pin the robot partition, so
    ``--partition_balance work`` cannot help and the hottest robot bounds
    the mesh step (tunnels@8 work skew 1.29 → projected efficiency 0.76,
    from a lane-cost model of the work). The mesh does not care about robot identity — a
    slot's masked block solve is correct for ANY contiguous pose range —
    so this rebalances the slot boundaries directly: per-pose work
    density = 1 + deg/2 (the lane-cost model above), cut at the
    work quantiles. The measurement set is unchanged (labels only), so
    costs are partition-invariant; cross-slot edges become shared
    (separator) loop closures exactly as in :func:`group_robots`.

    Returns a new PoseGraphData with ``num_slots`` relabeled robots.
    """
    import numpy as _np

    from dpgo_ros_tpu.types import EdgeType, MeasurementBatch, PoseGraphData

    nR = data.num_robots
    num_poses = _np.asarray(data.num_poses, _np.int64)
    offs = _np.concatenate([[0], _np.cumsum(num_poses)])
    n = int(offs[-1])
    assert 1 <= num_slots <= n
    mb = data.measurements
    gsrc = offs[mb.src_robot] + mb.src_frame
    gdst = offs[mb.dst_robot] + mb.dst_frame
    # per-pose work density (lane-cost model: a block owns
    # the edges whose SRC pose it holds): 1 + #edges sourced at the pose
    w = _np.ones(n, _np.float64)
    _np.add.at(w, gsrc, 1.0)
    # min-max contiguous partition: binary-search the block capacity,
    # greedy-fill blocks (the classic linear-partition scheme — quantile
    # cuts overshoot when a few poses carry heavy loop-closure fan-out)
    cw = _np.concatenate([[0.0], _np.cumsum(w)])

    def blocks_for(cap):
        bounds = [0]
        while bounds[-1] < n:
            s = bounds[-1]
            # furthest e with sum(w[s:e]) <= cap, at least one pose
            e = int(_np.searchsorted(cw, cw[s] + cap, side="right")) - 1
            e = max(e, s + 1)
            bounds.append(min(e, n))
        return bounds

    lo, hi = float(w.max()), float(w.sum())
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if len(blocks_for(mid)) - 1 <= num_slots:
            hi = mid
        else:
            lo = mid
    bounds = blocks_for(hi)
    # greedy may use fewer blocks than slots: split the heaviest blocks
    while len(bounds) - 1 < num_slots:
        loads = [
            cw[bounds[k + 1]] - cw[bounds[k]]
            for k in range(len(bounds) - 1)
        ]
        k = int(_np.argmax(
            [ld if bounds[i + 1] - bounds[i] > 1 else -1.0
             for i, ld in enumerate(loads)]
        ))
        mid_w = 0.5 * (cw[bounds[k]] + cw[bounds[k + 1]])
        cut = int(_np.searchsorted(cw, mid_w))
        cut = min(max(cut, bounds[k] + 1), bounds[k + 1] - 1)
        bounds.insert(k + 1, cut)
    bounds = _np.asarray(bounds, _np.int64)
    slot_of = (
        _np.searchsorted(bounds, _np.arange(n), side="right") - 1
    ).astype(_np.int32)
    start_of = bounds[:-1]
    src_robot = slot_of[gsrc]
    dst_robot = slot_of[gdst]
    src_frame = (gsrc - start_of[src_robot]).astype(_np.int32)
    dst_frame = (gdst - start_of[dst_robot]).astype(_np.int32)
    same = src_robot == dst_robot
    odo = same & (gsrc + 1 == gdst) & (
        mb.edge_type != EdgeType.PRIVATE_LOOP_CLOSURE
    )
    et = _np.where(
        odo,
        EdgeType.ODOMETRY,
        _np.where(
            same, EdgeType.PRIVATE_LOOP_CLOSURE, EdgeType.SHARED_LOOP_CLOSURE
        ),
    ).astype(_np.int32)
    out = MeasurementBatch(
        src_robot=src_robot,
        src_frame=src_frame,
        dst_robot=dst_robot,
        dst_frame=dst_frame,
        R=mb.R,
        t=mb.t,
        kappa=mb.kappa,
        tau=mb.tau,
        weight=mb.weight,
        fixed_weight=mb.fixed_weight | (et == EdgeType.ODOMETRY),
        edge_type=et,
    )
    return PoseGraphData(
        measurements=out,
        num_poses=(bounds[1:] - bounds[:-1]).astype(_np.int64),
        d=data.d,
        initial_guess=getattr(data, "initial_guess", None),
    )


@dataclasses.dataclass
class ShardedProblem:
    """Host-side container of the per-device tensors (numpy, pre-sharding)."""

    X0: np.ndarray  # (M, n_max, r, d+1)
    src: np.ndarray  # (M, E_max) int32, global padded indices
    dst: np.ndarray  # (M, E_max)
    R: np.ndarray  # (M, E_max, d, d)
    t: np.ndarray  # (M, E_max, d)
    kappa: np.ndarray  # (M, E_max)
    tau: np.ndarray  # (M, E_max)
    weight: np.ndarray  # (M, E_max)
    mask: np.ndarray  # (M, E_max)
    is_loop: np.ndarray  # (M, E_max)
    gidx: np.ndarray  # (M, E_max) int32 global edge id (-1 on padding) —
    # lets callers scatter per-device GNC weights back onto the global edge
    # list (shared edges are replicated; every copy computes identical
    # weights from the identical gathered state)
    pose_valid: np.ndarray  # (M, n_max) 1.0 for real poses
    color: np.ndarray  # (M,) color class of each robot
    num_colors: int
    n_max: int
    M: int
    r: int
    d: int
    # separator-pose exchange support (round 5): per-slot LOCAL indices of
    # poses touched by cross-slot edges, padded to a common S_max
    # (sep_valid marks real entries). The PublicPoses analog: only these
    # poses need to travel per step — the reference's core bandwidth idea
    # (``msg/PublicPoses.msg``).
    sep_idx: np.ndarray = None  # (M, S_max) int32
    sep_valid: np.ndarray = None  # (M, S_max) float32
    S_max: int = 0

    @staticmethod
    def build(
        problem: LiftedProblem,
        X0_global: np.ndarray,
        robot_colors: np.ndarray,
        num_devices: Optional[int] = None,
        dtype=np.float32,
    ) -> "ShardedProblem":
        """Shard a LiftedProblem: one robot per mesh slot (empty slots padded
        with inert robots when num_devices > num_robots).

        Shared edges are replicated to *both* endpoint devices at full weight
        — matching the reference where each robot stores every shared loop
        closure it participates in (``src/PGOAgentROS.cpp:262-281``). Each
        copy only ever contributes to its owner's *masked* block gradient, so
        there is no double counting in the solves; per-device costs are local
        restrictions (do not psum them — reassemble and evaluate globally for
        telemetry).
        """
        nR = problem.num_robots
        M = num_devices or nR
        assert M >= nR, "need at least one mesh slot per robot"
        n_max = int(np.max(problem.num_poses))
        e = problem.host_edges  # numpy mirror: prep stays d2h-free
        src = np.asarray(e.src)
        dst = np.asarray(e.dst)
        rop = np.asarray(problem.robot_of_pose)
        emask = np.asarray(e.mask) > 0
        src_r, dst_r = rop[src], rop[dst]

        # global padded index of each pose
        offsets = problem.offsets
        local_of = np.arange(problem.n) - offsets[rop]
        gpad_of = rop * n_max + local_of

        per_dev = [[] for _ in range(M)]
        halves = [[] for _ in range(M)]
        for k in np.where(emask)[0]:
            a, b = int(src_r[k]), int(dst_r[k])
            if a == b:
                per_dev[a].append(k)
                halves[a].append(1.0)
            else:
                per_dev[a].append(k)
                halves[a].append(1.0)
                per_dev[b].append(k)
                halves[b].append(1.0)
        E_max = max(1, max(len(v) for v in per_dev))

        def padded(arr, idxs, fill=0.0):
            out = np.full((E_max,) + arr.shape[1:], fill, arr.dtype)
            if idxs:
                out[: len(idxs)] = arr[idxs]
            return out

        R_ = np.asarray(e.R)
        t_ = np.asarray(e.t)
        kap = np.asarray(e.kappa)
        tau_ = np.asarray(e.tau)
        w_ = np.asarray(e.weight)
        il = np.asarray(e.is_loop)

        S = dict(
            src=np.zeros((M, E_max), np.int32),
            dst=np.zeros((M, E_max), np.int32),
            gidx=np.full((M, E_max), -1, np.int32),
            R=np.zeros((M, E_max, problem.d, problem.d), dtype),
            t=np.zeros((M, E_max, problem.d), dtype),
            kappa=np.zeros((M, E_max), dtype),
            tau=np.zeros((M, E_max), dtype),
            weight=np.zeros((M, E_max), dtype),
            mask=np.zeros((M, E_max), dtype),
            is_loop=np.zeros((M, E_max), dtype),
        )
        for m in range(M):
            idxs = per_dev[m] if m < nR else []
            S["src"][m] = padded(gpad_of[src].astype(np.int32), idxs)
            S["dst"][m] = padded(gpad_of[dst].astype(np.int32), idxs)
            if idxs:
                S["gidx"][m][: len(idxs)] = np.asarray(idxs, np.int32)
            S["R"][m] = padded(R_.astype(dtype), idxs)
            S["t"][m] = padded(t_.astype(dtype), idxs)
            S["kappa"][m] = padded(kap.astype(dtype), idxs)
            S["tau"][m] = padded(tau_.astype(dtype), idxs)
            S["weight"][m] = padded(w_.astype(dtype), idxs)
            S["is_loop"][m] = padded(il.astype(dtype), idxs)
            if idxs:
                S["mask"][m][: len(idxs)] = np.asarray(halves[m], dtype)

        X0 = np.zeros((M, n_max, problem.r, problem.d + 1), dtype)
        pv = np.zeros((M, n_max), dtype)
        for k in range(nR):
            nk = int(problem.num_poses[k])
            o = int(problem.offsets[k])
            X0[k, :nk] = X0_global[o : o + nk]
            pv[k, :nk] = 1.0
        # padded rows (and empty slots) get valid Stiefel points so
        # projections/retractions stay well-conditioned
        eye = np.zeros((problem.r, problem.d), dtype)
        eye[: problem.d, : problem.d] = np.eye(problem.d)
        for k in range(M):
            start = int(problem.num_poses[k]) if k < nR else 0
            X0[k, start:, :, : problem.d] = eye

        colors = np.zeros((M,), np.int32)
        colors[:nR] = robot_colors
        if M > nR:
            colors[nR:] = 0
        # separator pose sets: local poses of each robot touched by a
        # cross-robot edge (the PublicPoses payload)
        src_g, dst_g = gpad_of[src], gpad_of[dst]
        cross = emask & (src_r != dst_r)
        seps = [set() for _ in range(M)]
        for k in np.where(cross)[0]:
            seps[int(src_r[k])].add(int(src_g[k]) % n_max)
            seps[int(dst_r[k])].add(int(dst_g[k]) % n_max)
        S_max = max(1, max((len(s) for s in seps), default=1))
        sep_idx = np.zeros((M, S_max), np.int32)
        sep_valid = np.zeros((M, S_max), np.float32)
        for m in range(M):
            ids = sorted(seps[m])
            sep_idx[m, : len(ids)] = ids
            sep_valid[m, : len(ids)] = 1.0
        return ShardedProblem(
            sep_idx=sep_idx,
            sep_valid=sep_valid,
            S_max=S_max,
            X0=X0,
            pose_valid=pv,
            color=colors,
            num_colors=int(robot_colors.max()) + 1,
            n_max=n_max,
            M=M,
            r=problem.r,
            d=problem.d,
            **S,
        )


class SpmdState(NamedTuple):
    """Per-device sharded solver state."""

    X: jnp.ndarray  # (M, n_max, r, d+1) sharded on axis 0
    X_prev: jnp.ndarray
    V: jnp.ndarray  # auxiliary (extrapolated) blocks — the is_auxiliary
    # PublicPoses stream of the reference
    theta: jnp.ndarray  # (M, 1) per-robot Nesterov scalar
    iteration: jnp.ndarray  # (M, 1) int32 (replicated value per shard)
    rel_change: jnp.ndarray  # (M, 1)
    weights: jnp.ndarray  # (M, E_max)
    mu: jnp.ndarray  # (M, 1)
    wuc: jnp.ndarray  # (M, 1) int32 — weight-update round counter


def build_spmd_step(
    sp: ShardedProblem,
    mesh: Mesh,
    config: AgentConfig,
    axis: str = "robots",
):
    """Return (init_state, step) where step is a jitted shard_map program
    performing one colored-parallel RBCD iteration (+ optional GNC weight
    round when ``do_weight_update`` is 1)."""
    cfg = config.resolve()
    rtr = RTRParams(
        max_iterations=cfg.RTR_iterations,
        max_tcg_iterations=cfg.RTR_tCG_iterations,
        gradnorm_tol=cfg.RTR_gradnorm_tol,
    )
    M, n_max = sp.M, sp.n_max
    gnc = cfg.robust_cost_type == RobustCostType.GNC_TLS
    sep_only = cfg.spmd_separator_only
    if sep_only is None:
        sep_only = sp.sep_idx is not None
    # GNC compatibility: the step exchange only feeds the masked solves
    # (own block + separators — always fresh); weight rounds do their own
    # FULL all_gather inside the lax.cond, so the global rounding they
    # evaluate never sees template lanes
    sep_only = bool(sep_only and sp.sep_idx is not None)
    if sep_only:
        # static scatter coordinates of every slot's separator slab in the
        # gathered (M*n_max) lane space, invalid entries routed to a dump
        # row; inert template pose for never-exchanged lanes
        _gpos = (
            np.arange(M)[:, None] * n_max + np.asarray(sp.sep_idx)
        ).reshape(-1)
        _gpos = np.where(
            np.asarray(sp.sep_valid).reshape(-1) > 0, _gpos, M * n_max
        ).astype(np.int32)
        _pad_pose = np.zeros((sp.r, sp.d + 1), np.float32)
        _pad_pose[: sp.d, : sp.d] = np.eye(sp.d)

    # Static per-device tensors, device_put as *global* sharded arrays and
    # passed as jit arguments (NOT closed over: closing over an array that
    # spans non-addressable devices is an error on a multi-host mesh — every
    # process holds the same replicated numpy and contributes its shards).
    row_sharding = NamedSharding(mesh, P(axis))
    consts = {
        k: jax.device_put(v, row_sharding)
        for k, v in dict(
            src=sp.src,
            dst=sp.dst,
            R=sp.R,
            t=sp.t,
            kappa=sp.kappa,
            tau=sp.tau,
            mask=sp.mask,
            is_loop=sp.is_loop,
            pose_valid=sp.pose_valid,
            color=sp.color,
            **(
                {"sep_idx": np.asarray(sp.sep_idx, np.int32)}
                if sep_only
                else {}
            ),
        ).items()
    }

    def shard_body(step_idx, do_weight_update, st, c):
        """Runs per device with leading M axis stripped to size 1."""
        me = jax.lax.axis_index(axis)
        z = jnp.zeros((), me.dtype)  # index literals must match me's dtype
        start = me * n_max
        X_own = st.X[0]  # (n_max, r, d+1)
        # --- separator exchange: the PublicPoses analogue -----------------
        # Single fused all_gather for (X, V): independent collectives can be
        # scheduled in different orders by per-device executors and deadlock
        # the in-process CPU rendezvous; one collective also means one
        # transfer on hardware. V is the is_auxiliary stream.
        if sep_only:
            # only the separator slabs travel (round 5): non-separator
            # lanes of other slots never influence a masked block solve
            # (owned edges touch own block + separators; foreign-edge
            # contributions hit masked lanes and cost constants that
            # cancel in trust-region reductions) — they are filled with
            # an inert template pose
            sidx = c["sep_idx"][0]
            both = jnp.stack(
                [X_own[sidx], st.V[0][sidx]], axis=0
            )  # (2, S_max, r, d+1)
            g = jax.lax.all_gather(both, axis)  # (M, 2, S_max, r, d+1)
            sepX = g[:, 0].reshape(M * sp.S_max, sp.r, sp.d + 1)
            sepV = g[:, 1].reshape(M * sp.S_max, sp.r, sp.d + 1)
            tmpl = jnp.broadcast_to(
                jnp.asarray(_pad_pose, X_own.dtype),
                (M * n_max + 1, sp.r, sp.d + 1),
            )
            gpos = jnp.asarray(_gpos)  # padding → dump row M*n_max
            Xg = tmpl.at[gpos].set(sepX)[: M * n_max]
            Vg = tmpl.at[gpos].set(sepV)[: M * n_max]
            # own block is locally fresh — no need to round-trip it
            Xg = jax.lax.dynamic_update_slice(Xg, X_own, (start, z, z))
            Vg = jax.lax.dynamic_update_slice(Vg, st.V[0], (start, z, z))
        else:
            both = jnp.stack([X_own, st.V[0]], axis=0)  # (2, n_max, r, d+1)
            g = jax.lax.all_gather(both, axis)  # (M, 2, n_max, r, d+1)
            Xg = g[:, 0].reshape(M * n_max, sp.r, sp.d + 1)
            Vg = g[:, 1].reshape(M * n_max, sp.r, sp.d + 1)
        e = EdgeSet(
            src=c["src"][0],
            dst=c["dst"][0],
            R=c["R"][0],
            t=c["t"][0],
            kappa=c["kappa"][0],
            tau=c["tau"][0],
            weight=st.weights[0],
            mask=c["mask"][0],
            is_loop=c["is_loop"][0],
        )
        # --- masked local solve ------------------------------------------
        my_color = c["color"][0]
        active = (my_color == step_idx % sp.num_colors).astype(Xg.dtype)
        own_full = jnp.zeros((M * n_max,), Xg.dtype)
        own_full = jax.lax.dynamic_update_slice(
            own_full, c["pose_valid"][0], (start,)
        )
        own = own_full * active
        mask = own[:, None, None]
        P_blocks = quadratic.precond_inverse(
            quadratic.precond_blocks(e, M * n_max)
        )

        def local_solve(Xfull):
            """Masked RTR block solve on the gathered state."""
            Z, _ = rtr_solve(Xfull, e, mask, P_blocks, rtr)
            return Z

        if cfg.acceleration:
            # Accelerated RBCD: solve the block against the *auxiliary*
            # gathered state Vg (see parallel/rbcd.py::_block_update for the
            # rationale), guard with the local cost restriction, then
            # extrapolate the own block's auxiliary value.
            theta = st.theta[0, 0]
            theta_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * theta**2))
            if cfg.acceleration_beta is not None:
                beta = jnp.asarray(cfg.acceleration_beta, Xg.dtype)
            else:
                beta = (theta - 1.0) / theta_new
            f_cur = quadratic.cost(Xg, e)
            Z = local_solve(Vg)
            X_acc = jnp.where(mask > 0, Z, Xg)
            f_acc = quadratic.cost(X_acc, e)

            Xp_full = jnp.zeros_like(Xg)
            Xp_full = jax.lax.dynamic_update_slice(
                Xp_full, st.X_prev[0], (start, z, z)
            )

            def ok():
                Vk = stiefel.retract_polar_ns(
                    X_acc,
                    beta
                    * stiefel.proj_tangent(X_acc, mask * (X_acc - Xp_full)),
                )
                V_new = jnp.where(mask > 0, Vk, X_acc)
                return X_acc, V_new, theta_new

            def restart():
                X_r = local_solve(Xg)
                return X_r, X_r, jnp.asarray(1.0, theta.dtype)

            X_new, V_full, theta_out = jax.lax.cond(
                f_acc <= f_cur, ok, restart
            )
            theta_out = jnp.where(
                (step_idx + 1) % cfg.restart_interval == 0, 1.0, theta_out
            )
            V_own_new = jnp.where(
                active > 0,
                jax.lax.dynamic_slice(
                    V_full, (start, z, z), (n_max, sp.r, sp.d + 1)
                ),
                st.V[0],
            )
        else:
            X_new = local_solve(Xg)
            theta_out = st.theta[0, 0]
            V_own_new = None  # set below to own new block

        per_pose = jnp.sqrt(jnp.sum((X_new - Xg) ** 2, axis=(-2, -1)))
        rc_own = jnp.max(per_pose * own)
        # neighbor invalidation (see rbcd._finish_step): an inactive
        # device's stale rel-change is bumped by the other robots'
        # movement this step (conservative: any mover counts), so
        # termination requires a quiescent neighborhood, not a stale zero
        rc_others = jnp.max(per_pose * (1.0 - own))
        rc = jnp.where(
            active > 0,
            rc_own,
            jnp.maximum(st.rel_change[0, 0], rc_others),
        )

        X_prev_own = jnp.where(
            active > 0,
            jax.lax.dynamic_slice(
                Xg, (start, z, z), (n_max, sp.r, sp.d + 1)
            ),
            st.X_prev[0],
        )
        X_own_new = jax.lax.dynamic_slice(
            X_new, (start, z, z), (n_max, sp.r, sp.d + 1)
        )
        if V_own_new is None:  # unaccelerated: auxiliary tracks the main
            V_own_new = X_own_new

        # --- optional GNC weight round (UPDATE_WEIGHT analogue) ----------
        w = st.weights[0]
        mu = st.mu[0, 0]
        wuc = st.wuc[0, 0]
        if gnc:
            def weight_round(args):
                w0, mu0, k0 = args
                Xall = jax.lax.all_gather(X_own_new, axis).reshape(
                    M * n_max, sp.r, sp.d + 1
                )
                T = rounding.round_solution(Xall)
                res_e = robust.measurement_residuals(T, e)
                fixed = 1.0 - e.is_loop
                if getattr(cfg, "GNC_schedule", "reference") == "adaptive":
                    # global residual scale agreed across devices via pmean
                    # of local P90s (each device then computes identical
                    # weights for its copies of shared edges)
                    lm = e.is_loop * e.mask
                    rn = jnp.where(lm > 0, res_e, jnp.nan)
                    p90l = jnp.nan_to_num(
                        jnp.nanpercentile(rn, 90.0), nan=cfg.GNC_barc
                    )
                    p90 = jnp.maximum(
                        jax.lax.pmean(p90l, axis), cfg.GNC_barc
                    )
                    K = max(int(cfg.robust_opt_num_weight_updates), 1)
                    alpha = (k0.astype(res_e.dtype) + 1.0) / K
                    barc_k = jnp.maximum(
                        jnp.exp(
                            (1.0 - alpha) * jnp.log(p90)
                            + alpha * jnp.log(cfg.GNC_barc)
                        ),
                        cfg.GNC_barc,
                    )
                    mu_use = jnp.asarray(3.0, res_e.dtype)
                else:
                    mu_use, barc_k = mu0, cfg.GNC_barc
                w1, _ = robust.update_weights_gnc(
                    w0, fixed, res_e, mu_use, barc_k, cfg.GNC_mu_step
                )
                return w1, mu0 * cfg.GNC_mu_step, k0 + 1

            w, mu, wuc = jax.lax.cond(
                do_weight_update > 0,
                weight_round,
                lambda a: a,
                (w, mu, wuc),
            )

        return SpmdState(
            X=X_own_new[None],
            X_prev=X_prev_own[None],
            V=V_own_new[None],
            theta=jnp.asarray(theta_out)[None, None],
            iteration=st.iteration + 1,
            rel_change=jnp.asarray(rc)[None, None],
            weights=w[None],
            mu=jnp.asarray(mu)[None, None],
            wuc=jnp.asarray(wuc)[None, None],
        )

    spec_state = SpmdState(
        X=P(axis), X_prev=P(axis), V=P(axis), theta=P(axis),
        iteration=P(axis), rel_change=P(axis), weights=P(axis), mu=P(axis),
        wuc=P(axis),
    )
    spec_consts = {k: P(axis) for k in consts}

    smapped = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), spec_state, spec_consts),
        out_specs=spec_state,
        check_vma=False,
    )

    jitted = jax.jit(smapped)

    def step(step_idx, do_weight_update, st):
        return jitted(step_idx, do_weight_update, st, consts)

    # Initial state: built as replicated numpy on every process, device_put
    # straight to the global sharding (multi-host safe — no intermediate
    # single-device array).
    dtype = sp.X0.dtype
    init_np = SpmdState(
        X=sp.X0,
        X_prev=sp.X0,
        V=sp.X0,
        theta=np.ones((M, 1), dtype),
        iteration=np.zeros((M, 1), np.int32),
        rel_change=np.full((M, 1), np.inf, dtype),
        weights=sp.weight,
        mu=np.full((M, 1), cfg.GNC_init_mu, dtype),
        wuc=np.zeros((M, 1), np.int32),
    )
    init = jax.device_put(
        init_np, jax.tree.map(lambda _: row_sharding, init_np)
    )
    return init, step


def gather_weights(
    sp: ShardedProblem, st: SpmdState, num_global_edges: int
) -> np.ndarray:
    """Reassemble the global (E,) robust-weight vector from per-device edge
    copies via the ``gidx`` map (replicated shared-edge copies hold identical
    weights — the GNC round computes them from the identical gathered state,
    the RelativeMeasurementWeights-replication analogue)."""
    if st.weights.is_fully_addressable:
        W = np.asarray(st.weights)
    else:
        from jax.experimental import multihost_utils

        W = np.asarray(
            multihost_utils.process_allgather(st.weights, tiled=True)
        )
    out = np.ones((num_global_edges,), W.dtype)
    sel = sp.gidx >= 0
    out[sp.gidx[sel]] = W[sel]
    return out


def gather_state(st: SpmdState) -> SpmdState:
    """Full host copy of a (possibly multi-process) sharded SpmdState —
    every process returns identical replicated arrays (DCN all-gather for
    non-addressable shards). The durable-checkpoint path for multi-host
    runs: any process can persist the full state; on restart every process
    loads the same file and re-places shards onto its mesh."""

    def g(x):
        if x.is_fully_addressable:
            return np.asarray(x)
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))

    return SpmdState(*(g(x) for x in st))


def place_state(st_host: SpmdState, like: SpmdState) -> SpmdState:
    """Re-place a host-replicated state onto the live mesh with ``like``'s
    shardings (the resume side of :func:`gather_state`)."""
    import jax

    return SpmdState(*(
        jax.device_put(np.asarray(h), x.sharding)
        for h, x in zip(st_host, like)
    ))


def gather_trajectory(sp: ShardedProblem, st: SpmdState, num_poses) -> np.ndarray:
    """Reassemble the global lifted state (n, r, d+1) from shards.

    On a multi-host mesh the shards live on other processes' devices —
    all-gather them over DCN first (every process returns the full state).
    """
    if st.X.is_fully_addressable:
        X = np.asarray(st.X)
    else:
        from jax.experimental import multihost_utils

        X = np.asarray(multihost_utils.process_allgather(st.X, tiled=True))
    parts = []
    for k, nk in enumerate(num_poses):
        parts.append(X[k, : int(nk)])
    return np.concatenate(parts, axis=0)
