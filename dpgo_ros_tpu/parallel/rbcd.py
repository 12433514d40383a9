"""The multi-robot RBCD engine — the framework's core solver loop.

This is the accelerator re-design of the reference's distributed round
structure (SURVEY.md §3.2): the event-driven FSM over lossy pub/sub becomes a
deterministic schedule over jit-compiled block updates on a single global
lifted state X. The three update rules:

* ``Uniform`` / ``RoundRobin`` — sequential token passing, exactly the
  reference's synchronous RBCD (``publishUpdateCommand``,
  ``src/PGOAgentROS.cpp:443-504``): one robot optimizes its block per
  iteration, everyone else only observes.
* ``Parallel`` — the data-parallel generalization: a greedy coloring of the
  robot adjacency graph (robots adjacent iff they share loop closures); all
  robots of one color update *simultaneously* each iteration. Within a color
  class the joint Hessian is block-diagonal, so a single masked trust-region
  solve on the union mask IS the set of independent per-robot block solves —
  provably convergent (it is exact block-coordinate descent over color
  classes), with num_colors ≤ num_robots steps per sweep instead of
  num_robots. (SURVEY.md §2.4 notes the sequential token is an artifact of
  lossy robot networks, not of the math.)

Nesterov acceleration maintains the auxiliary sequence the reference
exchanges as ``is_auxiliary`` PublicPoses (``src/PGOAgentROS.cpp:662-690``),
with adaptive + periodic restart (``restart_interval``). GNC-TLS outer
rounds mirror ``commandCallback(UPDATE_WEIGHT)`` (``PGOAgentROS.cpp:1211-1233``).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dpgo_ros_tpu.models import robust
from dpgo_ros_tpu.models.local_solvers import (
    RGDParams,
    RTRParams,
    rgd_solve,
    rtr_solve,
)
from dpgo_ros_tpu.models.problem import LiftedProblem
from dpgo_ros_tpu.ops import chordal as chordal_ops
from dpgo_ros_tpu.ops import lie, quadratic, rounding, stiefel
from dpgo_ros_tpu.types import EdgeType
from dpgo_ros_tpu.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    SolverMethod,
    UpdateRule,
)


class RBCDState(NamedTuple):
    """Device-resident solver state (a pytree; one per fleet)."""

    X: jnp.ndarray  # (n, r, d+1) lifted main iterate, global frame
    X_prev: jnp.ndarray  # per-block previous accepted iterate (momentum)
    V: jnp.ndarray  # auxiliary (extrapolated) sequence — what neighbors see;
    # the reference exchanges it as is_auxiliary PublicPoses
    # (``src/PGOAgentROS.cpp:662-690``)
    theta: jnp.ndarray  # Nesterov scalar sequence
    iteration: jnp.ndarray  # i32
    cost: jnp.ndarray
    rel_change: jnp.ndarray  # (num_robots,) last per-robot relative change
    weights: jnp.ndarray  # (E,) current robust weights
    fixed_mask: jnp.ndarray  # (E,) 1.0 where weight is frozen
    mu: jnp.ndarray  # GNC mu
    weight_update_count: jnp.ndarray  # i32


class RBCDEngine:
    """Owns a LiftedProblem + AgentConfig; exposes jitted step functions and
    a host-side driver (`run`) implementing the reference round protocol."""

    def __init__(self, problem: LiftedProblem, config: AgentConfig):
        self.problem = problem
        self.config = config.resolve()
        self.dtype = jnp.float64 if self.config.dtype == "float64" else jnp.float32
        cfg = self.config
        self.rtr_params = RTRParams(
            max_iterations=cfg.RTR_iterations,
            max_tcg_iterations=cfg.RTR_tCG_iterations,
            gradnorm_tol=cfg.RTR_gradnorm_tol,
        )
        self.rgd_params = RGDParams(
            stepsize=cfg.RGD_stepsize,
            use_preconditioner=cfg.RGD_use_preconditioner,
        )
        # (num_robots, n, 1, 1) stack of block masks — built in numpy and
        # transferred once (one transfer instead of one tiny device op per
        # robot)
        rof = np.asarray(problem.robot_of_pose)
        np_dt = np.float64 if self.dtype == jnp.float64 else np.float32
        masks_np = np.stack(
            [
                (rof == k).astype(np_dt)[:, None, None]
                for k in range(problem.num_robots)
            ],
            axis=0,
        )
        self._masks_np = masks_np  # host copies: prep stays d2h-free
        self._masks = jnp.asarray(masks_np)
        self._all_mask = jnp.ones_like(self._masks[0])
        # greedy coloring of the robot adjacency graph for the Parallel rule
        self.robot_colors = self._color_robots()
        self.num_colors = int(self.robot_colors.max()) + 1
        color_masks_np = np.stack(
            [
                np.clip(
                    sum(
                        masks_np[k]
                        for k in range(problem.num_robots)
                        if self.robot_colors[k] == c
                    ),
                    0.0,
                    1.0,
                )
                for c in range(self.num_colors)
            ],
            axis=0,
        )
        self._color_masks_np = color_masks_np
        self._color_masks = jnp.asarray(color_masks_np)
        self._adjf = jnp.asarray(self._adj_np.astype(np_dt))  # (R, R)
        self.Ylift: Optional[jnp.ndarray] = None

        self._step_seq = jax.jit(self._step_sequential_impl)
        self._step_par = jax.jit(self._step_parallel_impl)
        self._weight_upd = jax.jit(self._weight_update_impl)

    def _color_robots(self) -> np.ndarray:
        """Greedy coloring of robots; adjacent iff they share measurements
        (the separator structure, reference shared loop closures)."""
        prob = self.problem
        nR = prob.num_robots
        he = prob.host_edges
        src_r = np.asarray(prob.robot_of_pose)[np.asarray(he.src)]
        dst_r = np.asarray(prob.robot_of_pose)[np.asarray(he.dst)]
        mask = np.asarray(he.mask) > 0
        adj = np.zeros((nR, nR), bool)
        cross = mask & (src_r != dst_r)
        adj[src_r[cross], dst_r[cross]] = True
        adj[dst_r[cross], src_r[cross]] = True
        self._adj_np = adj  # robot adjacency — also used for the
        # neighbor-invalidation termination rule (_finish_step)
        colors = -np.ones(nR, np.int32)
        for k in np.argsort(-adj.sum(1)):  # highest degree first
            used = set(colors[adj[k]]) - {-1}
            c = 0
            while c in used:
                c += 1
            colors[k] = c
        return colors

    # ------------------------------------------------------------------ init

    def _edges(self, weights: jnp.ndarray) -> quadratic.EdgeSet:
        return dataclasses.replace(self.problem.edges, weight=weights)

    def _local_subgraph_traj(self, robot: int) -> np.ndarray:
        """Local initialization for one robot on its private subgraph
        (odometry + private LCs), per ``localInitializationMethod``
        (reference ``PGOAgentROSNode.cpp:104-117``)."""
        prob, cfg = self.problem, self.config
        data = prob.data
        assert data is not None
        m = data.measurements
        nk = int(prob.num_poses[robot])
        mine = (
            (m.src_robot == robot)
            & (m.dst_robot == robot)
        )
        if cfg.local_initialization_method == InitMethod.ODOMETRY:
            odo = mine & (m.edge_type == EdgeType.ODOMETRY)
            idx = np.argsort(m.src_frame[np.asarray(odo)])
            R = m.R[np.asarray(odo)][idx]
            t = m.t[np.asarray(odo)][idx]
            frames = m.src_frame[np.asarray(odo)][idx]
            rel = np.zeros((nk - 1, prob.d, prob.d + 1))
            rel[:, :, : prob.d] = np.eye(prob.d)
            for a, f in enumerate(frames):
                if f < nk - 1:
                    rel[f, :, : prob.d] = R[a]
                    rel[f, :, prob.d] = t[a]
            return np.asarray(lie.odometry_chain(jnp.asarray(rel, self.dtype)))
        else:  # Chordal, or GNC_TLS robust local initialization
            sel = np.asarray(mine)
            E = int(sel.sum())
            odo = jnp.asarray(
                (m.edge_type[sel] == EdgeType.ODOMETRY).astype(np.float64),
                self.dtype,
            )
            es = quadratic.EdgeSet(
                src=jnp.asarray(m.src_frame[sel].astype(np.int32)),
                dst=jnp.asarray(m.dst_frame[sel].astype(np.int32)),
                R=jnp.asarray(m.R[sel], self.dtype),
                t=jnp.asarray(m.t[sel], self.dtype),
                kappa=jnp.asarray(m.kappa[sel], self.dtype),
                tau=jnp.asarray(m.tau[sel], self.dtype),
                weight=jnp.asarray(m.weight[sel], self.dtype),
                mask=jnp.ones((E,), self.dtype),
                is_loop=jnp.zeros((E,), self.dtype),
            )
            T = np.asarray(
                chordal_ops.chordal_initialization(es, nk, max_iters=500)
            )
            if cfg.local_initialization_method == InitMethod.GNC_TLS:
                # robust local init (reference GNC_TLS init method): annealed
                # truncation — reject private loop closures whose residual
                # exceeds a shrinking cutoff, re-solving chordally each
                # round. robustInitMinInliers (reference
                # ``PGOAgentROSNode.cpp:212-221``): never truncate below the
                # minimum inlier count — stop tightening instead.
                barc = cfg.GNC_barc
                for factor in (10.0, 3.0, 1.5):
                    r_e = robust.measurement_residuals(
                        jnp.asarray(T, self.dtype), es
                    )
                    keep = np.asarray(odo > 0) | (
                        np.asarray(r_e) <= factor * barc
                    )
                    n_inlier_loops = int((keep & ~np.asarray(odo > 0)).sum())
                    if n_inlier_loops < cfg.robust_init_min_inliers:
                        break
                    es = dataclasses.replace(
                        es,
                        weight=jnp.asarray(
                            keep.astype(np.float64), self.dtype
                        ),
                    )
                    T = np.asarray(
                        chordal_ops.chordal_initialization(
                            es, nk, max_iters=500
                        )
                    )
            return T

    def _align_robot_frames(self, local_trajs: List[np.ndarray]) -> np.ndarray:
        """Multi-robot initialization: BFS frame alignment over the robot
        adjacency graph using shared measurements — the deterministic
        equivalent of the reference's distributed initialization rounds
        (``tryInitialize`` / ``initializeInGlobalFrame``,
        ``src/PGOAgentROS.cpp:322-366``; leader = robot 0 anchors the global
        frame)."""
        prob = self.problem
        data = prob.data
        assert data is not None
        m = data.measurements
        nR = prob.num_robots
        G: List[Optional[np.ndarray]] = [None] * nR
        G[0] = np.concatenate(
            [np.eye(prob.d), np.zeros((prob.d, 1))], axis=-1
        )
        shared = m.edge_type == EdgeType.SHARED_LOOP_CLOSURE
        order = np.where(np.asarray(shared))[0]
        # BFS over robots
        frontier = [0]
        visited = {0}
        while frontier:
            a = frontier.pop(0)
            for k in order:
                ra, rb = int(m.src_robot[k]), int(m.dst_robot[k])
                if ra == a and rb not in visited:
                    G[rb] = self._align_pair(G[a], local_trajs[a], local_trajs[rb], m, k, src_side=True)
                    visited.add(rb)
                    frontier.append(rb)
                elif rb == a and ra not in visited:
                    G[ra] = self._align_pair(G[a], local_trajs[a], local_trajs[ra], m, k, src_side=False)
                    visited.add(ra)
                    frontier.append(ra)
        for rb in range(nR):
            if G[rb] is None:  # disconnected robot: keep local frame
                G[rb] = np.concatenate(
                    [np.eye(prob.d), np.zeros((prob.d, 1))], axis=-1
                )
        out = []
        for rb in range(nR):
            Gk = jnp.asarray(G[rb], self.dtype)
            Tk = jnp.asarray(local_trajs[rb], self.dtype)
            out.append(
                np.asarray(
                    lie.se_compose(
                        jnp.broadcast_to(Gk, Tk.shape[:1] + Gk.shape), Tk
                    )
                )
            )
        return np.concatenate(out, axis=0)

    def _align_pair(self, Ga, traj_a, traj_b, m, k, src_side: bool):
        """Frame of robot b from one shared edge k between a (known frame Ga)
        and b: global constraint  G_a T_i M_e = G_b T_j."""
        d = self.problem.d
        Me = np.concatenate([m.R[k], m.t[k][:, None]], axis=-1)
        i, j = int(m.src_frame[k]), int(m.dst_frame[k])
        comp = lambda A, B: np.asarray(
            lie.se_compose(jnp.asarray(A, self.dtype), jnp.asarray(B, self.dtype))
        )
        inv = lambda A: np.asarray(lie.se_inverse(jnp.asarray(A, self.dtype)))
        if src_side:  # a = src robot, b = dst robot
            lhs = comp(comp(Ga, traj_a[i]), Me)
            return comp(lhs, inv(traj_b[j]))
        else:  # a = dst robot, b = src robot: G_b T_i M_e = G_a T_j
            lhs = comp(Ga, traj_a[j])
            return comp(lhs, inv(comp(traj_b[i], Me)))

    def initialize(
        self, key: Optional[jax.Array] = None, trajectory: Optional[np.ndarray] = None
    ) -> RBCDState:
        """Build the initial lifted state: local init per robot → frame
        alignment → anchor → lift through a shared sampled YLift
        (reference lifting-matrix broadcast, ``PGOAgentROS.cpp:402-410``)."""
        prob, cfg = self.problem, self.config
        key = key if key is not None else jax.random.PRNGKey(cfg.seed)
        if trajectory is None:
            locals_ = [
                self._local_subgraph_traj(k) for k in range(prob.num_robots)
            ]
            if cfg.multirobot_initialization and prob.num_robots > 1:
                T = self._align_robot_frames(locals_)
            else:
                T = np.concatenate(locals_, axis=0)
        else:
            T = np.asarray(trajectory)
        T = rounding.anchor_to_first_pose(jnp.asarray(T, self.dtype))
        if prob.r == prob.d:
            self.Ylift = jnp.eye(prob.d, dtype=self.dtype)
        else:
            self.Ylift = stiefel.random_lifting_matrix(
                key, prob.r, prob.d, self.dtype
            )
        X = stiefel.lift_trajectory(T, self.Ylift)
        E = prob.edges.num_edges
        weights = jnp.asarray(self.problem.edges.weight, self.dtype)
        fixed = 1.0 - jnp.asarray(self.problem.edges.is_loop, self.dtype)
        if self.config.robust_cost_type == RobustCostType.L2:
            fixed = jnp.ones_like(fixed)
        e = self._edges(weights)
        return RBCDState(
            X=X,
            X_prev=X,
            V=X,
            theta=jnp.asarray(1.0, self.dtype),
            iteration=jnp.asarray(0, jnp.int32),
            cost=quadratic.cost(X, e),
            rel_change=jnp.full((prob.num_robots,), jnp.inf, self.dtype),
            weights=weights,
            fixed_mask=fixed,
            mu=jnp.asarray(self.config.GNC_init_mu, self.dtype),
            weight_update_count=jnp.asarray(0, jnp.int32),
        )

    # ------------------------------------------------------------------ steps

    def _solver_cache(self, e):
        """Weight-dependent solver constants, hoisted off the hot loop: the
        block-Jacobi inverse (recomputed once per GNC weight round, like the
        reference's ``clearDataMatrices`` invalidation,
        ``src/PGOAgentROS.cpp:1351``)."""
        return self._precond_inv(e)

    def _local_solve(self, X, e, mask, P):
        if self.config.solver == SolverMethod.RTR:
            return rtr_solve(X, e, mask, P, self.rtr_params)
        return rgd_solve(X, e, mask, P, self.rgd_params)

    def _block_update(self, st: RBCDState, mask, e, cache):
        """One masked block update, optionally Nesterov-accelerated.

        Accelerated RBCD requires the block subproblem to be solved against
        the *auxiliary* (extrapolated) state V — solving from an extrapolated
        starting point alone is a no-op when the block is minimized (nearly)
        exactly, since the minimizer doesn't depend on the start. This is why
        the reference exchanges a second is_auxiliary pose stream
        (``src/PGOAgentROS.cpp:662-690``). After the solve, the block's
        auxiliary value is extrapolated: V_k = Retr(X_k, β (X_k − X_k^prev)),
        with β from the standard Nesterov θ-sequence, adaptive restart on
        cost increase, and periodic restart (``restart_interval``).

        Returns (X_new, V_new, res, theta_new).
        """
        cfg = self.config
        if not cfg.acceleration:
            X_new, res = self._local_solve(st.X, e, mask, cache)
            return X_new, X_new, res, st.theta

        theta_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * st.theta**2))
        if cfg.acceleration_beta is not None:
            beta = jnp.asarray(cfg.acceleration_beta, st.X.dtype)
        else:
            beta = (st.theta - 1.0) / theta_new
        # solve block against neighbors at their auxiliary values
        Z, res_acc = self._local_solve(st.V, e, mask, cache)
        X_acc = jnp.where(mask > 0, Z, st.X)
        f_acc = quadratic.cost(X_acc, e)

        def accept():
            Vk = stiefel.retract_polar_ns(
                X_acc,
                beta * stiefel.proj_tangent(X_acc, mask * (X_acc - st.X_prev)),
            )
            V_new = jnp.where(mask > 0, Vk, st.V)
            r = res_acc._replace(f_opt=f_acc)
            return X_acc, V_new, r, theta_new

        def restart():
            X_r, res_r = self._local_solve(st.X, e, mask, cache)
            return X_r, X_r, res_r, jnp.asarray(1.0, st.theta.dtype)

        if cfg.acceleration_safeguard:
            ok = f_acc <= st.cost
            X_new, V_new, res, theta = jax.lax.cond(ok, accept, restart)
        else:
            X_new, V_new, res, theta = accept()
        theta = jnp.where(
            (st.iteration + 1) % cfg.restart_interval == 0, 1.0, theta
        )
        return X_new, V_new, res, theta

    def _finish_step(self, st: RBCDState, X_new, V_new, res, theta, mask):
        """Common epilogue: relative change, momentum memory, counters.

        Relative change per robot is the Frobenius norm of its block's
        update (``relative_change_metric="block_frobenius"``, the
        DPGO-calibrated default matching the reference's ~240-iteration
        sphere2500 convergence at tol 0.2) or the max per-pose update norm
        (``"max_pose"``, a looser uniform metric)."""
        per_pose2 = jnp.sum((X_new - st.X) ** 2, axis=(-2, -1))  # (n,)
        sel = mask[:, 0, 0]
        if getattr(self.config, "relative_change_metric", "block_frobenius") == "max_pose":
            moved = (
                jnp.zeros((self.problem.num_robots,), self.dtype)
                .at[self.problem.robot_of_pose]
                .max(sel * jnp.sqrt(per_pose2))
            )
            rc = jnp.max(sel * jnp.sqrt(per_pose2))
        else:
            moved = jnp.sqrt(
                jnp.zeros((self.problem.num_robots,), self.dtype)
                .at[self.problem.robot_of_pose]
                .add(sel * per_pose2)
            )
            rc = jnp.sqrt(jnp.sum(sel * per_pose2))
        updated_robots = (
            jnp.zeros((self.problem.num_robots,), self.dtype)
            .at[self.problem.robot_of_pose]
            .max(sel)
        )
        # neighbor invalidation (round-3 termination fix): a robot's
        # recorded rel-change goes STALE when a neighbor later moves — the
        # reference's last-reported-relative-change termination shares this
        # hazard and can stop at a blockwise-stale non-critical point
        # (observed: tinyGrid 2-robot Uniform run terminating with
        # rel=[0,0] at cost 21.6 while block 1's true gradient norm was
        # 25.4). Movement m_k of robot k bounds the shift of a neighbor's
        # block optimum (continuity), so bump every non-updated neighbor's
        # rel-change to at least max_k adj[k,j]·m_k — termination then
        # requires a full quiescent neighborhood.
        bump = (moved * updated_robots) @ self._adjf
        rel_change = jnp.where(
            updated_robots > 0,
            moved,
            jnp.maximum(st.rel_change, bump),
        )
        X_prev = jnp.where(mask > 0, st.X, st.X_prev)
        return RBCDState(
            X=X_new,
            X_prev=X_prev,
            V=V_new,
            theta=theta,
            iteration=st.iteration + 1,
            cost=res.f_opt,
            rel_change=rel_change,
            weights=st.weights,
            fixed_mask=st.fixed_mask,
            mu=st.mu,
            weight_update_count=st.weight_update_count,
        ), rc

    def _precond_inv(self, e) -> jnp.ndarray:
        """Damped block-Jacobi inverse for the current weights. Depends only
        on the weights — callers on the hot path should compute it once per
        weight change and pass it through (``Pinv`` argument)."""
        return quadratic.precond_inverse(
            quadratic.precond_blocks(e, self.problem.n)
        )

    def _step_sequential_impl(self, st: RBCDState, robot: jnp.ndarray, cache=None):
        """Synchronous RBCD step: the robot named by the UPDATE token
        optimizes its block (reference ``iterate(true)`` vs ``iterate(false)``,
        ``src/PGOAgentROS.cpp:1161-1189``)."""
        e = self._edges(st.weights)
        mask = self._masks[robot]
        cache = cache if cache is not None else self._solver_cache(e)
        X_new, V_new, res, theta = self._block_update(st, mask, e, cache)
        return self._finish_step(st, X_new, V_new, res, theta, mask)

    def _step_parallel_impl(self, st: RBCDState, color: jnp.ndarray, cache=None):
        """Colored-parallel block update: all robots of ``color`` solve
        simultaneously. Their union mask selects a block-diagonal sub-Hessian
        (no shared edges within a color class), so the masked trust-region
        solve decomposes into the independent per-robot solves — on a device
        mesh this is the shard_map step of parallel/spmd.py."""
        e = self._edges(st.weights)
        mask = self._color_masks[color]
        cache = cache if cache is not None else self._solver_cache(e)
        X_new, V_new, res, theta = self._block_update(st, mask, e, cache)
        return self._finish_step(st, X_new, V_new, res, theta, mask)

    def _weight_update_impl(self, st: RBCDState):
        """Robust weight round (reference UPDATE_WEIGHT,
        ``PGOAgentROS.cpp:1211-1233``): residuals on the rounded trajectory;
        GNC-TLS weights under the scheduled mu, or plain IRLS weights for the
        L1/Huber/TLS/GM robust costs (``mRobustCost.weight(residual)``,
        reference ``PGOAgentROS.cpp:1050``)."""
        cfg = self.config
        e = self._edges(st.weights)
        T = rounding.round_solution(st.X)
        r = robust.measurement_residuals(T, e)
        if cfg.robust_cost_type == RobustCostType.GNC_TLS:
            mu_use, barc_use = robust.gnc_round_params(
                st.weight_update_count,
                cfg,
                st.mu,
                residuals=r,
                loop_mask=e.is_loop * e.mask,
                dtype=self.dtype,
            )
            w_new, _ = robust.update_weights_gnc(
                st.weights, st.fixed_mask, r, mu_use, barc_use, cfg.GNC_mu_step
            )
        else:
            w_irls = robust.robust_weight(
                cfg.robust_cost_type.value, r, cfg.GNC_barc
            )
            w_new = jnp.where(st.fixed_mask > 0, st.weights, w_irls)
        mu_new = st.mu * cfg.GNC_mu_step
        fixed = st.fixed_mask
        if cfg.weight_convergence_threshold > 0:
            # reference semantics (``PGOAgentROS.cpp:1049-1056``): an edge
            # whose GNC weight fell below the threshold is REJECTED and
            # frozen (weight=0, fixedWeight=true) — progressive hard
            # rejection. (Freezing near-1 weights too — "binarized" — was
            # tried and misfires: GNC weights START near 1 under small mu,
            # so the whole outlier set gets frozen as accepts in round 1;
            # measured on the tunnels dataset.)
            newly = (fixed == 0) & (
                w_new < cfg.weight_convergence_threshold
            )
            w_new = jnp.where(newly, 0.0, w_new)
            fixed = jnp.where(newly, 1.0, fixed)
        cost = quadratic.cost(st.X, self._edges(w_new))
        return RBCDState(
            X=st.X,
            X_prev=st.X,  # drop momentum across weight rounds
            V=st.X,
            theta=jnp.asarray(1.0, self.dtype),
            iteration=st.iteration,
            cost=cost,
            rel_change=jnp.full_like(st.rel_change, jnp.inf),
            weights=w_new,
            fixed_mask=fixed,
            mu=mu_new,
            weight_update_count=st.weight_update_count + 1,
        )

    # ------------------------------------------------------------------ driver

    def run(
        self,
        state: Optional[RBCDState] = None,
        max_iters: Optional[int] = None,
        callback=None,
    ) -> Tuple[RBCDState, Dict]:
        """Host-side round driver replicating the reference leader protocol
        (SURVEY.md §3.2): scheduled block updates, GNC weight rounds every
        ``robust_opt_inner_iters_per_robot × num_robots`` iterations, and
        relative-change termination once every robot is ready.

        Returns (final_state, info) where info carries per-iteration history
        with the reference telemetry fields (SURVEY.md §5.1).
        """
        cfg = self.config
        prob = self.problem
        if state is None:
            state = self.initialize()
        max_iters = max_iters or cfg.max_iteration_number
        # Uniform rule: same counter-based PRNG as make_fused_run (fold the
        # seed key with the global iteration index) so host-driven and fused
        # runs take identical schedules for all three update rules
        key0 = jax.random.PRNGKey(cfg.seed)
        # weight rounds run for every robust cost: graduated (GNC_TLS) or
        # plain IRLS reweighting (L1/Huber/TLS/GM)
        gnc = cfg.robust_cost_type != RobustCostType.L2
        inner = cfg.robust_opt_inner_iters_per_robot * prob.num_robots
        history: Dict[str, list] = {
            "iteration": [],
            "cost": [],
            "rel_change": [],
            "rel_change_robots": [],  # (R,) per iteration — CSV telemetry
            "iter_time_sec": [],
            "event": [],
        }
        t_start = time.time()
        it = 0
        cache = self._solver_cache(self._edges(state.weights))
        last_wu_gi = int(state.iteration)
        while it < max_iters:
            # GNC outer round? (global iteration counter — matches the fused
            # path and stays on the same cadence across checkpoint resumes)
            gi = int(state.iteration)
            if cfg.robust_opt_inner_tol is not None:
                # convergence-gated rounds: fire once every robot's block
                # has settled below inner_tol (residuals then sit at the
                # weighted optimum — schedule-independent); the fixed
                # cadence stays as a budget cap
                fire = bool(
                    np.all(
                        np.asarray(state.rel_change)
                        < cfg.robust_opt_inner_tol
                    )
                ) or (gi - last_wu_gi) >= inner
            else:
                fire = gi % inner == 0
            if gnc and gi > 0 and fire and (
                state.weight_update_count < cfg.robust_opt_num_weight_updates
            ):
                last_wu_gi = gi
                state = self._weight_upd(state)
                cache = self._solver_cache(self._edges(state.weights))
                history["event"].append((it, "UPDATE_WEIGHT"))
                # optional re-initialization after early weight updates
                # (robustOptNumResets, reference PGOAgentROSNode.cpp:212-221)
                if state.weight_update_count <= cfg.robust_opt_num_resets:
                    w, fm, mu, wuc = (
                        state.weights,
                        state.fixed_mask,
                        state.mu,
                        state.weight_update_count,
                    )
                    st2 = self.initialize()
                    state = st2._replace(
                        weights=w,
                        fixed_mask=fm,
                        mu=mu,
                        weight_update_count=wuc,
                        iteration=state.iteration,
                        cost=quadratic.cost(st2.X, self._edges(w)),
                    )
            t0 = time.time()
            if cfg.update_rule == UpdateRule.PARALLEL:
                c = int(state.iteration) % self.num_colors
                state, rc = self._step_par(state, jnp.asarray(c), cache)
            else:
                if cfg.update_rule == UpdateRule.ROUND_ROBIN:
                    k = int(state.iteration) % prob.num_robots
                else:
                    k = int(
                        jax.random.randint(
                            jax.random.fold_in(key0, int(state.iteration)),
                            (),
                            0,
                            prob.num_robots,
                        )
                    )
                state, rc = self._step_seq(state, jnp.asarray(k), cache)
            state.cost.block_until_ready()
            dt = time.time() - t0
            it += 1
            history["iteration"].append(it)
            history["cost"].append(float(state.cost))
            history["rel_change"].append(float(rc))
            history["rel_change_robots"].append(
                np.asarray(state.rel_change, np.float64)
            )
            history["iter_time_sec"].append(dt)
            if callback is not None:
                callback(it, state)
            # termination: all robots' last relative change below tol
            # (reference readyToTerminate gossip, PGOAgentROS.cpp:192-217),
            # and no pending GNC weight rounds
            ready = bool(
                np.all(
                    np.asarray(state.rel_change)
                    < cfg.relative_change_tolerance
                )
            )
            gnc_done = (not gnc) or (
                int(state.weight_update_count)
                >= cfg.robust_opt_num_weight_updates
            )
            if ready and gnc_done:
                break
        info = {
            "history": history,
            "iterations": it,
            "total_time_sec": time.time() - t_start,
            "final_cost": float(state.cost),
            "converged": bool(
                np.all(
                    np.asarray(state.rel_change) < cfg.relative_change_tolerance
                )
            ),
        }
        if gnc:
            acc, rej, und = robust.classify_weights(
                state.weights, prob.edges.is_loop, prob.edges.mask
            )
            total = int(acc) + int(rej) + int(und)
            ratio = (int(acc) + int(rej)) / max(total, 1)
            info["gnc_stats"] = {
                "accepted": int(acc),
                "rejected": int(rej),
                "undecided": int(und),
                "convergence_ratio": ratio,
            }
            # reference robustOptMinConvergenceRatio gate
            # (``PGOAgentROSNode.cpp:212-221``)
            info["gnc_converged"] = (
                ratio >= cfg.robust_opt_min_convergence_ratio
            )
        return state, info

    def make_fused_run(self, max_iters: int, record: bool = False):
        """Return a jitted runner executing the FULL solve as one XLA program
        (`lax.while_loop` over block updates with on-device termination and
        GNC weight rounds under `lax.cond`): zero host round-trips, one
        dispatch for the entire optimization.

        ``robust_opt_num_resets`` re-initialization runs on-device: after
        each of the first ``num_resets`` weight updates the iterate resets to
        the run's starting state (the reference's setXToInitialGuess
        semantics — DPGO resets the trajectory to the initial guess after
        early weight updates; wrapper param ``PGOAgentROSNode.cpp:213``).
        Uniform update rule uses the on-device PRNG.

        With ``record=True`` the runner returns
        ``(state, rel_hist, event_hist)`` — per-iteration (max_iters, R)
        relative changes and (max_iters,) UPDATE_WEIGHT flags collected
        on-device (the reference's per-iteration CSV telemetry fields,
        ``src/PGOAgentROS.cpp:853-907``; rows past the final iteration are
        NaN/0).
        """
        cfg = self.config
        prob = self.problem
        gnc = cfg.robust_cost_type != RobustCostType.L2  # any robust cost
        inner = cfg.robust_opt_inner_iters_per_robot * prob.num_robots
        tol = cfg.relative_change_tolerance
        key0 = jax.random.PRNGKey(cfg.seed)

        def make_do_iter(X_init):
          def do_iter(carry):
            st, cache, last_wu, rel_h, ev_h = carry
            i = st.iteration
            wu_fired = jnp.asarray(False)
            if gnc:
                def wu(args):
                    s, _ = args
                    s2 = self._weight_update_impl(s)
                    if cfg.robust_opt_num_resets > 0:
                        # reset-to-initial-guess after early weight updates
                        do_reset = (
                            s2.weight_update_count
                            <= cfg.robust_opt_num_resets
                        )
                        Xr = jnp.where(do_reset, X_init, s2.X)
                        s2 = s2._replace(
                            X=Xr,
                            X_prev=Xr,
                            V=Xr,
                            cost=quadratic.cost(
                                Xr, self._edges(s2.weights)
                            ),
                        )
                    # weights changed → refresh the cached solver constants
                    return s2, self._solver_cache(self._edges(s2.weights))

                if cfg.robust_opt_inner_tol is not None:
                    fire = jnp.all(
                        st.rel_change < cfg.robust_opt_inner_tol
                    ) | ((i - last_wu) >= inner)
                else:
                    fire = jnp.mod(i, inner) == 0
                wu_fired = (
                    (i > 0)
                    & fire
                    & (st.weight_update_count < cfg.robust_opt_num_weight_updates)
                )
                last_wu = jnp.where(wu_fired, i, last_wu)
                st, cache = jax.lax.cond(
                    wu_fired,
                    wu,
                    lambda a: a,
                    (st, cache),
                )
            if cfg.update_rule == UpdateRule.PARALLEL:
                st2, _ = self._step_parallel_impl(
                    st, jnp.mod(i, self.num_colors), cache
                )
            elif cfg.update_rule == UpdateRule.ROUND_ROBIN:
                st2, _ = self._step_sequential_impl(
                    st, jnp.mod(i, prob.num_robots), cache
                )
            else:
                k = jax.random.randint(
                    jax.random.fold_in(key0, i), (), 0, prob.num_robots
                )
                st2, _ = self._step_sequential_impl(st, k, cache)
            if record:
                rel_h = rel_h.at[i].set(st2.rel_change)
                ev_h = ev_h.at[i].set(wu_fired.astype(jnp.int8))
            return st2, cache, last_wu, rel_h, ev_h
          return do_iter

        def cond_fn(carry):
            st, *_ = carry
            ready = jnp.all(st.rel_change < tol)
            if gnc:
                ready = ready & (
                    st.weight_update_count >= cfg.robust_opt_num_weight_updates
                )
            return (st.iteration < max_iters) & ~ready

        @jax.jit
        def run(st: RBCDState):
            cache = self._solver_cache(self._edges(st.weights))
            if record:
                rel_h = jnp.full(
                    (max_iters, prob.num_robots), jnp.nan, self.dtype
                )
                ev_h = jnp.zeros((max_iters,), jnp.int8)
            else:
                rel_h = ev_h = jnp.zeros((), jnp.int8)
            out, _, _, rel_h, ev_h = jax.lax.while_loop(
                cond_fn,
                make_do_iter(st.X),
                (st, cache, st.iteration, rel_h, ev_h),
            )
            if record:
                return out, rel_h, ev_h
            return out

        return run

    def finalize(self, state: RBCDState) -> Tuple[np.ndarray, RBCDState]:
        """TERMINATE semantics (reference ``PGOAgentROS.cpp:1036-1082``):
        resolve undecided GNC weights (by final residual when
        ``gnc_finalize_by_residual``, else reject), round to SE(d), anchor
        the first pose."""
        if self.config.robust_cost_type == RobustCostType.GNC_TLS:
            und = (
                (self.problem.edges.is_loop > 0)
                & (state.weights > 1e-6)
                & (state.weights < 1.0 - 1e-6)
            )
            if self.config.gnc_finalize_by_residual:
                T = rounding.round_solution(state.X)
                r = robust.measurement_residuals(
                    T, self._edges(state.weights)
                )
                w = jnp.where(
                    und,
                    (r <= self.config.GNC_barc).astype(state.weights.dtype),
                    state.weights,
                )
            else:
                w = jnp.where(und, 0.0, state.weights)
            state = state._replace(weights=w)
        T = rounding.round_solution(state.X)
        T = rounding.anchor_to_first_pose(T)
        return np.asarray(T), state
