"""Asynchronous (ASAPP) mode: bounded-staleness parallel local stepping.

Capability parity with the reference's asynchronous mode
(``runOnceAsynchronous``, ``src/PGOAgentROS.cpp:119-127``; RGD solver pick at
``src/PGOAgentROSNode.cpp:87-93``; demo config ``launch/asapp_demo.launch``:
RGD stepsize 0.2, preconditioner, 100 Hz local loop): every robot runs its
own preconditioned Riemannian-gradient loop continuously, reading neighbor
separator poses that may be several iterations stale (ASAPP, Tian et al.
RA-L 2020 — convergence holds under bounded delay with small stepsizes).

Design: real wall-clock asynchrony doesn't exist in lockstep SPMD,
so asynchrony is modeled as *deterministic bounded staleness* — a ring buffer
of the last K+1 global states; at tick t robot k sees its own block at t and
every neighbor at t − δ_k(t), δ_k(t) ~ U{0..K} from a seeded PRNG (δ ≡ 0
reproduces the synchronous parallel limit; ``max_delayed_iterations`` is the
reference's staleness gate, ``PGOAgentROS.h:62-63``). Every tick updates ALL
robots simultaneously — one jitted ``lax.while_loop``, reproducible, and
exactly the claim the ASAPP paper makes (parallel updates under delay).

Tick semantics: the reference spins the local RGD loop at
``asynchronous_rate`` Hz while poses are exchanged by the ~100 Hz ROS spin —
i.e. ≈ rate/100 local gradient steps happen per communication round. Here one
*tick* is one communication round and executes ``steps_per_tick =
max(1, round(asynchronous_rate / 100))`` local RGD steps per robot against
frozen (stale) neighbor separators.

Termination is the reference's ``readyToTerminate`` gossip analogue, but on
a *per-tick movement* scale: every robot's block-Frobenius movement per tick
must fall below ``asapp_tolerance`` (see ``utils/config.py``) — evaluated
on-device inside the fused while_loop, zero host round-trips. This is
deliberately a separate knob from the synchronous engine's
``relative_change_tolerance``: a tick moves the block by γ·‖grad‖ (one or a
few RGD steps), not by a full block solve, so the same numeric threshold
means a far stricter stop in async mode.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dpgo_ros_tpu.models.local_solvers import RGDParams
from dpgo_ros_tpu.models.problem import LiftedProblem
from dpgo_ros_tpu.ops import quadratic, stiefel
from dpgo_ros_tpu.utils.config import AgentConfig


class ASAPPState(NamedTuple):
    X: jnp.ndarray  # (n, r, d+1) current global state
    hist: jnp.ndarray  # (K+1, n, r, d+1) ring buffer of past states
    tick: jnp.ndarray  # i32
    key: jnp.ndarray
    rel_change: jnp.ndarray  # (R,) per-robot block-Frobenius movement/tick


class ASAPPEngine:
    """Bounded-staleness asynchronous PGO over one device (vmap over robots);
    the SPMD analogue delays the all_gathered separator snapshots instead."""

    def __init__(self, problem: LiftedProblem, config: AgentConfig):
        self.problem = problem
        self.config = config.resolve()
        self.dtype = (
            jnp.float64 if self.config.dtype == "float64" else jnp.float32
        )
        self.K = int(self.config.max_delayed_iterations)
        self.rgd = RGDParams(
            stepsize=self.config.RGD_stepsize,
            use_preconditioner=self.config.RGD_use_preconditioner,
        )
        # local-loop rate → gradient steps per communication tick
        self.steps_per_tick = max(
            1, int(round(self.config.asynchronous_rate / 100.0))
        )
        rof = np.asarray(problem.robot_of_pose)
        np_dt = np.float64 if self.dtype == jnp.float64 else np.float32
        self._masks = jnp.asarray(
            np.stack(
                [
                    (rof == k).astype(np_dt)[:, None, None]
                    for k in range(problem.num_robots)
                ],
                axis=0,
            )
        )  # (R, n, 1, 1)
        # robust weights are FIXED during an async run (no UPDATE_WEIGHT
        # rounds in the reference async mode) → the block-Jacobi inverse is
        # computed once, not per tick
        e = problem.edges
        self._Pinv = quadratic.precond_inverse(
            quadratic.precond_blocks(e, problem.n)
        )
        self._tick = jax.jit(self._tick_impl)

    def init_state(self, X0: jnp.ndarray, key=None) -> ASAPPState:
        key = key if key is not None else jax.random.PRNGKey(self.config.seed)
        hist = jnp.broadcast_to(X0, (self.K + 1,) + X0.shape)
        return ASAPPState(
            X=X0,
            hist=hist,
            tick=jnp.asarray(0, jnp.int32),
            key=key,
            rel_change=jnp.full(
                (self.problem.num_robots,), jnp.inf, self.dtype
            ),
        )

    def _stepsize_at(self, tick):
        """γ_t: constant, or O(1/t)-decayed when ``asapp_stepsize_decay_ticks``
        is set. A constant stepsize under bounded staleness converges to a
        noise ball around the optimum whose radius scales with γ·K (delayed
        gradients act as bounded-bias noise); the classic stochastic-
        approximation remedy γ_t = γ₀·T₀/(T₀+t) drives the ball to zero
        while Σγ_t = ∞ keeps global reach. The reference's fixed-rate local
        loop has the same plateau (ASAPP, Tian et al. RA-L 2020, guarantees
        criticality for *sufficiently small* constant γ only)."""
        T0 = float(getattr(self.config, "asapp_stepsize_decay_ticks", 0) or 0)
        g0 = self.rgd.stepsize
        if T0 <= 0:
            return jnp.asarray(g0, self.dtype)
        t = tick.astype(self.dtype)
        return jnp.asarray(g0, self.dtype) * T0 / (T0 + t)

    def _tick_impl(self, st: ASAPPState) -> ASAPPState:
        prob = self.problem
        R = prob.num_robots
        key, sub = jax.random.split(st.key)
        delays = jax.random.randint(sub, (R,), 0, self.K + 1)
        e = prob.edges
        P = self._Pinv
        gamma = self._stepsize_at(st.tick)

        def one_robot(mask, delay):
            # robot's view: own block fresh, neighbors delayed; the local
            # loop runs steps_per_tick gradient steps before the next
            # separator exchange (asynchronous_rate semantics)
            stale = st.hist[delay % (self.K + 1)]
            Z = jnp.where(mask > 0, st.X, stale)

            def body(_, Zc):
                g = mask * quadratic.rgrad(Zc, e)
                if self.rgd.use_preconditioner and P is not None:
                    g = mask * stiefel.proj_tangent(
                        Zc, quadratic.precond_apply(P, g)
                    )
                return stiefel.retract_polar_ns(Zc, -gamma * g)

            return jax.lax.fori_loop(0, self.steps_per_tick, body, Z)

        Z_all = jax.vmap(one_robot)(self._masks, delays)
        own = jnp.sum(self._masks, axis=0)  # 1.0 on every owned pose
        X_new = jnp.sum(Z_all * self._masks, axis=0) + st.X * (1.0 - own)
        # per-robot movement this tick (termination telemetry — the Status
        # relative_change analogue)
        per_pose2 = jnp.sum((X_new - st.X) ** 2, axis=(-2, -1))  # (n,)
        moved = jnp.sqrt(
            jnp.sum(
                self._masks[:, :, 0, 0] * per_pose2[None, :], axis=1
            )
        )
        # ring buffer: slot (tick mod K+1) ← current state
        hist = st.hist.at[st.tick % (self.K + 1)].set(st.X)
        return ASAPPState(
            X=X_new, hist=hist, tick=st.tick + 1, key=key, rel_change=moved
        )

    def make_fused_run(self, tol: float = 0.0, record_upto: int = 0):
        """Jitted runner ``run(state, until_tick)``: async ticks as one XLA
        program — `lax.while_loop` with on-device relative-change
        termination (tol 0 disables early exit → exactly ``until_tick``).
        ``until_tick`` is a traced argument, so chunked drivers reuse one
        compilation.

        ``record_upto > 0`` collects per-tick (record_upto, R) relative
        changes on-device (rows past the final tick stay NaN) and the
        runner returns ``(state, rel_hist)`` — per-iteration CSV telemetry
        without a host sync per tick (reference schema
        ``src/PGOAgentROS.cpp:853-894``)."""
        @jax.jit
        def run(st: ASAPPState, until_tick, hist=None):
            def cond(c):
                s = c[0]
                keep = s.tick < until_tick
                if tol > 0:
                    keep = keep & ~jnp.all(s.rel_change < tol)
                return keep

            def body(c):
                s, h = c
                s2 = self._tick_impl(s)
                if record_upto:
                    h = h.at[s.tick].set(s2.rel_change)
                return s2, h

            h0 = hist if hist is not None else jnp.zeros((), jnp.int8)
            s, h = jax.lax.while_loop(cond, body, (st, h0))
            return (s, h) if record_upto else s

        return run

    def run(
        self,
        X0: Optional[jnp.ndarray] = None,
        num_ticks: int = 1000,
        chunk: int = 200,
        tol: float = 0.0,
        state: Optional[ASAPPState] = None,
        record: bool = False,
        on_chunk=None,
    ) -> Tuple[ASAPPState, dict]:
        """Run up to ``num_ticks`` asynchronous ticks (chunked fused
        while_loops — each chunk is one dispatch) with optional
        relative-change termination at ``tol``. Pass ``state`` (e.g. a
        restored checkpoint) to continue a run instead of ``X0``;
        ``record=True`` collects per-tick per-robot relative changes
        (info["rel_hist"], NaN rows dropped) for CSV telemetry.
        ``on_chunk(tick, state)`` fires after each chunk — the hook for
        mid-run snapshots (the reference's viz timer cadence)."""
        st = state if state is not None else self.init_state(X0)
        e = self.problem.edges
        costs = [float(quadratic.cost(st.X, e))]
        rel_rows = []

        done = int(st.tick)
        t_anchor = done
        runner = self.make_fused_run(tol, record_upto=int(record))
        hist = (
            jnp.full(
                (num_ticks, self.problem.num_robots), jnp.nan, self.dtype
            )
            if record
            else None
        )
        while done < num_ticks:
            until = min(done + chunk, num_ticks)
            if record:
                st, hist = runner(st, jnp.asarray(until, jnp.int32), hist)
            else:
                st = runner(st, jnp.asarray(until, jnp.int32))
            t = int(st.tick)
            costs.append(float(quadratic.cost(st.X, e)))
            if on_chunk is not None:
                on_chunk(t, st)
            converged = tol > 0 and bool(
                np.all(np.asarray(st.rel_change) < tol)
            )
            if converged:
                done = t
                break
            done = t
        if record:
            h = np.asarray(hist, np.float64)
            # ticks executed before this run (resume) are not in the buffer
            rel_rows = h[~np.all(np.isnan(h), axis=1)]
        return st, {
            "costs": costs,
            "ticks": done,
            "ticks_this_run": done - t_anchor,
            "converged": tol > 0
            and bool(np.all(np.asarray(st.rel_change) < tol)),
            "rel_change": np.asarray(st.rel_change).tolist(),
            **({"rel_hist": rel_rows} if record else {}),
        }
