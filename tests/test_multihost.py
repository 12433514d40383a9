"""Multi-host (multi-process) SPMD path — SURVEY.md §7 step 8.

The reference scales robot count by adding ROS processes on a network
(reference `src/PGOAgentROS.cpp:45-82`); here the same shard_map
program spans hosts: 2 CPU processes × 4 virtual devices = one global
8-device mesh with Gloo collectives standing in for DCN. Launches
``scripts/multihost_demo.py`` as real subprocesses (jax.distributed
requires one process per host) and checks the processes rendezvous,
descend, and agree bit-exactly on the converged cost.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "multihost_demo.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_mesh_agrees_and_descends(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    # children pick their own virtual-device flags; drop this process's
    env.pop("XLA_FLAGS", None)
    procs = []
    for pid in range(2):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    SCRIPT,
                    "--num_processes",
                    "2",
                    "--process_id",
                    str(pid),
                    "--coordinator",
                    f"localhost:{port}",
                    "--steps",
                    "12",
                ],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                env=env,
                text=True,
            )
        )
    results = {}
    for pid, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"proc {pid} failed:\n{err[-3000:]}"
        line = [l for l in out.splitlines() if l.startswith("MULTIHOST_RESULT")]
        assert line, f"no result line from proc {pid}:\n{out[-2000:]}"
        results[pid] = json.loads(line[0].split(" ", 1)[1])

    r0, r1 = results[0], results[1]
    assert r0["global_devices"] == 8 and r0["num_processes"] == 2
    # both processes observe the identical global state (bit-exact SPMD)
    assert r0["final_cost"] == r1["final_cost"]
    assert r0["init_cost"] == r1["init_cost"]
    # and the distributed solve actually descends substantially
    assert r0["final_cost"] < 0.1 * r0["init_cost"]


def _launch(num_processes: int, steps: int, extra=(), local_devices=4,
            timeout=540):
    """Run the multihost demo as real subprocesses; returns per-pid results."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [
                sys.executable, SCRIPT,
                "--num_processes", str(num_processes),
                "--process_id", str(pid),
                "--coordinator", f"localhost:{port}",
                "--steps", str(steps),
                "--local_devices", str(local_devices),
                *extra,
            ],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, text=True,
        )
        for pid in range(num_processes)
    ]
    results = {}
    for pid, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"proc {pid} failed:\n{err[-3000:]}"
        line = [l for l in out.splitlines()
                if l.startswith("MULTIHOST_RESULT")]
        assert line, f"no result from proc {pid}:\n{out[-2000:]}"
        results[pid] = json.loads(line[0].split(" ", 1)[1])
    return results


def test_three_process_mesh_agrees(tmp_path):
    """≥3-host case (VERDICT r1 weak #5): 3 processes × 2 virtual devices =
    a 6-robot global mesh; all processes agree bit-exactly and descend."""
    res = _launch(3, 8, local_devices=2)
    costs = {r["final_cost"] for r in res.values()}
    assert len(costs) == 1
    r0 = res[0]
    assert r0["global_devices"] == 6 and r0["num_processes"] == 3
    assert r0["final_cost"] < 0.5 * r0["init_cost"]


def test_multihost_kill_and_restart_resumes_bitexact(tmp_path):
    """Fault/restart case: the whole multi-process job dies after 6 steps;
    a fresh set of processes resumes from the durable checkpoint (written
    collectively via DCN all-gather, loaded by every process) and lands on
    the bit-exact state of an uninterrupted 12-step run."""
    ck = str(tmp_path / "mh_ck")
    full = _launch(2, 12)
    _launch(2, 6, extra=("--checkpoint_dir", ck))
    resumed = _launch(2, 12, extra=("--resume", ck))
    assert resumed[0]["final_cost"] == full[0]["final_cost"]
