"""CLI layer tests: parameter surface parity and demo presets."""

import numpy as np

from dpgo_ros_tpu.cli import apply_demo, args_to_config, build_parser
from dpgo_ros_tpu.io.datasets import golden_optimum
from dpgo_ros_tpu.utils.config import (
    InitMethod,
    RobustCostType,
    SolverMethod,
    UpdateRule,
)


def test_defaults_match_reference_launch():
    """Defaults must equal the reference launch template
    (``launch/PGOAgent.launch:9-50``)."""
    a = build_parser().parse_args([])
    cfg = args_to_config(a)
    assert cfg.relaxation_rank == 5
    assert cfg.asynchronous is False
    assert cfg.RGD_stepsize == 1e-3
    assert cfg.RTR_iterations == 3
    assert cfg.RTR_tCG_iterations == 50
    assert cfg.local_initialization_method == InitMethod.ODOMETRY
    assert cfg.update_rule == UpdateRule.UNIFORM
    assert cfg.acceleration is False
    assert cfg.restart_interval == 50
    assert cfg.robust_cost_type == RobustCostType.L2
    assert cfg.GNC_quantile == 0.9
    assert cfg.GNC_barc == 5.0
    assert cfg.GNC_mu_step == 2.0
    assert cfg.GNC_init_mu == 1e-5
    assert cfg.robust_opt_num_weight_updates == 4
    assert cfg.robust_opt_inner_iters_per_robot == 10
    assert cfg.max_iteration_number == 1000
    assert cfg.relative_change_tolerance == 0.1
    assert cfg.max_distributed_init_steps == 30
    assert cfg.timeout_threshold == 15.0
    # reference default 3 (``PGOAgentROS.h:74-86``)
    assert cfg.max_delayed_iterations == 3
    assert cfg.weight_convergence_threshold == -1.0
    assert cfg.synchronize_measurements is True


def test_resolve_derivations():
    """Derived params (reference ``PGOAgentROSNode.cpp:82-93, 196-232``)."""
    a = build_parser().parse_args(
        ["--robust_cost_type", "GNC_TLS", "--num_robots", "8",
         "--robust_opt_num_weight_updates", "3",
         "--robust_opt_inner_iters_per_robot", "50",
         "--GNC_use_probability", "true", "--GNC_quantile", "0.9"]
    )
    cfg = args_to_config(a).resolve()
    # solver pick: sync → RTR
    assert cfg.solver == SolverMethod.RTR
    # GNC budget: (K+1)·inner·R − 2
    assert cfg.max_iteration_number == (3 + 1) * 50 * 8 - 2
    # χ²(3) 0.9-quantile ≈ 6.2514 → barc = sqrt ≈ 2.5003
    assert abs(cfg.GNC_barc - np.sqrt(6.251389)) < 1e-3
    # async pick: RGD
    a2 = build_parser().parse_args(["--asynchronous", "true"])
    assert args_to_config(a2).resolve().solver == SolverMethod.RGD


def test_demo_presets():
    a = build_parser().parse_args(["--demo", "dpgo_demo"])
    apply_demo(a)
    assert a.num_robots == 5
    assert a.update_rule == "RoundRobin"
    assert a.local_initialization_method == "Chordal"
    assert a.relative_change_tolerance == 0.2
    a = build_parser().parse_args(["--demo", "dpgo_gnc_demo"])
    apply_demo(a)
    assert a.num_robots == 8
    assert a.robust_cost_type == "GNC_TLS"
    assert a.GNC_barc == 3.0
    assert a.robust_opt_inner_iters_per_robot == 50
    assert a.synchronize_measurements is False
    a = build_parser().parse_args(["--demo", "asapp_demo"])
    apply_demo(a)
    assert a.asynchronous and a.RGD_stepsize == 0.2


def test_gnc_schedule_flags_round_trip():
    a = build_parser().parse_args(
        ["--GNC_schedule", "reference", "--gnc_finalize_by_residual", "false"]
    )
    cfg = args_to_config(a)
    assert cfg.GNC_schedule == "reference"
    assert cfg.gnc_finalize_by_residual is False


def test_async_mode_uses_per_tick_tolerance():
    """The async engine terminates on ``asapp_tolerance`` (per-tick movement
    scale), NOT the sync ``relative_change_tolerance`` — a 0.1-scale sync
    tolerance fires on the very first one-RGD-step tick (regression: the
    async CLI "converged" after 1 tick at the init cost)."""
    a = build_parser().parse_args([])
    cfg = args_to_config(a)
    assert cfg.asapp_tolerance == 1e-3
    # flag round-trips independently of the sync tolerance
    a = build_parser().parse_args(
        ["--asapp_tolerance", "1e-4", "--relative_change_tolerance", "0.2"]
    )
    cfg = args_to_config(a)
    assert cfg.asapp_tolerance == 1e-4
    assert cfg.relative_change_tolerance == 0.2


def test_cli_dtype_float64_enables_x64():
    """``--dtype float64`` must enable jax x64 inside ``main()`` — without it
    the solver state silently truncates to fp32 (regression: the advertised
    ``--certify --dtype float64`` recipe ran fp32 and reported a criticality
    residual 5 orders of magnitude worse). Run in a subprocess because the
    test session's own x64 flag (conftest) would mask the bug in-process."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    out = subprocess.run(
        [
            sys.executable, "-m", "dpgo_ros_tpu.cli",
            "--dataset", "synthetic_grid9", "--platform", "cpu",
            "--dtype", "float64",
            "--relative_change_tolerance", "1e-6",
            "--RTR_gradnorm_tol", "1e-9",
        ],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    # fp64 reaches the certified optimum to ~1e-9; fp32 is ~3e-6 off
    assert abs(res["final_cost"] - golden_optimum("synthetic_grid9")) < 1e-7


def _run_off_gpu(args):
    """Run a repo entry point in a fresh CPU-only process."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    return subprocess.run(
        [sys.executable, *args], env=env, cwd=repo,
        capture_output=True, text=True, timeout=300,
    )


def test_platform_gpu_fails_cleanly_without_a_card():
    """``--platform gpu`` (the default) never falls back to the CPU: with
    no card the CLI exits 2 with a one-line error and prints no result."""
    out = _run_off_gpu(
        ["-m", "dpgo_ros_tpu.cli", "--dataset", "synthetic_grid9",
         "--platform", "gpu"]
    )
    assert out.returncode == 2
    assert out.stdout == ""
    assert "no GPU" in out.stderr and "Traceback" not in out.stderr


def test_bench_refuses_to_run_off_gpu():
    out = _run_off_gpu(["bench.py"])
    assert out.returncode != 0
    assert out.stdout == ""
    assert "GPU" in out.stderr


def test_bundled_dataset_without_data_dir_is_an_error():
    """A bundled name never silently becomes a generated world."""
    out = _run_off_gpu(
        ["-m", "dpgo_ros_tpu.cli", "--dataset", "sphere2500",
         "--platform", "cpu"]
    )
    assert out.returncode == 2
    assert out.stdout == ""
    assert "DPGO_TPU_DATA_DIR" in out.stderr


def test_demo_presets_use_generated_worlds():
    for demo, world in (("dpgo_demo", "synthetic_sphere2500"),
                        ("asapp_demo", "synthetic_sphere2500"),
                        ("dpgo_gnc_demo", "synthetic_gnc8")):
        a = build_parser().parse_args(["--demo", demo])
        apply_demo(a)
        assert a.dataset == world
    # an explicit dataset wins over the preset's world
    a = build_parser().parse_args(
        ["--demo", "dpgo_demo", "--dataset", "synthetic_grid125"]
    )
    apply_demo(a)
    assert a.dataset == "synthetic_grid125"
