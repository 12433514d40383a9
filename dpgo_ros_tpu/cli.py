"""Command-line entry point — the reference's launch-file layer (SURVEY.md
§1-L6, §6).

Demo configs mirror the reference launch files:

* ``dpgo_demo``  — 5 robots on the generated 2,500-pose sphere world
  (sphere2500's shape), synchronous RBCD, RoundRobin, chordal init,
  rel-change tol 0.2 (``launch/dpgo_demo.launch``)
* ``asapp_demo`` — the same world, asynchronous RGD stepsize 0.2
  (``launch/asapp_demo.launch``)
* ``dpgo_gnc_demo`` — 8 robots on a generated world with labeled outlier
  loop closures, GNC_TLS barc 3.0, 3 weight updates × 50 inner iters
  (``launch/dpgo_gnc_demo.launch``)

Every reference parameter (``launch/PGOAgent.launch:9-50``) is exposed as a
flag with the same name and default.

Examples::

  python -m dpgo_ros_tpu.cli --demo dpgo_demo --output out/demo
  python -m dpgo_ros_tpu.cli --g2o my_graph.g2o --num_robots 5 \
      --update_rule RoundRobin --acceleration true
  python -m dpgo_ros_tpu.cli --demo dpgo_demo --mode fleet --platform cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def _bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dpgo_ros_tpu",
        description="Distributed pose-graph optimization on an accelerator",
    )
    from dpgo_ros_tpu import __version__

    p.add_argument(
        "--version", action="version",
        version=f"%(prog)s {__version__}",
    )
    p.add_argument("--demo", choices=["dpgo_demo", "asapp_demo", "dpgo_gnc_demo"])
    p.add_argument("--g2o", help="path to a g2o dataset file")
    p.add_argument(
        "--dataset",
        help="a generated world (synthetic_grid9, synthetic_grid125, "
        "synthetic_sphere2500, synthetic_gnc8) or a bundled dataset name "
        "(e.g. sphere2500), read from DPGO_TPU_DATA_DIR",
    )
    p.add_argument(
        "--frontend", metavar="HOST:PORT",
        help="pull pose graphs from an out-of-process front-end service "
             "(parallel/frontend.py — the reference request_pose_graph "
             "service analog) and push solved trajectories back to it",
    )
    p.add_argument("--csv", nargs="*", help="per-robot measurements.csv paths")
    p.add_argument(
        "--synthetic", choices=["sphere", "grid3d"],
        help="generate a synthetic world with exact ground truth "
             "(io/synthetic.py) instead of loading a dataset; summary "
             "gains ate_vs_ground_truth (+outlier precision/recall under "
             "GNC)",
    )
    p.add_argument("--synthetic_n", type=int, default=1000,
                   help="number of poses (sphere) / lattice size n^(1/3) "
                        "rounded (grid3d)")
    p.add_argument("--synthetic_outlier_ratio", type=float, default=0.0)
    p.add_argument("--synthetic_rot_noise", type=float, default=0.01)
    p.add_argument("--synthetic_trans_noise", type=float, default=0.05)
    p.add_argument(
        "--mode",
        choices=["engine", "fused", "fleet", "spmd", "async"],
        default="engine",
        help="engine: host-driven solver; fused: single XLA program; "
        "fleet: full distributed protocol simulation; spmd: device mesh; "
        "async: bounded-staleness ASAPP engine (auto-selected when "
        "--asynchronous is set and mode is 'engine')",
    )
    p.add_argument("--output", help="output prefix for trajectory export")
    p.add_argument(
        "--platform", choices=["cpu", "gpu"], default="gpu",
        help="backend to run on; gpu fails when no CUDA device is present",
    )
    p.add_argument("--cpu_devices", type=int, default=8)
    p.add_argument(
        "--checkpoint_dir",
        help="directory for periodic solver-state checkpoints "
        "(capability beyond the reference, which has no persistence)",
    )
    p.add_argument(
        "--checkpoint_every",
        type=int,
        default=50,
        help="checkpoint cadence in block updates (engine mode)",
    )
    p.add_argument(
        "--resume",
        help="checkpoint path to resume from, or 'latest' to pick the "
        "newest step under --checkpoint_dir",
    )
    p.add_argument(
        "--profile_dir",
        help="capture a JAX/XLA device trace of the solve into this dir "
        "(TensorBoard/Perfetto format)",
    )

    # reference parameter surface (launch/PGOAgent.launch:9-50)
    p.add_argument("--num_robots", type=int, default=1)
    p.add_argument(
        "--partition_balance", choices=["poses", "work"], default="poses",
        help="contiguous partition cut rule: 'poses' = reference equal-"
             "pose-count blocks; 'work' = balance poses + owned edges",
    )
    p.add_argument("--dimension", type=int, default=3)
    p.add_argument("--relaxation_rank", type=int, default=5)
    p.add_argument("--asynchronous", type=_bool, default=False)
    p.add_argument("--asynchronous_rate", type=float, default=10.0)
    p.add_argument("--RGD_stepsize", type=float, default=1e-3)
    p.add_argument("--RGD_use_preconditioner", type=_bool, default=True)
    p.add_argument("--RTR_iterations", type=int, default=3)
    p.add_argument("--RTR_tCG_iterations", type=int, default=50)
    p.add_argument("--RTR_gradnorm_tol", type=float, default=1e-2)
    p.add_argument(
        "--local_initialization_method",
        choices=["Odometry", "Chordal", "GNC_TLS"],
        default="Odometry",
    )
    p.add_argument(
        "--update_rule",
        choices=["Uniform", "RoundRobin", "Parallel"],
        default="Uniform",
    )
    p.add_argument("--multirobot_initialization", type=_bool, default=True)
    p.add_argument("--acceleration", type=_bool, default=False)
    p.add_argument("--restart_interval", type=int, default=50)
    p.add_argument(
        "--robust_cost_type",
        choices=["L2", "L1", "Huber", "TLS", "GM", "GNC_TLS"],
        default="L2",
    )
    p.add_argument("--GNC_use_probability", type=_bool, default=True)
    p.add_argument("--GNC_quantile", type=float, default=0.9)
    p.add_argument("--GNC_barc", type=float, default=5.0)
    p.add_argument("--GNC_mu_step", type=float, default=2.0)
    p.add_argument("--GNC_init_mu", type=float, default=1e-5)
    p.add_argument(
        "--GNC_schedule",
        choices=["adaptive", "geometric", "reference"],
        default="adaptive",
        help="mu schedule; 'reference' reproduces the reference "
        "init_mu*mu_step^k parameterization",
    )
    p.add_argument("--GNC_mu_start", type=float, default=0.05)
    p.add_argument("--GNC_mu_end", type=float, default=1e3)
    p.add_argument("--gnc_finalize_by_residual", type=_bool, default=True)
    p.add_argument("--robust_opt_num_weight_updates", type=int, default=4)
    p.add_argument("--robust_opt_num_resets", type=int, default=0)
    p.add_argument("--robust_opt_min_convergence_ratio", type=float, default=0.0)
    p.add_argument("--robust_opt_inner_iters_per_robot", type=int, default=10)
    p.add_argument("--robust_init_min_inliers", type=int, default=5)
    p.add_argument("--max_iteration_number", type=int, default=1000)
    p.add_argument("--relative_change_tolerance", type=float, default=0.1)
    p.add_argument("--log_directory")
    p.add_argument("--publish_iterate", type=_bool, default=False)
    p.add_argument("--visualize_loop_closures", type=_bool, default=False)
    p.add_argument(
        "--viz_interval", type=float, default=0.0,
        help="seconds between mid-run trajectory snapshots (0 = off; the "
             "reference republishes rviz trajectories every 30 s, "
             "PGOAgentROS.cpp:85-86). Engine/spmd/async modes.",
    )
    p.add_argument(
        "--viz_interval_iters", type=int, default=None,
        help="snapshot every N iterations/ticks instead of (or in "
             "addition to) the wall-clock interval",
    )
    p.add_argument(
        "--viz_dir", default=None,
        help="snapshot directory (default: <output>_snapshots)",
    )
    p.add_argument("--complete_reset", type=_bool, default=False)
    p.add_argument("--enable_recovery", type=_bool, default=False)
    p.add_argument("--synchronize_measurements", type=_bool, default=True)
    p.add_argument("--max_distributed_init_steps", type=int, default=30)
    p.add_argument("--inter_update_sleep_time", type=float, default=0.0)
    p.add_argument("--weight_convergence_threshold", type=float, default=-1.0)
    p.add_argument(
        "--certify", action="store_true",
        help="after the solve, run the SE-Sync-style dual certificate "
             "(ops/certificate.py) on the final iterate: reports "
             "criticality residual, min eig(S) and whether the solution "
             "is the certified GLOBAL optimum of the (final-weights) "
             "problem; fp64 runs certify sharply, fp32 within looser "
             "tolerances",
    )
    p.add_argument(
        "--robust_opt_inner_tol", type=float, default=None,
        help="fire GNC weight rounds on inner-phase convergence (all "
             "robots' rel-change below this) instead of the fixed "
             "iteration cadence (which remains as a budget cap) - makes "
             "the accept/reject split schedule-independent",
    )
    p.add_argument("--max_delayed_iterations", type=int, default=3)
    p.add_argument(
        "--asapp_stepsize_decay_ticks",
        type=int,
        default=0,
        help="ASAPP O(1/t) stepsize decay time constant (0 = reference "
        "constant-rate behavior)",
    )
    p.add_argument(
        "--asapp_tolerance",
        type=float,
        default=1e-3,
        help="async-mode termination: per-robot block movement per tick "
        "(per-tick scale, NOT the sync relative_change_tolerance scale)",
    )
    p.add_argument("--timeout_threshold", type=float, default=15.0)
    p.add_argument("--verbose", type=_bool, default=False)
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument(
        "--spmd_separator_only", type=_bool, default=None,
        help="spmd mode: exchange only separator poses between mesh "
        "slots (the PublicPoses payload; ~12x less exchange volume). "
        "Default: auto — on for non-robust runs",
    )
    p.add_argument(
        "--spmd_repartition", type=_bool, default=False,
        help="spmd mode: re-cut the global pose sequence into "
        "work-balanced contiguous slot blocks (splits hot robots — "
        "fixes dataset-pinned load skew)",
    )
    p.add_argument("--seed", type=int, default=42)
    return p


def args_to_config(a):
    from dpgo_ros_tpu.utils.config import (
        AgentConfig,
        InitMethod,
        RobustCostType,
        UpdateRule,
    )

    return AgentConfig(
        num_robots=a.num_robots,
        dimension=a.dimension,
        relaxation_rank=a.relaxation_rank,
        asynchronous=a.asynchronous,
        asynchronous_rate=a.asynchronous_rate,
        RGD_stepsize=a.RGD_stepsize,
        RGD_use_preconditioner=a.RGD_use_preconditioner,
        RTR_iterations=a.RTR_iterations,
        RTR_tCG_iterations=a.RTR_tCG_iterations,
        RTR_gradnorm_tol=a.RTR_gradnorm_tol,
        local_initialization_method=InitMethod(a.local_initialization_method),
        update_rule=UpdateRule(a.update_rule),
        multirobot_initialization=a.multirobot_initialization,
        acceleration=a.acceleration,
        restart_interval=a.restart_interval,
        robust_cost_type=RobustCostType(a.robust_cost_type),
        GNC_use_probability=a.GNC_use_probability,
        GNC_quantile=a.GNC_quantile,
        GNC_barc=a.GNC_barc,
        GNC_mu_step=a.GNC_mu_step,
        GNC_init_mu=a.GNC_init_mu,
        GNC_schedule=a.GNC_schedule,
        GNC_mu_start=a.GNC_mu_start,
        GNC_mu_end=a.GNC_mu_end,
        gnc_finalize_by_residual=a.gnc_finalize_by_residual,
        robust_opt_num_weight_updates=a.robust_opt_num_weight_updates,
        robust_opt_num_resets=a.robust_opt_num_resets,
        robust_opt_min_convergence_ratio=a.robust_opt_min_convergence_ratio,
        robust_opt_inner_iters_per_robot=a.robust_opt_inner_iters_per_robot,
        robust_init_min_inliers=a.robust_init_min_inliers,
        max_iteration_number=a.max_iteration_number,
        relative_change_tolerance=a.relative_change_tolerance,
        publish_iterate=a.publish_iterate,
        visualize_loop_closures=a.visualize_loop_closures,
        complete_reset=a.complete_reset,
        enable_recovery=a.enable_recovery,
        synchronize_measurements=a.synchronize_measurements,
        max_distributed_init_steps=a.max_distributed_init_steps,
        inter_update_sleep_time=a.inter_update_sleep_time,
        weight_convergence_threshold=a.weight_convergence_threshold,
        robust_opt_inner_tol=a.robust_opt_inner_tol,
        max_delayed_iterations=a.max_delayed_iterations,
        asapp_stepsize_decay_ticks=a.asapp_stepsize_decay_ticks,
        asapp_tolerance=a.asapp_tolerance,
        timeout_threshold=a.timeout_threshold,
        log_directory=a.log_directory,
        verbose=a.verbose,
        dtype=a.dtype,
        spmd_separator_only=a.spmd_separator_only,
        seed=a.seed,
    )


def apply_demo(a, parser=None) -> None:
    """Apply a demo preset (reference launch files, SURVEY.md §6).

    Explicit command-line flags win over the preset: a preset value is only
    applied where the current value still equals the parser default."""
    if parser is not None:
        target = a
        defaults = {k: parser.get_default(k) for k in vars(target)}

        class _Guard:
            def __setattr__(self, k, v):
                if getattr(target, k) == defaults.get(k):
                    setattr(target, k, v)

            def __getattr__(self, k):
                return getattr(target, k)

        a = _Guard()
    if a.demo == "dpgo_demo":
        a.dataset = a.dataset or "synthetic_sphere2500"
        a.num_robots = 5
        a.update_rule = "RoundRobin"
        a.local_initialization_method = "Chordal"
        a.relative_change_tolerance = 0.2
        a.RTR_gradnorm_tol = 0.5
    elif a.demo == "asapp_demo":
        a.dataset = a.dataset or "synthetic_sphere2500"
        a.num_robots = 5
        a.asynchronous = True
        a.asynchronous_rate = 100.0
        a.RGD_stepsize = 0.2
        a.local_initialization_method = "Chordal"
        a.max_delayed_iterations = max(a.max_delayed_iterations, 3)
    elif a.demo == "dpgo_gnc_demo":
        a.dataset = a.dataset or "synthetic_gnc8"
        a.num_robots = 8
        a.robust_cost_type = "GNC_TLS"
        a.GNC_use_probability = False
        a.GNC_barc = 3.0
        a.robust_init_min_inliers = 3
        a.robust_opt_num_weight_updates = 3
        a.robust_opt_num_resets = 3
        a.robust_opt_inner_iters_per_robot = 50
        # deviation from the reference demo (documented): weight rounds
        # fire on inner-phase convergence rather than the fixed cadence
        # (which stays as the budget cap) — makes the accept/reject split
        # schedule-independent
        a.robust_opt_inner_tol = 0.15  # explicit-flag-wins via the guard
        a.update_rule = "RoundRobin"
        a.local_initialization_method = "Odometry"
        a.relative_change_tolerance = 0.2
        a.RTR_gradnorm_tol = 0.5
        a.synchronize_measurements = False
        # reference dpgo_gnc_demo.launch:44 draws GNC-colored loop markers
        a.visualize_loop_closures = True




def _maybe_certify(summary, a, X, edges, weights):
    """--certify: dual-certificate check of the final iterate (certifies
    the global optimum of the final weighted problem; under GNC that is
    the accepted-edge L2 problem)."""
    if not a.certify:
        return
    import dataclasses as _dc

    import jax.numpy as jnp

    from dpgo_ros_tpu.ops import certificate

    e = _dc.replace(edges, weight=jnp.asarray(weights, edges.weight.dtype))
    fp64 = X.dtype == jnp.float64
    cert = certificate.certify(
        X, e,
        eig_tol=1e-5 if fp64 else 1e-3,
        crit_tol=1e-4 if fp64 else 3e-2,
        lanczos_tol=1e-6 if fp64 else 1e-4,
    )
    summary["certificate"] = {
        "certified_global": bool(cert.is_global),
        "min_eig": cert.min_eig,
        "crit_residual": cert.crit_residual,
        "scale": cert.scale,
    }

def _ground_truth_report(T, T_gt, outliers, weights, data) -> dict:
    """ATE against a generated world's ground truth and, where outliers
    were planted, how the final weights split them (weight < 0.5 =
    rejected)."""
    import jax.numpy as jnp

    from dpgo_ros_tpu.ops import rounding

    out = {
        "ate_vs_ground_truth": float(rounding.ate_translation(
            jnp.asarray(np.asarray(T)), jnp.asarray(T_gt)))
    }
    if outliers is not None and outliers.any():
        n_meas = len(data.measurements)
        w = (
            np.asarray(weights)[:n_meas]
            if weights is not None
            else np.ones(n_meas)
        )
        loops = np.asarray(data.measurements.edge_type) != 0
        rej = w < 0.5
        out["outlier_ground_truth"] = {
            "planted": int(outliers.sum()),
            "rejected_true": int((rej & outliers).sum()),
            "rejected_false": int((rej & loops & ~outliers).sum()),
            "missed": int((~rej & outliers).sum()),
            "accepted_true": int((~rej & loops & ~outliers).sum()),
        }
    return out


def main(argv=None) -> int:
    parser = build_parser()
    a = parser.parse_args(argv)
    if a.demo:
        apply_demo(a, parser)

    from dpgo_ros_tpu.utils import hostenv

    try:
        hostenv.select_platform(a.platform, a.cpu_devices)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    import jax

    if a.dtype == "float64":
        # without this the solver state silently truncates to fp32
        # (scripts/ and tests/ enable it themselves; the CLI must too)
        jax.config.update("jax_enable_x64", True)
    hostenv.setup_compile_cache()
    import jax.numpy as jnp

    from dpgo_ros_tpu.io import datasets
    from dpgo_ros_tpu.io.csv_loader import load_multi_robot_csv
    from dpgo_ros_tpu.io.partition import partition_g2o
    from dpgo_ros_tpu.models.problem import LiftedProblem
    from dpgo_ros_tpu.parallel.rbcd import RBCDEngine
    from dpgo_ros_tpu.utils import export

    cfg = args_to_config(a)

    # dataset resolution
    synth_gt = synth_out = None
    frontend_client = None
    if a.frontend:
        # out-of-process SLAM front-end: the reference's ingestion is a
        # network service (``src/PGODatasetPublisherNode.cpp:46-51``);
        # fleet agents additionally pull their slices through this socket
        from dpgo_ros_tpu.parallel.frontend import RemoteDatasetServer

        host, _, port = a.frontend.rpartition(":")
        frontend_client = RemoteDatasetServer(host or "127.0.0.1", int(port))
        data = frontend_client.fetch_data()
    elif a.synthetic:
        from dpgo_ros_tpu.io.synthetic import generate_world

        kw = dict(n=a.synthetic_n)
        if a.synthetic == "grid3d":
            side = max(2, round(a.synthetic_n ** (1.0 / 3.0)))
            kw = dict(grid_shape=(side, side, side))
        data, synth_gt, synth_out = generate_world(
            a.synthetic, num_robots=a.num_robots,
            rot_noise=a.synthetic_rot_noise,
            trans_noise=a.synthetic_trans_noise,
            outlier_ratio=a.synthetic_outlier_ratio,
            seed=a.seed,
            balance=a.partition_balance,
            **kw,
        )
    elif a.csv:
        data = load_multi_robot_csv(a.csv)
    elif a.g2o:
        data = partition_g2o(a.g2o, a.num_robots, balance=a.partition_balance)
    elif a.dataset in datasets.WORLDS:
        data, synth_gt, synth_out = datasets.load_world(
            a.dataset, num_robots=a.num_robots, balance=a.partition_balance
        )
    elif a.dataset:
        try:
            data = datasets.load_dataset(
                a.dataset, num_robots=a.num_robots,
                balance=a.partition_balance,
            )
        except (FileNotFoundError, KeyError) as e:
            print(f"error: {e.args[0]}", file=sys.stderr)
            return 2
    else:
        print("error: provide --demo, --dataset, --g2o or --csv", file=sys.stderr)
        return 2
    cfg = dataclasses.replace(cfg, num_robots=data.num_robots)

    t0 = time.time()
    summary = {}
    export_weights = None  # final GNC weights for the --output loop overlay

    # mid-run observability (round 4): periodic trajectory snapshots — the
    # reference's 30 s visualization timer (``PGOAgentROS.cpp:85-86``)
    snap = None
    if a.viz_interval > 0 or a.viz_interval_iters is not None:
        from dpgo_ros_tpu.utils.snapshots import SnapshotWriter

        snap_dir = a.viz_dir or (
            (a.output + "_snapshots") if a.output else "dpgo_snapshots"
        )
        snap = SnapshotWriter(
            snap_dir, data,
            interval_sec=a.viz_interval,
            interval_iters=a.viz_interval_iters,
        )
        print(f"mid-run snapshots -> {snap_dir}", file=sys.stderr)
    if cfg.verbose:
        print("resolved config: "
              + json.dumps(dataclasses.asdict(cfg), default=str),
              file=sys.stderr)
    if a.mode == "async" or (a.asynchronous and a.mode == "engine"):
        # the reference's asynchronous (ASAPP) mode: RGD local loops under
        # bounded staleness, no UPDATE tokens
        # (``runOnceAsynchronous``, ``src/PGOAgentROS.cpp:119-127``;
        # ``launch/asapp_demo.launch``)
        from dpgo_ros_tpu.ops import quadratic, rounding
        from dpgo_ros_tpu.parallel.asapp import ASAPPEngine, ASAPPState
        from dpgo_ros_tpu.utils import checkpoint as ckpt_mod
        from dpgo_ros_tpu.utils import telemetry
        from dpgo_ros_tpu.utils.profiling import device_trace

        prob = LiftedProblem.from_data(
            data,
            r=cfg.relaxation_rank,
            dtype=jnp.float64 if cfg.dtype == "float64" else jnp.float32,
        )
        aeng = ASAPPEngine(prob, cfg)
        mgr = (
            ckpt_mod.CheckpointManager(
                a.checkpoint_dir, every=a.checkpoint_every
            )
            if a.checkpoint_dir
            else None
        )
        ast = None
        if a.resume:
            rp = a.resume
            if rp == "latest":
                if mgr is None or mgr.latest() is None:
                    print("error: --resume latest needs a --checkpoint_dir "
                          "with checkpoints", file=sys.stderr)
                    return 2
                rp = mgr.latest()[1]
            ast, _, _meta = ckpt_mod.load_state(rp, ASAPPState)
            print(f"async resumed from {rp} (tick {int(ast.tick)})",
                  file=sys.stderr)
            X0 = None
        else:
            eng = RBCDEngine(prob, cfg)  # shared initialization pipeline
            X0 = eng.initialize().X
        t_run0 = time.time()
        on_chunk = (
            (lambda t, s: snap.maybe_snapshot(t, s.X))
            if snap is not None
            else None
        )
        with device_trace(a.profile_dir):
            st, info = aeng.run(
                X0,
                num_ticks=cfg.max_iteration_number,
                tol=cfg.asapp_tolerance,
                state=ast,
                record=bool(a.log_directory),
                on_chunk=on_chunk,
            )
        if mgr is not None:
            mgr.save(int(st.tick), st, None,
                     meta={"tick": int(st.tick), "final": True})
            print(f"async checkpoint written to {mgr.step_path(int(st.tick))}",
                  file=sys.stderr)
        if a.log_directory and len(info.get("rel_hist", [])):
            nrows = len(info["rel_hist"])
            mean_t = (time.time() - t_run0) / max(nrows, 1)
            telemetry.write_run_logs(
                a.log_directory,
                problem=prob,
                rel_change_rows=info["rel_hist"],
                # ticks run on-device inside one program: per-tick host
                # clocks don't exist — report the measured mean
                iter_times=np.full((nrows,), mean_t),
            )
            print(f"per-agent telemetry CSVs in {a.log_directory}",
                  file=sys.stderr)
        T = np.asarray(
            rounding.anchor_to_first_pose(rounding.round_solution(st.X))
        )
        summary = {
            "mode": "async",
            "ticks": info["ticks"],
            "steps_per_tick": aeng.steps_per_tick,
            "converged": info["converged"],
            "final_cost": float(quadratic.cost(st.X, prob.edges)),
        }
    elif a.mode == "fleet":
        from dpgo_ros_tpu.parallel.controller import DistributedController

        ctl = DistributedController(data, cfg, dataset=frontend_client)
        if a.resume:
            rp = a.resume
            if rp == "latest" and a.checkpoint_dir:
                rp = a.checkpoint_dir
            ctl.restore_checkpoint(rp)
            print(f"fleet resumed warm-start caches from {rp}",
                  file=sys.stderr)
        res = ctl.run(snapshot=snap)
        if a.checkpoint_dir:
            ctl.save_checkpoint(
                a.checkpoint_dir, meta={"ticks": res["ticks"]}
            )
            print(f"fleet checkpoint written to {a.checkpoint_dir}",
                  file=sys.stderr)
        T = ctl.global_trajectory(res)
        gw = ctl.global_weights(res, data.measurements)
        if gw is not None:
            export_weights = gw
        summary = {
            "mode": "fleet",
            "ticks": res["ticks"],
            "iterations": res["iterations"],
            "messages_sent": res["messages_sent"],
        }
        gs = ctl.gnc_statistics(res)
        if gs is not None:
            summary["gnc_stats"] = gs
    elif a.mode == "spmd":
        from jax.sharding import Mesh

        from dpgo_ros_tpu.parallel.spmd import (
            ShardedProblem,
            build_spmd_step,
            gather_trajectory,
            gather_weights,
            group_robots,
            repartition_slots,
        )
        from dpgo_ros_tpu.ops import quadratic, rounding
        from dpgo_ros_tpu.utils.config import RobustCostType

        # fleets larger than the mesh: group robots into super-blocks
        M = min(len(jax.devices()), max(data.num_robots, 1))
        if a.spmd_repartition:
            # work-balanced slot re-cut (splits hot robots; round 5)
            data = repartition_slots(data, M)
            cfg = dataclasses.replace(cfg, num_robots=M)
        elif data.num_robots > M:
            data = group_robots(data, M)
            cfg = dataclasses.replace(cfg, num_robots=M)
        prob = LiftedProblem.from_data(
            data, r=cfg.relaxation_rank, dtype=jnp.float32
        )
        eng = RBCDEngine(prob, cfg)
        st0 = eng.initialize()
        sp = ShardedProblem.build(
            prob,
            np.asarray(st0.X, np.float32),
            eng.robot_colors,
            num_devices=M,
        )
        mesh = Mesh(np.array(jax.devices()[: sp.M]), ("robots",))
        st, step = build_spmd_step(sp, mesh, cfg)
        from dpgo_ros_tpu.utils import checkpoint as ckpt_mod

        mgr = (
            ckpt_mod.CheckpointManager(
                a.checkpoint_dir, every=a.checkpoint_every
            )
            if a.checkpoint_dir
            else None
        )
        it0 = 0
        if a.resume:
            rp = a.resume
            if rp == "latest":
                if mgr is None or mgr.latest() is None:
                    print("error: --resume latest needs a --checkpoint_dir "
                          "with checkpoints", file=sys.stderr)
                    return 2
                rp = mgr.latest()[1]
            loaded, _, meta = ckpt_mod.load_state(rp, type(st))
            # re-place host arrays onto the mesh with the live shardings
            st = type(st)(*(
                jax.device_put(np.asarray(l), x.sharding)
                for l, x in zip(loaded, st)
            ))
            it0 = int(meta.get("it", 0))
            print(f"spmd resumed from {rp} (iteration {it0})",
                  file=sys.stderr)
        gnc = cfg.robust_cost_type == RobustCostType.GNC_TLS
        inner = cfg.robust_opt_inner_iters_per_robot * cfg.num_robots
        log_rel, log_t, log_ev = [], [], []
        for it in range(it0, cfg.max_iteration_number):
            # GNC weight rounds on the reference cadence
            wu = int(
                gnc
                and it > 0
                and it % inner == 0
                and int(np.asarray(st.wuc)[0, 0])
                < cfg.robust_opt_num_weight_updates
            )
            t_it = time.time()
            st = step(np.int32(it), np.int32(wu), st)
            if a.log_directory:
                # per-iteration telemetry forces one device sync per step
                # (the reference pays the same to write its CSV rows,
                # src/PGOAgentROS.cpp:853-894)
                log_rel.append(np.asarray(st.rel_change)[:, 0])
                log_t.append(time.time() - t_it)
                if wu:
                    log_ev.append((it - it0, "UPDATE_WEIGHT"))
            if mgr is not None:
                mgr.maybe_save(it + 1, st, None, meta={"it": it + 1})
            if snap is not None and (
                snap._due(it + 1)
            ):
                Xg_s = gather_trajectory(sp, st, prob.num_poses)
                snap.snapshot(
                    it + 1, Xg_s,
                    weights=gather_weights(sp, st, prob.edges.num_edges),
                )
            if it % 20 == 19:
                rc = float(np.max(np.asarray(st.rel_change)))
                if rc < cfg.relative_change_tolerance and (
                    not gnc
                    or int(np.asarray(st.wuc)[0, 0])
                    >= cfg.robust_opt_num_weight_updates
                ):
                    break
        if mgr is not None:
            mgr.save(it + 1, st, None, meta={"it": it + 1, "final": True})
        if a.log_directory and log_rel:
            from dpgo_ros_tpu.utils import telemetry

            telemetry.write_run_logs(
                a.log_directory,
                problem=prob,
                rel_change_rows=np.stack(log_rel),
                iter_times=log_t,
                events=log_ev,
            )
            print(f"per-agent telemetry CSVs in {a.log_directory}",
                  file=sys.stderr)
        Xg = gather_trajectory(sp, st, prob.num_poses)
        # final cost under the FINAL robust weights (rejected outliers stay
        # rejected in the reported objective)
        w_final = jnp.asarray(
            gather_weights(sp, st, prob.edges.num_edges), jnp.float32
        )
        # TERMINATE semantics via the engine's finalize (reference
        # ``PGOAgentROS.cpp:1036-1082``): resolve undecided GNC weights by
        # final residual, round, anchor — without this the spmd mode left
        # budget-capped runs with an undecided tail the fleet protocol
        # resolves (round 5)
        st_fin = st0._replace(
            X=jnp.asarray(Xg, st0.X.dtype), weights=w_final
        )
        T, st_fin = eng.finalize(st_fin)
        T = np.asarray(T)
        w_final = jnp.asarray(st_fin.weights, jnp.float32)
        export_weights = np.asarray(w_final)
        f_final = float(
            quadratic.cost(jnp.asarray(Xg), eng._edges(w_final))
        )
        summary = {
            "mode": "spmd",
            "iterations": int(np.asarray(st.iteration)[0, 0]),
            "devices": sp.M,
            "final_cost": f_final,
        }
        if gnc:
            from dpgo_ros_tpu.models import robust as robust_mod

            acc, rej, und = robust_mod.classify_weights(
                w_final, prob.edges.is_loop, prob.edges.mask
            )
            total = int(acc) + int(rej) + int(und)
            summary["gnc_stats"] = {
                "accepted": int(acc),
                "rejected": int(rej),
                "undecided": int(und),
                "convergence_ratio": (int(acc) + int(rej)) / max(total, 1),
            }
    else:
        from dpgo_ros_tpu.utils import checkpoint as ckpt
        from dpgo_ros_tpu.utils.profiling import device_trace

        prob = LiftedProblem.from_data(
            data,
            r=cfg.relaxation_rank,
            dtype=jnp.float64 if cfg.dtype == "float64" else jnp.float32,
        )
        eng = RBCDEngine(prob, cfg)
        mgr = (
            ckpt.CheckpointManager(a.checkpoint_dir, every=a.checkpoint_every)
            if a.checkpoint_dir
            else None
        )
        if a.resume:
            rp = a.resume
            if rp == "latest":
                if mgr is None or mgr.latest() is None:
                    print("error: --resume latest needs a --checkpoint_dir "
                          "with checkpoints", file=sys.stderr)
                    return 2
                rp = mgr.latest()[1]
            try:
                st, ylift, meta = ckpt.load_state(rp)
            except (FileNotFoundError, NotADirectoryError):
                print(f"error: no checkpoint at {rp}", file=sys.stderr)
                return 2
            if ylift is not None:
                eng.Ylift = jnp.asarray(ylift, eng.dtype)
            print(f"resumed from {rp} (iteration {int(st.iteration)})",
                  file=sys.stderr)
        else:
            st = eng.initialize()
        def _cb(it, s):
            # cadence on the *global* iteration counter so resumed runs
            # continue the same checkpoint grid
            if mgr is not None:
                mgr.maybe_save(int(s.iteration), s, eng.Ylift)
            if snap is not None:
                snap.maybe_snapshot(
                    int(s.iteration), s.X,
                    weights=np.asarray(s.weights),
                    cost=float(s.cost),
                )

        cb = _cb if (mgr is not None or snap is not None) else None
        t_run0 = time.time()
        with device_trace(a.profile_dir):
            if a.mode == "fused":
                # the engine's resolved config carries the derived GNC
                # iteration budget (reference PGOAgentROSNode.cpp:227-232)
                run = eng.make_fused_run(
                    eng.config.max_iteration_number,
                    record=bool(a.log_directory),
                )
                if a.log_directory:
                    st, rel_h, ev_h = run(st)
                    from dpgo_ros_tpu.utils import telemetry

                    ev = [
                        (int(i), "UPDATE_WEIGHT")
                        for i in np.where(np.asarray(ev_h) > 0)[0]
                    ]
                    nrows = int(st.iteration)
                    mean_t = (time.time() - t_run0) / max(nrows, 1)
                    telemetry.write_run_logs(
                        a.log_directory,
                        problem=prob,
                        rel_change_rows=np.asarray(rel_h),
                        # one XLA program, no per-iteration host clock:
                        # report the measured mean
                        iter_times=np.full((nrows,), mean_t),
                        events=ev,
                    )
                    print(f"per-agent telemetry CSVs in {a.log_directory}",
                          file=sys.stderr)
                else:
                    st = run(st)
                info = {
                    "iterations": int(st.iteration),
                    "final_cost": float(st.cost),
                }
                from dpgo_ros_tpu.utils.config import RobustCostType as _RCT

                if cfg.robust_cost_type != _RCT.L2:
                    from dpgo_ros_tpu.models import robust as _robust

                    acc_, rej_, und_ = _robust.classify_weights(
                        st.weights, prob.edges.is_loop, prob.edges.mask
                    )
                    tot_ = int(acc_) + int(rej_) + int(und_)
                    info["gnc_stats"] = {
                        "accepted": int(acc_),
                        "rejected": int(rej_),
                        "undecided": int(und_),
                        "convergence_ratio": (int(acc_) + int(rej_))
                        / max(tot_, 1),
                    }
            else:
                st, info = eng.run(st, callback=cb)
                if cfg.verbose and info["history"]["rel_change_robots"]:
                    # reference verbose prints the core solver's per-update
                    # telemetry (fOpt/gradnorm, ``PGOAgentROS.cpp:166-172``)
                    h = info["history"]
                    for i, rr in enumerate(h["rel_change_robots"]):
                        print(
                            f"iter {i}: max_rel_change "
                            f"{float(np.max(rr)):.6g} "
                            f"iter_time {h['iter_time_sec'][i]:.4f}s"
                            + (f" [{h['event'][i]}]"
                               if h.get("event") and h["event"][i] else ""),
                            file=sys.stderr,
                        )
                if a.log_directory and info["history"]["rel_change_robots"]:
                    from dpgo_ros_tpu.utils import telemetry

                    h = info["history"]
                    telemetry.write_run_logs(
                        a.log_directory,
                        problem=prob,
                        rel_change_rows=np.stack(h["rel_change_robots"]),
                        iter_times=h["iter_time_sec"],
                        events=h["event"],
                    )
                    print(f"per-agent telemetry CSVs in {a.log_directory}",
                          file=sys.stderr)
        if mgr is not None:
            mgr.save(int(st.iteration), st, eng.Ylift,
                     meta={"final": True, "cost": float(st.cost)})
        T, st = eng.finalize(st)
        export_weights = np.asarray(st.weights)
        summary = {
            "mode": a.mode,
            "iterations": info["iterations"],
            "final_cost": info["final_cost"],
        }
        if "gnc_stats" in info:
            summary["gnc_stats"] = info["gnc_stats"]
        _maybe_certify(summary, a, st.X, prob.edges, st.weights)
    if synth_gt is not None:
        summary.update(
            _ground_truth_report(T, synth_gt, synth_out, export_weights, data)
        )
    summary["wall_time_sec"] = round(time.time() - t0, 3)
    print(json.dumps(summary))

    if a.output and T is not None:
        n_meas = len(data.measurements)
        w_exp = (
            np.asarray(export_weights)[:n_meas]
            if export_weights is not None
            else np.ones(n_meas)
        )
        export.export_solution(
            a.output,
            np.asarray(T),
            data.num_poses,
            data.measurements,
            w_exp,
            show_loops=cfg.visualize_loop_closures,
        )
        print(f"wrote {a.output}_global.g2o and per-robot TUM files",
              file=sys.stderr)
    if frontend_client is not None and T is not None:
        # return path: solved per-robot trajectories back to the front-end
        # (reference publishOptimizedTrajectory, src/PGOAgentROS.cpp:622-660)
        Tn = np.asarray(T)
        off = 0
        for k in range(data.num_robots):
            nk = int(data.num_poses[k])
            frontend_client.publish_trajectory(k, Tn[off:off + nk])
            off += nk
        frontend_client.close()
        print(f"published {data.num_robots} trajectories to --frontend",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
