"""The quickest proof that the solver runs on a GPU, at the reference
demos' real shapes, against a certified fp64 reference.

    python chip_smoke.py          # one card: phases a-g
    python chip_smoke.py --four   # four cards: the spmd robot mesh only

Phases (one process; every phase must pass, none is skipped):

a. device facts: JAX's platform, device kind and count, and the card's
   ``name, power.limit`` from ``nvidia-smi``. Fails unless JAX runs on a GPU.
b. the plain reference: a tight fp64 centralized solve of the generated
   2,500-pose sphere world on the card, with its dual certificate (host
   sparse S). This gives f*.
c. the main path through the CLI (``dpgo_ros_tpu.cli.main``): the
   ``dpgo_demo`` preset, and a colored-parallel ``--mode fused`` run of 100
   steps at RTR 3x50 / gradnorm 0.5 (bench.py's shape). Each ends at cost
   <= 1.02 f*.
d. one RTR block solve at real width, fp32 against fp64 from the same input:
   relative cost difference <= 1e-4 at the package's matmul precision; the
   difference at XLA's default precision is printed beside it.
e. the ``asapp_demo`` preset at a fixed tick count, fp32 against fp64:
   final costs within 1e-3 relative.
f. the ``dpgo_gnc_demo`` preset on the labeled 8-robot world, in engine and
   spmd mode: each rejects >= 95 % of the planted outliers.
g. peak device memory after each phase.

``--four`` runs the 5-robot sphere world in ``--mode spmd`` over four cards
against the one-card engine run and f* (both at relative-change tolerance
0.02), then ``__graft_entry__.dryrun_multichip(4)``.

The last line of stdout is one JSON object, printed only when every phase
passed: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import contextlib
import io
import json
import sys
import time

SPHERE = "synthetic_sphere2500"
GNC = "synthetic_gnc8"
COST_BOUND = 1.02  # every main-path run ends within 2 % of f*


def log(msg):
    print(msg, flush=True)


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, from its own
    monitoring events."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, secs, **_):
        if event in self.EVENTS:
            self.total += secs


def peak_memory(phase):
    import jax

    for d in jax.local_devices():
        peak = (d.memory_stats() or {}).get("peak_bytes_in_use")
        log(f"[g] after {phase}: {d} peak_bytes_in_use={peak}")


def run_cli(argv, clock):
    """``dpgo_ros_tpu.cli.main`` on the GPU; returns its JSON summary with
    the compile seconds it spent added."""
    from dpgo_ros_tpu.cli import main

    argv = list(argv) + ["--platform", "gpu"]
    c0 = clock.total
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv} exited {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    summary["compile_sec"] = clock.total - c0
    return summary


def report(tag, s, f_star=None):
    extra = "" if f_star is None else f" = {s['final_cost'] / f_star:.6f} f*"
    log(
        f"{tag}: wall {s['wall_time_sec']} s, compile {s['compile_sec']:.2f} s, "
        f"iterations {s.get('iterations', s.get('ticks'))}, "
        f"final cost {s['final_cost']!r}{extra}"
    )


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def certified_optimum(data, tag):
    """Phase b: tight fp64 centralized solve on the card + certificate."""
    from dpgo_ros_tpu.models.certified import certified_solve

    t0 = time.perf_counter()
    res = certified_solve(data)
    log(
        f"[b] {tag}: f* = {res.cost!r} certified={res.certified} "
        f"rank={res.rank} min_eig={res.min_eig:.3e} "
        f"crit={res.crit_residual:.3e} ({time.perf_counter() - t0:.1f} s)"
    )
    check(res.certified, f"{tag}: fp64 reference did not certify")
    return res.cost


DEMO = ["--demo", "dpgo_demo"]
FUSED = [
    "--dataset", SPHERE, "--num_robots", "5", "--mode", "fused",
    "--update_rule", "Parallel", "--local_initialization_method", "Chordal",
    "--RTR_iterations", "3", "--RTR_tCG_iterations", "50",
    "--RTR_gradnorm_tol", "0.5", "--max_iteration_number", "100",
    "--relative_change_tolerance", "0",
]


def phase_main_path(clock, f_star):
    """Phase c."""
    for tag, argv in (("dpgo_demo", DEMO), ("fused", FUSED)):
        s = run_cli(argv, clock)
        report(f"[c] {tag}", s, f_star)
        check(
            s["final_cost"] <= COST_BOUND * f_star,
            f"{tag}: cost {s['final_cost']} > {COST_BOUND} f*",
        )


def phase_block_solve():
    """Phase d: one RTR block solve, fp32 vs fp64 from the same input."""
    import jax
    import jax.numpy as jnp

    from dpgo_ros_tpu.io.datasets import load_world
    from dpgo_ros_tpu.models.local_solvers import RTRParams, rtr_solve
    from dpgo_ros_tpu.models.problem import LiftedProblem
    from dpgo_ros_tpu.ops import quadratic
    from dpgo_ros_tpu.parallel.rbcd import RBCDEngine
    from dpgo_ros_tpu.utils.config import AgentConfig, InitMethod

    data = load_world(SPHERE, num_robots=5)[0]
    prob64 = LiftedProblem.from_data(data, r=5)
    cfg = AgentConfig(
        num_robots=5, local_initialization_method=InitMethod.CHORDAL
    )
    X0 = RBCDEngine(prob64, cfg).initialize().X
    params = RTRParams(
        max_iterations=3, max_tcg_iterations=50, gradnorm_tol=0.5
    )

    def solve(dtype):
        prob = LiftedProblem.from_data(data, r=5, dtype=dtype)
        e = prob.edges
        P = quadratic.precond_inverse(quadratic.precond_blocks(e, prob.n))
        X, _ = jax.jit(rtr_solve, static_argnums=4)(
            X0.astype(dtype), e, prob.block_mask(0, dtype), P, params
        )
        return float(quadratic.cost(X.astype(jnp.float64), prob64.edges))

    f64 = solve(jnp.float64)
    f32 = solve(jnp.float32)
    with jax.default_matmul_precision("default"):
        f32_default = solve(jnp.float32)
    rel = abs(f32 - f64) / abs(f64)
    rel_default = abs(f32_default - f64) / abs(f64)
    prec = jax.config.jax_default_matmul_precision
    log(
        f"[d] block solve ({prob64.n} poses, robot 0 of 5, RTR 3x50): "
        f"fp64 {f64!r}, fp32 at precision={prec} {f32!r} (rel {rel:.3e}), "
        f"fp32 at XLA default precision {f32_default!r} "
        f"(rel {rel_default:.3e})"
    )
    check(rel <= 1e-4, f"block solve fp32 vs fp64 rel {rel} > 1e-4")


ASAPP_TICKS = "400"


def phase_asapp(clock, f_star):
    """Phase e: asapp_demo at a fixed tick count, fp32 vs fp64."""
    costs = {}
    for dt in ("float32", "float64"):
        s = run_cli(
            ["--demo", "asapp_demo", "--max_iteration_number", ASAPP_TICKS,
             "--asapp_tolerance", "0", "--dtype", dt],
            clock,
        )
        report(f"[e] asapp_demo {dt}", s, f_star)
        check(s["ticks"] == int(ASAPP_TICKS), f"asapp ran {s['ticks']} ticks")
        costs[dt] = s["final_cost"]
    rel = abs(costs["float32"] - costs["float64"]) / abs(costs["float64"])
    log(f"[e] asapp fp32 vs fp64 final cost rel diff {rel:.3e}")
    check(rel <= 1e-3, f"asapp fp32 vs fp64 rel {rel} > 1e-3")


def gnc_inlier_optimum():
    """f* of the GNC world restricted to its genuine measurements."""
    import numpy as np

    from dpgo_ros_tpu.io.datasets import load_world
    from dpgo_ros_tpu.types import PoseGraphData

    data, _, outliers = load_world(GNC, num_robots=1)
    clean = PoseGraphData(
        measurements=data.measurements.select(~outliers),
        num_poses=np.asarray(data.num_poses),
        d=data.d,
    )
    return certified_optimum(clean, f"{GNC} inliers")


def phase_gnc(clock):
    """Phase f: GNC demo on the labeled world, engine and spmd modes."""
    f_in = gnc_inlier_optimum()
    for mode in ("engine", "spmd"):
        s = run_cli(["--demo", "dpgo_gnc_demo", "--mode", mode], clock)
        g = s["outlier_ground_truth"]
        planted, tp = g["planted"], g["rejected_true"]
        kept, fp, missed = g["accepted_true"], g["rejected_false"], g["missed"]
        report(f"[f] gnc {mode}", s, f_in)
        # accept set = loop closures kept (weight >= 0.5)
        log(
            f"[f] gnc {mode}: planted outliers {planted}, rejected {tp} "
            f"({tp / planted:.4f}), inliers rejected {fp}; accept set "
            f"precision {kept / max(kept + missed, 1):.4f}, "
            f"recall {kept / max(kept + fp, 1):.4f}, "
            f"ATE {s['ate_vs_ground_truth']!r}"
        )
        check(tp >= 0.95 * planted, f"gnc {mode}: rejected {tp}/{planted}")


FOUR_TOL = "0.02"


def phase_four(clock, f_star):
    """--four: the spmd robot mesh over four cards vs one card and f*."""
    import jax

    devs = jax.devices()
    check(len(devs) >= 4, f"--four needs 4 GPUs, found {devs}")
    check(len({d.id for d in devs[:4]}) == 4, "mesh devices are not distinct")
    # a sharded array over the mesh the spmd mode builds lands one shard
    # on each of four cards
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    mesh = Mesh(np.array(devs[:4]), ("robots",))
    x = jax.device_put(
        np.arange(4.0), NamedSharding(mesh, PartitionSpec("robots"))
    )
    shards = {s.device.id for s in x.addressable_shards}
    check(len(shards) == 4, f"mesh shards on devices {shards}")
    log(f"[four] mesh devices: {devs[:4]}, shards on ids {sorted(shards)}")
    # both runs converge further than the demo's 0.2 tolerance: RoundRobin
    # and the colored mesh schedule stop at different points at 0.2
    # (1.2e-3 apart on a shrunk CPU rehearsal), which says nothing about
    # whether the mesh computes the same solve
    demo = DEMO + ["--relative_change_tolerance", FOUR_TOL]
    one = run_cli(demo, clock)
    report("[four] one-card engine dpgo_demo", one, f_star)
    spmd = run_cli(demo + ["--mode", "spmd"], clock)
    report("[four] four-card spmd dpgo_demo", spmd, f_star)
    check(spmd["devices"] == 4, f"spmd ran on {spmd['devices']} devices")
    rel = abs(spmd["final_cost"] - one["final_cost"]) / one["final_cost"]
    log(f"[four] spmd vs one-card rel diff {rel:.3e}")
    check(spmd["final_cost"] <= COST_BOUND * f_star, "spmd cost > 1.02 f*")
    check(rel <= 1e-3, f"spmd vs one-card rel {rel} > 1e-3")
    peak_memory("spmd")
    import __graft_entry__

    f = __graft_entry__.dryrun_multichip(4)
    log(f"[four] dryrun_multichip(4) final cost {f!r}")
    peak_memory("dryrun_multichip")


def main(argv):
    four = "--four" in argv
    from dpgo_ros_tpu.utils import hostenv

    hostenv.select_platform("gpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    hostenv.setup_compile_cache()
    facts = hostenv.device_facts()
    log(f"[a] jax {jax.__version__}: platform={facts['platform']} "
        f"kind={facts['kind']} count={facts['count']}")
    clock = CompileClock()

    from dpgo_ros_tpu.io.datasets import load_world

    t0 = time.perf_counter()
    f_star = certified_optimum(load_world(SPHERE, num_robots=1)[0], SPHERE)
    peak_memory("reference")
    if four:
        phase_four(clock, f_star)
    else:
        phase_main_path(clock, f_star)
        peak_memory("main path")
        phase_block_solve()
        peak_memory("block solve")
        phase_asapp(clock, f_star)
        peak_memory("asapp")
        phase_gnc(clock)
        peak_memory("gnc")
    log(f"total {time.perf_counter() - t0:.1f} s, "
        f"compile {clock.total:.1f} s")
    log(facts["name_power_limit"])
    print(json.dumps({"ok": True, "device": {
        "platform": facts["platform"],
        "kind": facts["kind"],
        "count": facts["count"],
    }}))


if __name__ == "__main__":
    main(sys.argv[1:])
