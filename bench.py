"""Benchmark: 5-robot synchronous RBCD throughput on one GPU.

Headline config = the reference demo (``launch/dpgo_demo.launch``): 5 robots
on the generated 2,500-pose sphere world (sphere2500's shape: 2,500 poses,
4,949 edges; ``io/datasets.py``), RTR budget 3 outer x 50 tCG iterations,
gradnorm tol 0.5, chordal initialization. The solve is the one-program XLA
runner (``RBCDEngine.make_fused_run``).

Metric: solver block-updates per second, measured with chained solves:

  * ONE timed region contains K=24 chained solves. Every solve starts from
    a DISTINCT input: the initial state is gauge-rotated by an O(r)
    rotation whose angle is derived from the PREVIOUS solve's final cost
    (run i+1 consumes run i's output -> a strict data-dependency chain;
    no result caching or pipelining across solves can cheat the clock).
    Gauge rotations leave the cost invariant and the solver equivariant,
    so every solve performs identical work on different bits.
  * Termination tolerance is 0 -> every solve executes exactly NUM_ITERS
    scheduled block updates (fixed work; verified post-hoc from the
    returned iteration counters).
  * One ``block_until_ready`` at the end of the region; per-solve time =
    region / K. The region is repeated 3x and the MEDIAN is recorded,
    with the min/max spread in the JSON.
  * tCG iterations per solve: not measured (the XLA solver has no counter
    yet).

Every result names the platform, device kind, device count and the card's
power limit. Without a GPU the benchmark exits with an error.

vs_baseline: the reference stack's practical update rate is bounded by its
coordination protocol — the demo config sleeps 0.1 s between UPDATE
commands (``inter_update_sleep_time`` in ``launch/dpgo_demo.launch``),
i.e. <=10 block-updates/s on the reference i7 setup, before adding its
per-update solver time. baseline_iters_per_sec = 10.0.

Prints ONE JSON line on stdout.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

from dpgo_ros_tpu.io.datasets import load_dataset
from dpgo_ros_tpu.models.problem import LiftedProblem
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu.utils import hostenv
from dpgo_ros_tpu.utils.config import AgentConfig, InitMethod, UpdateRule

BASELINE_ITERS_PER_SEC = 10.0
NUM_ITERS = 100
K_CHAIN = 24  # distinct-input chained solves per timed region
REGIONS = 3  # timed-region repeats; the MEDIAN is recorded


def log(msg):
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def make_perturb(r):
    """Jitted gauge perturbation: rotate the lifted rank space by an O(r)
    rotation in the (0,1) plane with angle theta(prev_cost, i). Cost is
    invariant and the solver is equivariant under left gauge rotations, so
    the perturbed solve does identical work on distinct input bits."""
    I = np.eye(r, dtype=np.float32)
    P01 = np.zeros((r, r), np.float32)
    P01[0, 0] = P01[1, 1] = 1.0
    R90 = np.zeros((r, r), np.float32)
    R90[1, 0] = 1.0
    R90[0, 1] = -1.0
    I_c, P_c, R_c = jnp.asarray(I), jnp.asarray(P01), jnp.asarray(R90)

    @jax.jit
    def perturb(X, prev_cost, i):
        theta = prev_cost * 1e-3 + i * 0.7309
        G = I_c + (jnp.cos(theta) - 1.0) * P_c + jnp.sin(theta) * R_c
        return jnp.einsum("sr,nrk->nsk", G, X)

    return perturb


def setup(rule):
    data = load_dataset("synthetic_sphere2500", num_robots=5)
    prob = LiftedProblem.from_data(data, r=5, dtype=jnp.float32)
    cfg = AgentConfig(
        num_robots=5,
        update_rule=rule,
        # chordal init = the reference demo config (dpgo_demo.launch:9)
        local_initialization_method=InitMethod.CHORDAL,
        relative_change_tolerance=0.0,  # fixed-length run: exact work
        max_iteration_number=NUM_ITERS,
        RTR_iterations=3,
        RTR_tCG_iterations=50,
        RTR_gradnorm_tol=0.5,
        dtype="float32",
    )
    eng = RBCDEngine(prob, cfg)
    st0 = eng.initialize()
    run = eng.make_fused_run(NUM_ITERS)
    perturb = make_perturb(prob.r)
    return eng, st0, run, perturb


def chained_region(run, perturb, st0, k_chain):
    """ONE timed region: k_chain solves, each from a distinct gauge-rotated
    init chained through the previous solve's cost. Returns wall seconds
    plus DEVICE handles (finals read after the last region)."""
    st = st0
    finals = []
    t0 = time.perf_counter()
    for i in range(k_chain):
        out = run(st)
        finals.append((out.cost, out.iteration))
        if i < k_chain - 1:
            st = st0._replace(
                X=perturb(st0.X, out.cost, np.float32(i + 1.0))
            )
    finals[-1][0].block_until_ready()
    dt = time.perf_counter() - t0
    return dt, finals


def measure(rule, k_chain, regions):
    eng, st0, run, perturb = setup(rule)
    # warm both program shapes (solve-from-st0 and solve-from-perturbed)
    out_w = run(st0)
    st_w = st0._replace(X=perturb(st0.X, out_w.cost, np.float32(0.5)))
    out_w2 = run(st_w)
    out_w2.cost.block_until_ready()
    times, finals_all = [], []
    for _ in range(regions):
        dt, finals = chained_region(run, perturb, st0, k_chain)
        times.append(dt)
        finals_all.append(finals)
    return eng, st0, times, finals_all


def finish(eng, st0, times, finals_all, rule, k_chain):
    """Host-side reads of the results, after every timed region."""
    f_init = float(st0.cost)
    costs, steps = [], []
    for finals in finals_all:
        for c, it in finals:
            costs.append(float(c))
            steps.append(int(it))
    # fixed-work guarantee: every solve ran the full schedule
    assert all(s == NUM_ITERS for s in steps), steps
    # gauge equivariance: every distinct-input solve lands at the same cost
    cmax, cmin = max(costs), min(costs)
    assert cmax - cmin < 1e-2 * abs(cmax) + 1e-3, (cmin, cmax)
    if rule == UpdateRule.PARALLEL:
        sizes = np.bincount(eng.robot_colors, minlength=eng.num_colors)
        updates = int(sum(sizes[s % eng.num_colors] for s in range(NUM_ITERS)))
    else:
        updates = NUM_ITERS
    dt_med = statistics.median(times)
    per_solve = dt_med / k_chain
    return {
        "f_init": f_init,
        "f_final": costs[-1],
        "updates_per_solve": updates,
        "per_solve_s": per_solve,
        "region_times_s": times,
        "spread": (max(times) - min(times)) / dt_med,
        "updates_per_sec": updates / per_solve,
    }


def main():
    try:
        hostenv.select_platform("gpu")
        facts = hostenv.device_facts()
    except (RuntimeError, OSError) as e:
        sys.exit(f"bench.py measures on a GPU only: {e}")
    hostenv.setup_compile_cache()
    log(f"devices={jax.devices()} card={facts['name_power_limit']}")
    # reference-parity sequential mode (stderr diagnostic; same harness)
    eng_s, st0_s, times_s, finals_s = measure(
        UpdateRule.ROUND_ROBIN, K_CHAIN, REGIONS
    )
    # headline: colored-parallel
    eng_p, st0_p, times_p, finals_p = measure(
        UpdateRule.PARALLEL, K_CHAIN, REGIONS
    )
    res_s = finish(
        eng_s, st0_s, times_s, finals_s, UpdateRule.ROUND_ROBIN, K_CHAIN
    )
    res_p = finish(
        eng_p, st0_p, times_p, finals_p, UpdateRule.PARALLEL, K_CHAIN
    )
    for name, res in (("RoundRobin", res_s), ("parallel", res_p)):
        log(
            f"{name}: {res['updates_per_sec']:.1f} updates/s "
            f"({res['per_solve_s']*1e3:.3f} ms/solve over {K_CHAIN} chained "
            f"distinct-input solves x {REGIONS} regions, "
            f"spread {res['spread']*100:.1f}%) "
            f"cost {res['f_init']:.1f} -> {res['f_final']:.1f}"
        )
    print(
        json.dumps(
            {
                "metric": "sphere2500_shape_5robot_rbcd_block_updates_per_sec",
                "value": res_p["updates_per_sec"],
                "unit": "iters/s",
                "vs_baseline": res_p["updates_per_sec"]
                / BASELINE_ITERS_PER_SEC,
                "tcg_iters_per_solve": "not measured",
                "per_solve_ms": res_p["per_solve_s"] * 1e3,
                "region_spread": res_p["spread"],
                "chained_solves_per_region": K_CHAIN,
                "regions": REGIONS,
                "roundrobin_updates_per_sec": res_s["updates_per_sec"],
                "device": facts,
            }
        )
    )


if __name__ == "__main__":
    main()
