"""Certified golden optima of the small generated worlds (CPU, fp64).

Runs the centralized Riemannian-staircase certified solve
(``models/certified.py``) at fp64 on each world and records the certified
global optimum in ``golden_optima.json`` at the repo root (merge semantics:
re-running a subset of worlds updates only those entries). The tests pin
their convergence goldens to these values. The 2,500-pose and GNC worlds are
certified on the GPU by ``chip_smoke.py`` instead.

Usage: python scripts/golden_solves.py [world ...]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dpgo_ros_tpu.utils import hostenv

hostenv.select_platform("cpu", 1)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
hostenv.setup_compile_cache()

from dpgo_ros_tpu.io.datasets import load_world  # noqa: E402
from dpgo_ros_tpu.models.certified import certified_solve  # noqa: E402

OUT = os.path.join(hostenv.REPO_ROOT, "golden_optima.json")

WORLDS = ("synthetic_grid9", "synthetic_grid125")


def main():
    names = sys.argv[1:] or list(WORLDS)
    for a in names:
        if a not in WORLDS:
            sys.exit(
                f"golden_solves.py: unknown world {a!r} "
                f"(choose from {sorted(WORLDS)})"
            )
    results = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            results = json.load(f)
    for name in names:
        t0 = time.time()
        print(f"=== {name} ===", flush=True)
        data = load_world(name, num_robots=1)[0]
        res = certified_solve(data, verbose=True)
        entry = {
            "certified_global_optimum": res.cost,
            "rounded_cost": res.rounded_cost,
            "refined_cost": res.refined_cost,
            "certified": res.certified,
            "rank": res.rank,
            "ranks_tried": list(res.ranks_tried),
            "min_eig": res.min_eig,
            "crit_residual": res.crit_residual,
        }
        results[name] = entry
        print(f"{name}: {entry} ({time.time() - t0:.1f} s)", flush=True)
        with open(OUT, "w") as f:
            json.dump(results, f, indent=2)
    print(f"wrote {OUT}", flush=True)


if __name__ == "__main__":
    main()
