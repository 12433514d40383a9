"""Multi-host SPMD RBCD demo — launch once per process.

Validates SURVEY.md §7 step 8 (pjit over ≥2 hosts, robots axis across
hosts) on CPU: N CPU processes × k virtual devices each form a global
N·k-device mesh with Gloo collectives standing in for the network. It is a
CPU-only demo: a GPU host runs one process per card set, and this repo's
GPU path is one process (``chip_smoke.py``).

    python scripts/multihost_demo.py --num_processes 2 --process_id 0 &
    python scripts/multihost_demo.py --num_processes 2 --process_id 1 &

Prints one parseable line per process:
    MULTIHOST_RESULT {"process_id": i, "init_cost": ..., "final_cost": ...,
                      "steps": n, "elapsed_s": ...}
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dpgo_ros_tpu.parallel import multihost


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:12360")
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--local_devices", type=int, default=4)
    ap.add_argument("--dataset", default="synthetic_grid125")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--rank", type=int, default=5)
    ap.add_argument("--checkpoint_dir", default=None,
                    help="save the final full state here (process 0 writes)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint dir to resume from (all processes read)")
    a = ap.parse_args()

    multihost.initialize(
        a.coordinator,
        a.num_processes,
        a.process_id,
        platform="cpu",
        local_device_count=a.local_devices,
    )

    import jax
    import jax.numpy as jnp
    import numpy as np

    from dpgo_ros_tpu.utils import hostenv

    hostenv.setup_compile_cache()

    from dpgo_ros_tpu.io.datasets import load_dataset
    from dpgo_ros_tpu.models.problem import LiftedProblem
    from dpgo_ros_tpu.ops import quadratic
    from dpgo_ros_tpu.parallel.rbcd import RBCDEngine
    from dpgo_ros_tpu.parallel.spmd import (
        ShardedProblem,
        build_spmd_step,
        gather_trajectory,
    )
    from dpgo_ros_tpu.utils.config import AgentConfig, InitMethod, UpdateRule

    M = len(jax.devices())  # one robot block per global device
    print(
        f"# proc {jax.process_index()}/{jax.process_count()}: "
        f"{len(jax.local_devices())} local / {M} global devices",
        file=sys.stderr,
        flush=True,
    )

    # Every process builds the identical replicated problem (deterministic).
    data = load_dataset(a.dataset, num_robots=M)
    prob = LiftedProblem.from_data(data, r=a.rank)
    cfg = AgentConfig(
        num_robots=M,
        update_rule=UpdateRule.PARALLEL,
        local_initialization_method=InitMethod.ODOMETRY,
        RTR_gradnorm_tol=0.5,
        dtype="float32",
    )
    eng = RBCDEngine(prob, cfg)
    st0 = eng.initialize()
    X0 = np.asarray(st0.X, np.float32)
    e_full = eng._edges(st0.weights)
    f_init = float(quadratic.cost(st0.X, e_full))

    sp = ShardedProblem.build(prob, X0, eng.robot_colors, num_devices=M)
    mesh = multihost.global_mesh()
    st, step = build_spmd_step(sp, mesh, cfg)

    from dpgo_ros_tpu.parallel.spmd import gather_state, place_state
    from dpgo_ros_tpu.utils import checkpoint as ckpt

    it0 = 0
    if a.resume:
        loaded, _, meta = ckpt.load_state(a.resume, type(st))
        st = place_state(loaded, st)
        it0 = int(meta.get("it", 0))
        print(f"# proc {jax.process_index()}: resumed from {a.resume} "
              f"(it {it0})", file=sys.stderr, flush=True)

    t0 = time.time()
    for it in range(it0, a.steps):
        st = step(np.int32(it), np.int32(0), st)
    jax.block_until_ready(st.X)
    elapsed = time.time() - t0

    if a.checkpoint_dir:
        host_state = gather_state(st)  # collective: all processes join
        if jax.process_index() == 0:
            ckpt.save_state(a.checkpoint_dir, host_state,
                            meta={"it": a.steps})
            print(f"# checkpoint written to {a.checkpoint_dir}",
                  file=sys.stderr, flush=True)

    Xg = gather_trajectory(sp, st, prob.num_poses)
    f_final = float(quadratic.cost(jnp.asarray(Xg), e_full))
    print(
        "MULTIHOST_RESULT "
        + json.dumps(
            {
                "process_id": jax.process_index(),
                "num_processes": jax.process_count(),
                "global_devices": M,
                "init_cost": f_init,
                "final_cost": f_final,
                "steps": a.steps,
                "elapsed_s": round(elapsed, 3),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
