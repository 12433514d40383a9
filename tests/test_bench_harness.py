"""The round-5 bench harness's core correctness property: the chained
distinct-input perturbation is an O(r) gauge rotation, so every solve in
a timed region does identical work on different bits (bench.py)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np

from dpgo_ros_tpu.io.datasets import load_dataset
from dpgo_ros_tpu.models.problem import LiftedProblem
from dpgo_ros_tpu.ops import quadratic
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu.utils.config import AgentConfig


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_mod",
        os.path.join(os.path.dirname(__file__), "..", "bench.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gauge_perturbation_preserves_cost_and_manifold():
    bench = _load_bench()
    data = load_dataset("synthetic_grid9", num_robots=1)
    prob = LiftedProblem.from_data(data, r=5, dtype=jnp.float32)
    eng = RBCDEngine(prob, AgentConfig(num_robots=1, dtype="float32"))
    st = eng.initialize()
    perturb = bench.make_perturb(prob.r)
    f0 = float(quadratic.cost(st.X, prob.edges))
    for i, c in enumerate((0.0, 1.7, 123.4)):
        Xp = perturb(st.X, jnp.asarray(c, jnp.float32), np.float32(i + 1))
        # distinct bits unless the rotation angle is ~0
        if c or i:
            assert float(jnp.abs(Xp - st.X).max()) > 1e-4
        # cost invariant (the solver does identical work)
        fp = float(quadratic.cost(Xp, prob.edges))
        assert abs(fp - f0) < 1e-3 * max(abs(f0), 1.0), (fp, f0)
        # Stiefel feasibility preserved: Y^T Y = I per pose
        Y = np.asarray(Xp[:, :, :3], np.float64)
        G = np.einsum("nra,nrb->nab", Y, Y)
        err = np.abs(G - np.eye(3)).max()
        assert err < 1e-5, err
