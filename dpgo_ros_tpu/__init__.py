"""dpgo_ros_tpu — a distributed pose-graph-optimization framework in JAX.

Built from scratch in JAX/XLA with the capabilities of the reference
mit-acl/dpgo_ros + DPGO stack (see SURVEY.md): rank-relaxed SE(d)
synchronization by Riemannian block-coordinate descent on the Stiefel
manifold, Nesterov acceleration, asynchronous bounded-staleness (ASAPP)
stepping, GNC-TLS robust optimization, and multi-robot coordination — with
pose blocks sharded over a `jax.sharding.Mesh` and separator-pose exchange as
XLA collectives instead of ROS topics.
"""

import jax as _jax

# The one matmul-precision decision for the whole solver: fp32 products run
# at full fp32. Left at XLA's default, fp32 einsums on a GPU may run in TF32
# (10-bit mantissa) in the retraction, the chordal solve and the
# certificate, and the fp32 block solve is held to its fp64 result at full
# fp32 (chip_smoke.py prints both). fp64 products are unaffected.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
