"""Test configuration: run all tests on a virtual 8-device CPU mesh.

Sharding correctness is validated on `xla_force_host_platform_device_count=8`
CPU devices; the GPU path, one card and four, is checked by
`chip_smoke.py` on the card. No test here needs a GPU.
"""

from dpgo_ros_tpu.utils import hostenv

hostenv.ensure_cpu_devices(8)

import jax  # noqa: E402

# fp64 for numeric golden tests (the reference solver is double-precision
# Eigen); the device path runs fp32 — dtype is a parameter throughout.
jax.config.update("jax_enable_x64", True)

# persistent compile cache: JAX_COMPILATION_CACHE_DIR, else the checkout's
# fixed per-platform directory (hostenv.compile_cache_dir)
hostenv.setup_compile_cache(min_compile_secs=0.05, platform="cpu")
