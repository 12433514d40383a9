"""Multi-host (multi-process) SPMD execution over DCN.

SURVEY.md §7 step 8: the reference scales by adding robot *processes* on a
lossy ROS network (`src/PGOAgentROS.cpp:45-82`); this framework
scales by adding *hosts* to the device mesh — the same `shard_map` program
from :mod:`dpgo_ros_tpu.parallel.spmd` runs unchanged, with XLA routing the
separator all_gather over the devices' interconnect within a host and
the network across hosts.

This module holds the process-level plumbing:

* :func:`initialize` — bring up the JAX distributed runtime (coordinator
  rendezvous). On a multi-host cluster each process sees its local devices
  and the global
  mesh spans all of them; for CI/dev the same code path runs on CPU
  processes with Gloo collectives (``platform="cpu"`` forces N virtual
  local devices per process).
* :func:`global_mesh` — a 1-D ``robots`` mesh over every global device,
  process-contiguous (each host owns a contiguous robot range, so the only
  cross-DCN traffic is the separator exchange).

Every process must call :func:`initialize` before any other JAX use, then
build identical problem/config objects (the dataset is replicated host-side
— it is tiny next to device state) and execute the same jitted steps in the
same order. ``spmd.build_spmd_step`` device_puts all tensors to global
shardings and passes them as jit arguments, which is exactly the multi-host
contract.

Demo/validation entry: ``scripts/multihost_demo.py`` (launched once per process);
``tests/test_multihost.py`` runs it as 2 CPU processes × 4 virtual devices
and asserts both agree on the converged cost.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    platform: Optional[str] = None,
    local_device_count: Optional[int] = None,
) -> None:
    """Initialize the JAX distributed runtime for this process.

    Must run before the first JAX backend use. ``platform="cpu"`` with
    ``local_device_count=k`` gives k virtual CPU devices per process
    (collectives over Gloo) — the CI stand-in for one host with k devices.
    On real accelerator hosts leave both unset; the PJRT plugin discovers
    local devices and process topology.
    """
    if platform == "cpu" and local_device_count:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={local_device_count}"
            ).strip()
    import jax

    if platform is not None:
        jax.config.update("jax_platforms", platform)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "robots"):
    """1-D mesh over all global devices, ordered process-contiguously.

    Process-major ordering keeps each host's robot blocks local to it: the
    colored-parallel solve touches only local shards; only the fused
    separator ``all_gather`` crosses DCN.
    """
    import jax
    from jax.sharding import Mesh

    devs = sorted(
        jax.devices(), key=lambda d: (d.process_index, d.id)
    )
    return Mesh(np.array(devs), (axis,))


def is_multihost() -> bool:
    import jax

    return jax.process_count() > 1
