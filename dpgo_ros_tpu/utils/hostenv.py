"""Process set-up shared by every entry point: the backend and the persistent
compile cache.

``select_platform`` picks the backend explicitly, before first use, and fails
when it is not there; nothing falls back from the GPU to the CPU.
``setup_compile_cache`` keeps XLA's persistent compile cache where
``JAX_COMPILATION_CACHE_DIR`` says, else in a fixed directory inside the
checkout, one per platform (CPU and GPU entries never share a directory).
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
CACHE_ROOT = os.path.join(REPO_ROOT, ".jax_cache")


def ensure_cpu_devices(num_devices: int = 8) -> None:
    """Select the local CPU backend with ``num_devices`` virtual devices.

    Must be called before the first jax backend use (importing jax is fine).
    """
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={num_devices}"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


def select_platform(platform: str, cpu_devices: int = 8) -> None:
    """Make ``platform`` ("cpu" or "gpu") the default backend, or raise
    ``RuntimeError``. "gpu" keeps the CPU backend available beside CUDA for
    host-side helpers; the default device is the card."""
    import jax

    if platform == "cpu":
        ensure_cpu_devices(cpu_devices)
    elif platform == "gpu":
        jax.config.update("jax_platforms", "cuda,cpu")
    else:
        raise ValueError(f"unknown platform {platform!r}")
    try:
        got = jax.default_backend()
    except Exception as e:  # backend initialization failed: no usable card
        raise RuntimeError(
            f"platform {platform}: no {platform.upper()} backend "
            f"({type(e).__name__}: {e})"
        ) from None
    if got != platform:
        raise RuntimeError(
            f"platform {platform}: JAX found no {platform.upper()} device "
            f"(default backend: {got})"
        )


def compile_cache_dir(platform: str) -> str:
    """``JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache/
    <platform>``. The path is part of each cache key, so it never depends
    on a temporary name, a process id or the time."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CACHE_ROOT, platform
    )


def setup_compile_cache(
    min_compile_secs: float = 0.5, platform: str | None = None
) -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir` for
    ``platform`` (default: the default backend, which this initializes).
    Returns the directory."""
    import jax

    d = compile_cache_dir(platform or jax.default_backend())
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    return d


def nvidia_smi_name_power() -> str:
    """The card's ``name, power.limit`` line(s), exactly as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them; run
    as a child process that never imports JAX. Raises when it fails."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def device_facts() -> dict:
    """What every device number is reported with: JAX's view of the
    default backend plus the card's name and power limit."""
    import jax

    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
        "name_power_limit": nvidia_smi_name_power(),
    }
