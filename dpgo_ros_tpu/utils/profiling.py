"""Tracing / profiling hooks.

The reference's profiling is a ``std::chrono`` wall-clock around
``iterate(true)`` plus a per-iteration CSV (SURVEY.md §5.1,
``src/PGOAgentROS.cpp:159-162,853-894``); the CSV schema lives in
``utils/telemetry.py``. This module adds the device-side layer the reference
lacks:

* ``device_trace(dir)`` — context manager around ``jax.profiler.trace``:
  captures an XLA device trace (HLO op timeline, fusion costs, HBM traffic)
  viewable in TensorBoard / Perfetto.
* ``annotate(name)`` — ``jax.profiler.TraceAnnotation`` wrapper so host-side
  phases (init, weight rounds, export) show up on the same timeline.
* ``PhaseTimer`` — lightweight wall-clock phase accounting (JSON-dumpable),
  for environments where the full profiler is unavailable.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Capture a JAX/XLA profiler trace into ``log_dir`` (no-op if None)."""
    if not log_dir:
        yield
        return
    import jax

    os.makedirs(log_dir, exist_ok=True)
    with jax.profiler.trace(log_dir):
        yield


def annotate(name: str):
    """Named region on the profiler timeline (host + device)."""
    import jax

    return jax.profiler.TraceAnnotation(name)


class PhaseTimer:
    """Accumulating wall-clock phase timer.

    >>> pt = PhaseTimer()
    >>> with pt.phase("initialize"): ...
    >>> pt.summary()  # {"initialize": {"calls": 1, "total_sec": ...}}
    """

    def __init__(self):
        self._acc: Dict[str, Dict[str, float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            slot = self._acc.setdefault(
                name, {"calls": 0, "total_sec": 0.0, "max_sec": 0.0}
            )
            slot["calls"] += 1
            slot["total_sec"] += dt
            slot["max_sec"] = max(slot["max_sec"], dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "calls": int(v["calls"]),
                "total_sec": round(v["total_sec"], 6),
                "max_sec": round(v["max_sec"], 6),
            }
            for k, v in self._acc.items()
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)
