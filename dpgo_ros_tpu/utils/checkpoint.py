"""Disk checkpoint / resume for solver state.

The reference has *no* persistence: its checkpoint subsystem is in-memory
warm-start caches across optimization rounds, lost on process death
(SURVEY.md §5.4, ``src/PGOAgentROS.cpp:354-361,1391-1456``). A production
fleet solver needs durable state — a preempted accelerator job or a rebooted robot
must be able to resume mid-solve. This module provides that capability:

* ``save_state`` / ``load_state`` — one ``RBCDState`` pytree (plus the
  engine's lifting matrix and arbitrary JSON metadata) to/from a directory.
* ``CheckpointManager`` — periodic checkpointing with retention, suitable
  as an ``RBCDEngine.run(callback=...)`` hook or called directly from a
  training loop; ``latest()`` finds the newest step for resume.

Backends:

* ``npz`` (default) — single-file numpy archive + JSON sidecar. Host-local,
  synchronous, zero extra dependencies; right for the single-process
  engine/fleet paths.
* ``orbax`` — Orbax ``PyTreeCheckpointer``; right for sharded device arrays
  on a multi-host mesh (each host writes its shards). Optional: only
  imported when requested.

Checkpoints are backend- and dtype-exact: a resumed run continues the exact
deterministic trajectory of the uninterrupted run (tested in
``tests/test_checkpoint.py``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np

_META_NAME = "meta.json"
_ARRAYS_NAME = "state.npz"
_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten_state(state) -> Dict[str, np.ndarray]:
    """NamedTuple pytree -> {field: ndarray} (host copies)."""
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def save_state(
    path: str,
    state,
    ylift: Optional[np.ndarray] = None,
    meta: Optional[Dict[str, Any]] = None,
    backend: str = "npz",
) -> str:
    """Write one checkpoint to directory ``path`` (created/overwritten).

    ``state`` is any NamedTuple of arrays (``RBCDState``); ``ylift`` is the
    engine's lifting matrix (required to round a restored iterate back to
    SE(d) consistently); ``meta`` is JSON-serializable run metadata.
    """
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    arrays = _flatten_state(state)
    if ylift is not None:
        arrays["__ylift__"] = np.asarray(ylift)
    doc = {
        "format": 1,
        "backend": backend,
        "state_class": type(state).__name__,
        "fields": list(state._fields),
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "meta": meta or {},
    }
    if backend == "npz":
        np.savez(os.path.join(tmp, _ARRAYS_NAME), **arrays)
    elif backend == "orbax":
        import orbax.checkpoint as ocp

        ckptr = ocp.PyTreeCheckpointer()
        ckptr.save(
            os.path.abspath(os.path.join(tmp, "orbax")),
            {k: v for k, v in arrays.items()},
        )
    else:
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    with open(os.path.join(tmp, _META_NAME), "w") as f:
        json.dump(doc, f, indent=1)
    # atomic-ish swap so a crash mid-save never corrupts the latest ckpt
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def load_state(
    path: str, state_cls=None
) -> Tuple[Any, Optional[np.ndarray], Dict[str, Any]]:
    """Load a checkpoint directory -> (state, ylift, meta).

    ``state_cls`` defaults to ``RBCDState``; pass the matching NamedTuple
    class for other state pytrees (e.g. the SPMD sharded state).
    """
    with open(os.path.join(path, _META_NAME)) as f:
        doc = json.load(f)
    if doc["backend"] == "npz":
        with np.load(os.path.join(path, _ARRAYS_NAME)) as z:
            arrays = {k: z[k] for k in z.files}
    else:
        import orbax.checkpoint as ocp

        ckptr = ocp.PyTreeCheckpointer()
        arrays = ckptr.restore(os.path.abspath(os.path.join(path, "orbax")))
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
    ylift = arrays.pop("__ylift__", None)
    if state_cls is None:
        from dpgo_ros_tpu.parallel.rbcd import RBCDState

        state_cls = RBCDState
    import jax.numpy as jnp

    missing = [f for f in state_cls._fields if f not in arrays]
    if missing:
        raise ValueError(
            f"checkpoint at {path} missing fields {missing} for "
            f"{state_cls.__name__}"
        )
    state = state_cls(**{f: jnp.asarray(arrays[f]) for f in state_cls._fields})
    return state, ylift, doc.get("meta", {})


class CheckpointManager:
    """Periodic checkpoints under ``root/step_<N>`` with retention.

    >>> mgr = CheckpointManager(root, every=50, max_to_keep=3)
    >>> eng.run(st, callback=lambda it, s: mgr.maybe_save(it, s, eng.Ylift))
    >>> step, path = mgr.latest()
    """

    def __init__(
        self,
        root: str,
        every: int = 0,
        max_to_keep: int = 3,
        backend: str = "npz",
    ):
        self.root = root
        self.every = every
        self.max_to_keep = max_to_keep
        self.backend = backend
        os.makedirs(root, exist_ok=True)

    def step_path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def save(self, step: int, state, ylift=None, meta=None) -> str:
        meta = dict(meta or {})
        meta["step"] = int(step)
        p = save_state(
            self.step_path(step), state, ylift, meta, backend=self.backend
        )
        self._retain()
        return p

    def maybe_save(self, step: int, state, ylift=None, meta=None):
        """Callback-friendly: saves when ``step`` hits the cadence."""
        if self.every > 0 and step > 0 and step % self.every == 0:
            return self.save(step, state, ylift, meta)
        return None

    def steps(self):
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and os.path.isfile(
                os.path.join(self.root, name, _META_NAME)
            ):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[Tuple[int, str]]:
        s = self.steps()
        if not s:
            return None
        return s[-1], self.step_path(s[-1])

    def _retain(self):
        s = self.steps()
        for old in s[: max(0, len(s) - self.max_to_keep)]:
            shutil.rmtree(self.step_path(old), ignore_errors=True)
