"""Named datasets: seeded generated worlds, and the reference's bundled files.

Generated worlds (``io/synthetic.py``) stand in for the reference's bundled
benchmark files at their shapes, with exact ground truth and, for the GNC
world, exact outlier labels. Their names start with ``synthetic_`` so that
no result can be mistaken for one on the bundled file of similar shape:

* ``synthetic_grid9`` — 9-pose 3×3×1 grid, 14 edges (tinyGrid3D has 9 and
  11);
* ``synthetic_grid125`` — 125-pose 5×5×5 grid, 244 edges (smallGrid3D has
  125 and 297);
* ``synthetic_sphere2500`` — 50 rings of 50 poses: 2,499 odometry edges and
  2,450 loop closures, sphere2500's 4,949 edges (the sync and async demos);
* ``synthetic_gnc8`` — 8-robot sphere world whose loop closures include
  planted, labeled outliers (the GNC demo).

The bundled files (``G2O_DATASETS``, the tunnels CSVs) are read only from
``DPGO_TPU_DATA_DIR``. A missing file is an error; a generated world is never
substituted for it.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from dpgo_ros_tpu.io.csv_loader import load_multi_robot_csv
from dpgo_ros_tpu.io.partition import partition_g2o
from dpgo_ros_tpu.io.synthetic import generate_world
from dpgo_ros_tpu.types import PoseGraphData


class World(NamedTuple):
    """A generated world's recipe: ``generate_world(kind, **kwargs)``."""

    kind: str
    kwargs: Dict
    num_robots: int  # the demo's robot count


WORLDS: Dict[str, World] = {
    # noisier than the default and with diagonal loop closures, so that
    # odometry initialization starts far from the optimum (as tinyGrid3D)
    "synthetic_grid9": World(
        "grid3d",
        dict(grid_shape=(3, 3, 1), rot_noise=0.05, trans_noise=0.1,
             loop_radius=2.3, seed=1),
        1,
    ),
    "synthetic_grid125": World(
        "grid3d", dict(grid_shape=(5, 5, 5), seed=0), 2
    ),
    # rotation / translation noise 0.05 rad / 0.1 (information 400 / 100):
    # the demo's relative-change tolerance then stops near f*, as on
    # sphere2500
    "synthetic_sphere2500": World(
        "sphere", dict(n=2500, rot_noise=0.05, trans_noise=0.1, seed=0), 5
    ),
    "synthetic_gnc8": World(
        "sphere", dict(n=2000, outlier_ratio=0.2, seed=1), 8
    ),
}

G2O_DATASETS = {
    # name: (poses, edges) — SURVEY.md §2.5
    "tinyGrid3D": (9, 11),
    "smallGrid3D": (125, 297),
    "parking-garage": (1661, 6275),
    "sphere2500": (2500, 4949),
    "torus3D": (5000, 9048),
    "cubicle": (5750, 16869),
}
TUNNELS = "tunnels"  # 8-robot CSV dataset (reference dpgo_gnc_demo.launch)


def load_world(
    name: str, num_robots: Optional[int] = None, balance: str = "poses",
    **overrides,
) -> Tuple[PoseGraphData, np.ndarray, np.ndarray]:
    """Generate a registered world; returns ``(data, ground_truth (n,3,4),
    outlier_mask (E,))``. ``overrides`` replace recipe arguments (tests cut
    the size this way)."""
    if name not in WORLDS:
        raise KeyError(
            f"unknown generated world {name!r}; choose from {sorted(WORLDS)}"
        )
    w = WORLDS[name]
    kw = {**w.kwargs, **overrides}
    return generate_world(
        w.kind, num_robots=num_robots or w.num_robots, balance=balance, **kw
    )


def golden_optimum(name: str) -> float:
    """Certified fp64 optimum of a small generated world, from
    ``golden_optima.json`` (written by ``scripts/golden_solves.py``)."""
    import json

    from dpgo_ros_tpu.utils.hostenv import REPO_ROOT

    with open(os.path.join(REPO_ROOT, "golden_optima.json")) as f:
        return json.load(f)[name]["certified_global_optimum"]


def data_dir() -> str:
    d = os.environ.get("DPGO_TPU_DATA_DIR")
    if not d:
        raise FileNotFoundError(
            "bundled datasets are read from DPGO_TPU_DATA_DIR, which is not "
            "set; use a generated world (--dataset "
            f"{'/'.join(sorted(WORLDS))}) or pass a file with --g2o/--csv"
        )
    return d


def _existing(path: str) -> str:
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"bundled dataset file {path} not found (DPGO_TPU_DATA_DIR)"
        )
    return path


def dataset_path(name: str) -> str:
    return _existing(os.path.join(data_dir(), f"{name}.g2o"))


def tunnels_paths(num_robots: int = 8) -> List[str]:
    return [
        _existing(
            os.path.join(data_dir(), TUNNELS, f"robot{r}", "measurements.csv")
        )
        for r in range(num_robots)
    ]


def load_dataset(
    name: str, num_robots: Optional[int] = None, balance: str = "poses"
) -> PoseGraphData:
    """A generated world by name, or a bundled file from
    ``DPGO_TPU_DATA_DIR``."""
    if name in WORLDS:
        return load_world(name, num_robots, balance)[0]
    if name == TUNNELS:
        return load_multi_robot_csv(tunnels_paths(num_robots or 8))
    if name not in G2O_DATASETS:
        raise KeyError(
            f"unknown dataset {name!r}; generated worlds: {sorted(WORLDS)}; "
            f"bundled files: {sorted(G2O_DATASETS) + [TUNNELS]}"
        )
    return partition_g2o(dataset_path(name), num_robots or 1, balance=balance)
