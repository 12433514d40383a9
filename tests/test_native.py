"""Parity tests: native C++ ingestion vs the pure-Python parsers."""

import numpy as np
import pytest

from dpgo_ros_tpu.io import native
from dpgo_ros_tpu.io.csv_loader import load_measurements_csv
from dpgo_ros_tpu.io.datasets import load_dataset
from dpgo_ros_tpu.io.g2o import read_g2o
from world_files import world_g2o, write_robot_csvs

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no toolchain)"
)


def test_native_g2o_matches_python(monkeypatch, tmp_path):
    path, _, _ = world_g2o(tmp_path, "synthetic_grid125")
    monkeypatch.setenv("DPGO_TPU_NO_NATIVE", "1")  # force the Python path
    mp, n_p, vp = read_g2o(path)
    monkeypatch.delenv("DPGO_TPU_NO_NATIVE")
    mn, n_n, vn = native.read_g2o_native(path)
    assert n_n == n_p
    assert len(mn) == len(mp)
    assert np.array_equal(mn.src_frame, mp.src_frame)
    assert np.array_equal(mn.dst_frame, mp.dst_frame)
    assert np.allclose(mn.R, mp.R, atol=1e-12)
    assert np.allclose(mn.t, mp.t, atol=1e-12)
    assert np.allclose(mn.kappa, mp.kappa, rtol=1e-12)
    assert np.allclose(mn.tau, mp.tau, rtol=1e-12)
    assert vn is not None and vp is not None and len(vn) == len(vp)
    for k in vp:
        assert np.allclose(vn[k], vp[k], atol=1e-12)


def test_native_csv_matches_python(monkeypatch, tmp_path):
    path = write_robot_csvs(
        tmp_path, load_dataset("synthetic_gnc8", num_robots=8)
    )[0]
    monkeypatch.setenv("DPGO_TPU_NO_NATIVE", "1")  # force the Python path
    mp = load_measurements_csv(path)
    monkeypatch.delenv("DPGO_TPU_NO_NATIVE")
    mn = native.read_csv_native(path)
    assert len(mn) == len(mp)
    assert np.array_equal(mn.src_robot, mp.src_robot)
    assert np.array_equal(mn.src_frame, mp.src_frame)
    assert np.allclose(mn.R, mp.R, atol=1e-12)
    assert np.allclose(mn.t, mp.t, atol=1e-12)
    assert np.allclose(mn.kappa, mp.kappa)
    assert np.allclose(mn.tau, mp.tau)
    assert np.array_equal(mn.fixed_weight, mp.fixed_weight)
    assert np.array_equal(mn.edge_type, mp.edge_type)
