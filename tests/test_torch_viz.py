"""The run figures of the PyTorch port (``io/viz.py``), the counterparts
of ``tests/test_viz.py``: each writes a rendered PNG, also with no
odometry, ground truth, loops or map, and with no keyframes; the port's
figure and the JAX package's, drawn from the same inputs, are the same
size in pixels and differ in few of them (matplotlib draws both); and
``run --figure`` writes the figure on the CPU.
"""
import json
import os

import numpy as np
import pytest

from scl_slam_tpu.io import viz as jviz
from scl_slam_tpu_torch import run as trun
from scl_slam_tpu_torch.io import viz

PNG = b"\x89PNG\r\n\x1a\n"


def _ring(n=40, r=10.0):
    t = np.linspace(0, 2 * np.pi, n)
    P = np.tile(np.eye(4), (n, 1, 1))
    P[:, 0, 3] = r * np.cos(t)
    P[:, 1, 3] = r * np.sin(t)
    return P


LOOPS = [
    {"pi": np.array([10.0, 0.0, 0.0]), "pj": np.array([10.1, 0.1, 0.0]), "kind": "intra"},
    {"pi": np.array([0.0, 10.0, 0.0]), "pj": np.array([0.2, 9.9, 0.0]), "kind": "inter"},
]


def _pixels(path):
    import matplotlib.image as mpimg

    return mpimg.imread(path)


def test_save_run_figure_full_matches_jax(tmp_path):
    kw = dict(odom=_ring(r=10.5), gt=_ring(r=9.9), loops=LOOPS,
              map_points=np.random.RandomState(0).randn(5000, 3) * 12,
              title="test run", subtitle="ATE 0.1 m")
    path = str(tmp_path / "traj.png")
    assert viz.save_run_figure(path, _ring(), **kw) == path
    data = open(path, "rb").read()
    assert data[:8] == PNG and len(data) > 10_000  # a rendered figure
    ref = jviz.save_run_figure(str(tmp_path / "jax.png"), _ring(), **kw)
    a, b = _pixels(path), _pixels(ref)
    assert a.shape == b.shape
    assert np.mean(np.any(np.abs(a - b) > 1e-3, axis=-1)) < 1e-3


def test_save_run_figure_minimal(tmp_path):
    path = str(tmp_path / "min.png")
    assert viz.save_run_figure(path, _ring(n=5)) == path
    assert open(path, "rb").read()[:8] == PNG


def test_save_run_figure_empty_est(tmp_path):
    path = str(tmp_path / "empty.png")
    assert viz.save_run_figure(path, np.zeros((0, 4, 4))) == path
    assert os.path.exists(path)


def test_save_fleet_figure_matches_jax(tmp_path):
    trajs = {"a": _ring(), "b": _ring(r=10.5)}
    kw = dict(gts={"a": _ring(r=9.9), "b": _ring(r=10.4)}, loops=LOOPS,
              map_points=np.random.RandomState(1).randn(3000, 3) * 12,
              title="fleet", subtitle="2 robots")
    path = str(tmp_path / "fleet.png")
    assert viz.save_fleet_figure(path, trajs, **kw) == path
    data = open(path, "rb").read()
    assert data[:8] == PNG and len(data) > 10_000
    ref = jviz.save_fleet_figure(str(tmp_path / "jax.png"), trajs, **kw)
    a, b = _pixels(path), _pixels(ref)
    assert a.shape == b.shape
    assert np.mean(np.any(np.abs(a - b) > 1e-3, axis=-1)) < 1e-3


def test_save_fleet_figure_empty(tmp_path):
    path = str(tmp_path / "fleet_empty.png")
    assert viz.save_fleet_figure(path, {}) == path


def test_run_figure_on_cpu(tmp_path, capsys):
    """``run --figure`` on the CPU writes trajectory.png beside the
    trajectories and names it in the report; a figure that fails is
    reported and does not fail the run."""
    out = str(tmp_path / "run")
    assert trun.main(["--device", "cpu", "--frames", "8", "--figure", "--output", out]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["figure"] == os.path.join(out, "trajectory.png")
    data = open(report["figure"], "rb").read()
    assert data[:8] == PNG and len(data) > 10_000
    report = {"frames": 1, "ate_rmse_m": 0.1, "loops_closed": 0}

    class Broken:
        def loop_constraints(self):
            raise RuntimeError("no loops to draw")

    args = trun.build_argparser().parse_args(["--output", out])
    trun.emit_figure(args, Broken(), np.zeros((0, 4, 4)), None, None, report)
    assert report["figure_error"] == "no loops to draw" and "figure" not in report
