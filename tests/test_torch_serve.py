"""The serving daemon of the PyTorch port (``scl_slam_tpu_torch/serve.py``),
its exports (``io/export.py``, ``Mapper.export_artifacts``,
``Mapper.start_map_publisher``) and ``utils/timing.py``, against the JAX
package, at tests/test_checkpoint.py's widths.

Held: a JAX ``SlamClient`` served by the port's server (the transport
framing is shared); the port's answers equal to a JAX ``SlamServer``'s on
the same frames (keyframe decisions exactly, poses within 1e-5 m: f32
compose of two libraries); the export files byte-equal to JAX's on the
same arrays, and ``export_artifacts`` byte-equal to JAX's on one state
(handed over by checkpoint); ``stats`` and the error for a frame without
a pose; the daemon's command line (a free port, a periodic map export,
``shutdown`` ending it with exit code 0); ``--odometry icp`` exiting 2.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import scl_slam_tpu.config as jconfig
from scl_slam_tpu.io import export as jexport
from scl_slam_tpu.runtime import checkpoint as jck
from scl_slam_tpu.serve import SlamClient as JaxClient
from scl_slam_tpu.serve import SlamServer as JaxServer
from scl_slam_tpu_torch import config as tconfig
from scl_slam_tpu_torch import serve
from scl_slam_tpu_torch.io import export
from scl_slam_tpu_torch.runtime import Mapper
from scl_slam_tpu_torch.runtime import checkpoint as ck
from scl_slam_tpu_torch.utils import timing
from test_torch_checkpoint import tiny
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(n=6):
    rng = np.random.RandomState(0)
    out = []
    for k in range(n):
        T = np.eye(4)
        c, s = np.cos(0.1 * k), np.sin(0.1 * k)
        T[:2, :2] = [[c, -s], [s, c]]
        T[:3, 3] = [2.0 * k, 0.3 * k, 0.0]
        out.append((rng.uniform(-20, 20, (400, 3)).astype(np.float32), T, 0.1 * k))
    return out


@pytest.fixture
def port_server():
    srv = serve.SlamServer(tiny(tconfig), device="cpu")
    up = threading.Event()
    t = threading.Thread(target=srv.serve, args=(0,), kwargs={"host": "127.0.0.1", "ready": up.set},
                         daemon=True)
    t.start()
    assert up.wait(10)
    yield srv
    srv._stop.set()
    t.join(5)


def test_jax_client_against_port_server(port_server, tmp_path):
    c = JaxClient(port=port_server.port)
    got = [c.frame(xyz, T, stamp) for xyz, T, stamp in _frames()]
    assert [r["keyframe"] for r in got] == [True] * 6 and all(r["loop"] is None for r in got)
    np.testing.assert_allclose(got[-1]["pose"], _frames()[-1][1], rtol=0, atol=1e-5)
    assert c.frame(np.zeros((4, 3), np.float32)) == {"error": "no pose given and odometry disabled"}
    stats = c.stats()
    assert {k: stats[k] for k in ("frames", "keyframes", "loops")} == {"frames": 7, "keyframes": 6, "loops": 0}
    assert set(stats["launches"]) >= {"max_image", "nn_select", "nearest_neighbors"}
    tr = c.trajectory()
    assert tr["poses"].shape == (6, 4, 4)
    np.testing.assert_allclose(tr["stamps"], [f[2] for f in _frames()], rtol=1e-6)
    assert c.save(str(tmp_path)) == {"ok": True}
    assert sorted(os.listdir(tmp_path)) == [
        "a_keyposes.pcd", "a_kitti.txt", "a_tum.txt", "global_map.ply", "loop_constraints.json"]
    assert c.shutdown() == {"ok": True}
    c.close()


def test_port_server_answers_as_jax_server():
    jsrv = JaxServer(tiny(jconfig), platform="cpu")
    tsrv = serve.SlamServer(tiny(tconfig), device="cpu")
    for xyz, T, stamp in _frames():
        req = {"xyz": xyz, "pose": T, "stamp": stamp}
        a, b = jsrv.handle("frame", req), tsrv.handle("frame", req)
        assert (a["keyframe"], a["loop"]) == (b["keyframe"], b["loop"])
        np.testing.assert_allclose(b["pose"], a["pose"], rtol=0, atol=1e-5)
    a, b = jsrv.handle("trajectory", {"robot": None}), tsrv.handle("trajectory", {"robot": None})
    np.testing.assert_allclose(b["poses"], a["poses"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(b["stamps"], a["stamps"])
    stats = tsrv.handle("stats", {})
    assert jsrv.handle("stats", {}) == {k: stats[k] for k in ("frames", "keyframes", "loops")}
    assert tsrv.handle("nonsense", {}) == jsrv.handle("nonsense", {})


def test_export_files_byte_equal_to_jax(tmp_path):
    rng = np.random.RandomState(1)
    xyz = rng.normal(0, 30, (257, 3)).astype(np.float32)
    colors = rng.randint(0, 255, (257, 3)).astype(np.uint8)
    loops = [{"i": 3, "j": 9, "pi": [1.0, 2.0, 0.5], "pj": [1.5, 2.5, 0.0], "kind": "intra",
              "sigma": 0.01}]
    for name, write in (
        ("a.ply", lambda mod, p: mod.save_ply(p, xyz)),
        ("c.ply", lambda mod, p: mod.save_ply(p, xyz, colors)),
        ("k.pcd", lambda mod, p: mod.save_pcd(p, xyz)),
        ("l.json", lambda mod, p: mod.save_loop_constraints(p, loops)),
    ):
        write(export, str(tmp_path / "port" / name))
        write(jexport, str(tmp_path / "jax" / name))
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    got = export.load_pcd(str(tmp_path / "port" / "k.pcd"))
    np.testing.assert_array_equal(got, jexport.load_pcd(str(tmp_path / "jax" / "k.pcd")))
    np.testing.assert_allclose(got, xyz, rtol=2e-7, atol=5e-7)  # 6 decimals


def test_export_artifacts_equal_jax_and_publisher(tmp_path, monkeypatch):
    """One state in both packages (a JAX session handed over by checkpoint):
    ``export_artifacts`` writes JAX's bytes; the publisher writes on its
    interval, survives a failed export, and stops."""
    jsrv = JaxServer(tiny(jconfig), platform="cpu")
    for xyz, T, stamp in _frames():
        jsrv.handle("frame", {"xyz": xyz, "pose": T, "stamp": stamp})
    jck.save(jsrv.mapper, str(tmp_path / "ckpt.npz"))
    m = ck.load(Mapper(tiny(tconfig), "cpu"), str(tmp_path / "ckpt.npz"))
    jsrv.mapper.export_artifacts(str(tmp_path / "jax"))
    m.export_artifacts(str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["a_keyposes.pcd", "global_map.ply", "loop_constraints.json"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n

    real, calls = m.export_artifacts, []

    def flaky(directory):
        calls.append(directory)
        if len(calls) == 1:
            raise OSError("disk full")
        real(directory)

    monkeypatch.setattr(m, "export_artifacts", flaky)
    stop = m.start_map_publisher(str(tmp_path / "pub"), interval=0.05)
    deadline = 200
    while len(calls) < 2 and deadline:
        threading.Event().wait(0.05)
        deadline -= 1
    stop()
    assert len(calls) >= 2 and (tmp_path / "pub" / "global_map.ply").exists()


def test_daemon_command_line(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("keyframe: {max_keyframes: 16, points_per_keyframe: 256, raw_points_capacity: 512}\n"
                   "loop: {near_keyframes: 2, submap_capacity: 512, queue_capacity: 8}\n"
                   "optimizer: {edge_capacity: 64, gn_iters: 2, cg_iters: 8}\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "scl_slam_tpu_torch.serve", "--port", "0", "--device", "cpu",
         "--config", str(cfg), "--map-every", "0.2", "--map-dir", str(tmp_path / "map")],
        env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("scl_slam_tpu_torch serving on :"), line
        c = serve.SlamClient(port=int(line.rsplit(":", 1)[1]))
        for xyz, T, stamp in _frames(3):
            assert c.frame(xyz, T, stamp)["keyframe"]
        threading.Event().wait(0.6)
        assert c.stats()["keyframes"] == 3
        c.shutdown()
        c.close()
        assert proc.wait(timeout=60) == 0
        assert (tmp_path / "map" / "a_keyposes.pcd").exists()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_timers_and_device_trace(tmp_path):
    t = timing.Timers("cpu")
    with t.time("stage"):
        torch.ones(8).sum()
    t.record("stage", 0.002)
    rep = t.report()["stage"]
    assert rep["count"] == 2 and rep["max_ms"] >= 2.0 and "stage" in t.pretty()
    with timing.device_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace.json").exists() and len(prof.key_averages()) > 0
