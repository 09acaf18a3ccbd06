"""The C++ prefetching loader of the PyTorch port
(``io/native_loader.py``, ``csrc/dataloader.cpp``), the counterparts of
``tests/test_native_loader.py``'s loader cases, each held bit for bit
against the JAX package's ``io/kitti.read_velodyne_bin``; a lagging-worker
schedule (the first file far larger than the rest, two workers, a queue
of one) that the JAX package's copy of the loader deadlocks on; a read
error; and ``run --dataset kitti --loader native`` against ``--loader
python`` on a miniature KITTI tree (the same keyframes and trajectory).

The host Scan Context binning (``sc_images_batch``) against the JAX
package's C++ (built by its own Makefile into a private directory) and
against the port's plain ``scan_context.make``, and the replay's host path
under ``max_bin_points > 0`` in both packages.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import threading

import numpy as np
import pytest
import torch

import scl_slam_tpu.config as jconfig
from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.io import kitti as jkio
from scl_slam_tpu.io import native_loader as jnl
from scl_slam_tpu.runtime import mapper as jmapper
from scl_slam_tpu_torch import config as tconfig
from scl_slam_tpu_torch import run as trun
from scl_slam_tpu_torch.descriptors import scan_context as sc
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.io import kitti as kio
from scl_slam_tpu_torch.io import native_loader
from scl_slam_tpu_torch.ops import pointcloud as pc
from scl_slam_tpu_torch.runtime import mapper as M


@pytest.fixture(scope="module")
def bin_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("scans")
    rng = np.random.RandomState(0)
    paths = []
    for k in range(5):
        pts = rng.uniform(-50, 50, (100 + 50 * k, 4)).astype(np.float32)
        p = d / f"{k:06d}.bin"
        pts.tofile(p)
        paths.append(str(p))
    return paths


def _read_all(loader, timeout=60.0):
    """Everything ``loader`` yields, read in a thread joined with a
    timeout: a deadlocked loader fails the test instead of hanging it."""
    out, err = [], []

    def run():
        try:
            out.extend(loader)
        except Exception as e:  # surfaced below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"the loader did not finish within {timeout} s"
    if err:
        raise err[0]
    return out


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's ``io/native_loader`` on its C++ library built by
    its own Makefile (its flags) from a copy of its source in a private
    directory, so that no test writes into the JAX package or loads a
    library that another process is still writing."""
    d = tmp_path_factory.mktemp("jax_native")
    for name in ("Makefile", "dataloader.cpp"):
        shutil.copy(os.path.join(jnl._NATIVE_DIR, name), d)
    subprocess.run(["make", "-s", "-C", str(d)], check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnl, "_SO_PATH", str(d / "libscl_native.so"))
        mp.setattr(jnl, "_lib", None)
        assert jnl.load_library() is not None
        yield jnl


def test_builds():
    lib = native_loader.load_library()
    assert lib is native_loader.load_library()
    assert native_loader.build().name.startswith("libscl_loader_")


def test_build_failure_raises(monkeypatch, tmp_path):
    """No compiler, a compiler that fails and one that is not there raise
    RuntimeError, and so does the binning that needs the library."""
    false = shutil.which("false")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_loader.sc_images_batch(np.zeros((1, 4, 3), np.float32), None, 20, 60, 80.0, 1.65)
    monkeypatch.setenv("CXX", false)
    with pytest.raises(RuntimeError, match="build failed"):
        native_loader.load_library()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native_loader.build()
    assert not list(tmp_path.glob("*.so"))


def test_reads_in_order(bin_files):
    loader = native_loader.NativeScanLoader(bin_files, capacity=512, workers=3)
    out = _read_all(loader)
    loader.close()
    assert len(out) == 5
    for (xyz, n), p in zip(out, bin_files):
        truth = jkio.read_velodyne_bin(p)
        assert n == len(truth) and xyz.shape == (512, 3) and xyz.dtype == np.float32
        np.testing.assert_array_equal(xyz[:n], truth)
        assert np.all(xyz[n:] == 1e6)


def test_truncates_at_capacity(bin_files):
    loader = native_loader.NativeScanLoader(bin_files, capacity=120)
    xyz, n = next(iter(loader))
    assert n == 100  # the first file fits
    loader.close()
    loader = native_loader.NativeScanLoader([bin_files[4]], capacity=120, pad_value=-7.0)
    (xyz, n), = _read_all(loader)
    loader.close()
    assert n == 120  # truncated from 300
    np.testing.assert_array_equal(xyz, jkio.read_velodyne_bin(bin_files[4])[:120])


def test_lagging_worker_does_not_deadlock(tmp_path):
    """The first file is 4,000 times the size of the others: its worker
    falls behind while the other reads ahead. With two workers and a
    queue of one, a loader whose workers wait for room after the read
    (the JAX package's copy) waits forever; the port's claims only
    indices inside the queue's window and reads every scan in order."""
    rng = np.random.RandomState(1)
    sizes = [2_000_000] + [500] * 11
    paths = []
    for k, n in enumerate(sizes):
        p = tmp_path / f"{k:06d}.bin"
        rng.uniform(-80, 80, (n, 4)).astype(np.float32).tofile(p)
        paths.append(str(p))
    loader = native_loader.NativeScanLoader(
        paths, capacity=2_000_000, workers=2, queue_depth=1)
    out = _read_all(loader, timeout=60.0)
    loader.close()
    assert [n for _, n in out] == sizes
    for (xyz, n), p in zip(out, paths):
        np.testing.assert_array_equal(xyz[:n], jkio.read_velodyne_bin(p))


def test_read_error_raises(bin_files, tmp_path):
    loader = native_loader.NativeScanLoader(
        [bin_files[0], str(tmp_path / "missing.bin")], capacity=512)
    it = iter(loader)
    assert next(it)[1] == 100
    with pytest.raises(IOError):
        next(it)
    loader.close()


SMALL = """\
keyframe:
  max_keyframes: 64
  points_per_keyframe: 1024
  raw_points_capacity: 8192
  distance_threshold: 1.0
loop:
  near_keyframes: 4
  submap_capacity: 4096
  icp_iterations: 10
  queue_capacity: 32
optimizer:
  edge_capacity: 256
  gn_iters: 4
  cg_iters: 24
scan_context:
  exclude_recent: 8
"""


@pytest.fixture(scope="module")
def mini_kitti(tmp_path_factory):
    """A miniature KITTI odometry tree: two laps of simulated scans as
    float32 x, y, z, r files, cam0 poses through a non-trivial calib
    (the layout of ``tests/test_kitti_format.py``)."""
    root = tmp_path_factory.mktemp("kitti_root")
    seq_dir = root / "sequences" / "99" / "velodyne"
    seq_dir.mkdir(parents=True)
    (root / "poses").mkdir()
    world = kio.SyntheticWorld(seed=5, extent=90.0, pts_per_cluster=500, max_range=45.0)
    gt = kio.loop_trajectory(n_frames=24, radius=11.0, laps=2.0)
    Tr = np.eye(4)
    Tr[:3, :3] = [[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]
    Tr[:3, 3] = [0.05, -0.1, 0.2]
    lines = []
    for k in range(len(gt)):
        scan = world.scan_at(gt[k], max_points=16384, seed=k).astype(np.float32)
        np.concatenate([scan, np.zeros((len(scan), 1), np.float32)], 1).tofile(
            seq_dir / f"{k:06d}.bin")
        cam = Tr @ gt[k] @ np.linalg.inv(Tr)
        lines.append(" ".join(f"{v:.9e}" for v in cam[:3, :4].ravel()))
    (root / "poses" / "99.txt").write_text("\n".join(lines) + "\n")
    (root / "sequences" / "99" / "calib.txt").write_text(
        "Tr: " + " ".join(f"{v:.9e}" for v in Tr[:3, :4].ravel()) + "\n")
    (root / "small.yaml").write_text(SMALL)
    return str(root), gt


def test_run_native_loader_matches_python(mini_kitti, tmp_path, capsys):
    """``run --dataset kitti --loader native`` and ``--loader python`` on
    the CPU: the same scans, so the same keyframes, loops and trajectory
    (bit for bit on the CPU)."""
    root, gt = mini_kitti
    reports, trajs = {}, {}
    for loader in ("native", "python"):
        out = str(tmp_path / loader)
        rc = trun.main(["--dataset", "kitti", "--root", root, "--sequence", "99",
                        "--frames", str(len(gt)), "--device", "cpu", "--output", out,
                        "--config", os.path.join(root, "small.yaml"),
                        "--loader", loader, "--no-figure"])
        assert rc == 0
        reports[loader] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        trajs[loader] = np.loadtxt(os.path.join(out, "a_kitti.txt"))
    nat, py = reports["native"], reports["python"]
    assert nat["keyframes"] == py["keyframes"] > 0
    assert nat["loops_closed"] == py["loops_closed"]
    assert nat["ate_rmse_m"] == py["ate_rmse_m"] < 0.05, nat
    np.testing.assert_array_equal(trajs["native"], trajs["python"])
    seq = kio.KittiSequence(root, "99")
    get_scan = trun.native_scans([os.path.join(seq.velo_dir, f) for f in seq.frames])
    for k in range(len(seq)):
        np.testing.assert_array_equal(get_scan(k), seq.scan(k))
    with pytest.raises(ValueError, match="in order"):
        trun.native_scans([os.path.join(seq.velo_dir, seq.frames[0])])(1)


def sc_inputs():
    """tests/test_native_loader.py's inputs: 4 frames of 8,192 points,
    radii past max_radius, 10% masked."""
    rng = np.random.RandomState(3)
    B, N = 4, 8192
    theta = rng.uniform(-np.pi, np.pi, (B, N))
    r = rng.uniform(1, 90, (B, N))
    z = rng.uniform(-2, 6, (B, N))
    xyz = np.stack([r * np.cos(theta), r * np.sin(theta), z], -1).astype(np.float32)
    return xyz, rng.rand(B, N) > 0.1


def plain_images(xyz, mask, cfg=sc.ScanContextConfig()):
    cloud = pc.Cloud(torch.from_numpy(xyz), torch.from_numpy(np.asarray(mask)))
    return sc.make(cloud, cfg).image.numpy()


def test_sc_images_match_jax_and_plain(jax_native):
    """The port's binning bit-equal to the JAX package's C++ (built
    -march=native, so with fused multiply-adds where the host has them:
    they move no bin on these inputs), and within 2 bins > 1e-5 of the
    plain ``scan_context.make`` (its atan2 against the polynomial; 0
    measured)."""
    cfg = sc.ScanContextConfig()
    xyz, mask = sc_inputs()
    args = (cfg.num_rings, cfg.num_sectors, cfg.max_radius, cfg.lidar_height)
    got = native_loader.sc_images_batch(xyz, mask, *args, n_threads=2)
    assert got.shape == (4, 20, 60) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_native.sc_images_batch(xyz, mask, *args, n_threads=2))
    np.testing.assert_array_equal(got, native_loader.sc_images_batch(xyz, mask, *args, n_threads=1))
    mismatch = np.abs(got - plain_images(xyz, mask)) > 1e-5
    assert mismatch.sum() <= 2, f"{mismatch.sum()} bins disagree"
    np.testing.assert_array_equal(  # mask None: every point valid
        native_loader.sc_images_batch(xyz, None, *args), plain_images(xyz, np.ones(mask.shape, bool)))


def test_sc_images_all_masked_and_out_of_range(jax_native):
    cfg = sc.ScanContextConfig()
    args = (cfg.num_rings, cfg.num_sectors, cfg.max_radius, cfg.lidar_height)
    far = np.full((2, 64, 3), 500.0, np.float32)  # every point past max_radius
    masked = np.zeros((1, 64, 3), np.float32)
    for xyz, mask in ((far, np.ones((2, 64), bool)), (masked, np.zeros((1, 64), bool))):
        got = native_loader.sc_images_batch(xyz, mask, *args)
        assert got.shape == (len(xyz), 20, 60) and (got == 0).all()
        np.testing.assert_array_equal(got, jax_native.sc_images_batch(xyz, mask, *args))
        np.testing.assert_array_equal(got, plain_images(xyz, mask))
    assert native_loader.sc_images_batch(np.zeros((0, 64, 3), np.float32), None, *args).shape == (0, 20, 60)
    with pytest.raises(ValueError):
        native_loader.sc_images_batch(np.zeros((2, 64), np.float32), None, *args)


def test_sc_images_ring_boundaries_unfused():
    """One point a frame within 1e-5 m of a ring boundary: each lands in
    the plain ``polar_bins`` ring. The library is built with
    ``-ffp-contract=off``; built -march=native (fusing x * x + y * y into
    an FMA) it moved 629 of 50,000 such points on an AVX-512 host."""
    rng = np.random.RandomState(1)
    n = 4000
    r = rng.randint(1, 20, n) * 4.0 + rng.uniform(-1e-5, 1e-5, n)
    theta = rng.uniform(-np.pi, np.pi, n)
    xyz = np.stack([r * np.cos(theta), r * np.sin(theta), np.ones(n)], -1).astype(np.float32)
    img = native_loader.sc_images_batch(xyz[:, None], None, 20, 60, 80.0, 1.65).reshape(n, -1)
    assert (np.count_nonzero(img, axis=1) == 1).all()
    ring, _, _ = pc.polar_bins(torch.from_numpy(xyz), torch.ones(n, dtype=torch.bool), 20, 60, 80.0)
    np.testing.assert_array_equal(img.argmax(1) // 60, ring.numpy())


def test_host_path_bins_every_point(jax_native, monkeypatch):
    """With ``max_bin_points > 0`` the card's ``make`` strides the scan
    before binning; the replay's host path bins every point, in both
    packages (a difference of both, kept). The JAX replay is stopped at its
    device program, after its binning call is recorded; the port's runs
    one chunk, whose DB images are the binning of every point."""
    n_frames, cap = 4, 2048

    def cfg(mod):
        return mod.SlamConfig(
            keyframe=mod.KeyframeConfig(max_keyframes=8, points_per_keyframe=256,
                                        raw_points_capacity=cap),
            loop=mod.LoopConfig(submap_capacity=512, queue_capacity=8),
            optimizer=mod.OptimizerConfig(edge_capacity=16),
            scan_context=mod.ScanContextParams(max_bin_points=512),
        )

    rng = np.random.RandomState(0)
    scans = [rng.uniform(-40, 40, (cap, 3)).astype(np.float32) for _ in range(n_frames)]
    eye = np.eye(3, dtype=np.float32)
    ts = [np.float32([2.0 * k, 0, 0]) for k in range(n_frames)]
    kw = dict(apply_gate=False, batch=2, chunk_batches=2, host_descriptors=True)
    calls = []
    binning = jax_native.sc_images_batch

    def recording(xyz, mask, *a, **k):
        calls.append((xyz.copy(), a, k))
        return binning(xyz, mask, *a, **k)

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop

    monkeypatch.setattr(jax_native, "sc_images_batch", recording)
    monkeypatch.setattr(jmapper, "_replay_batches_wire", stop)
    with pytest.raises(Stop):
        jmapper.Mapper(cfg(jconfig)).replay(
            [jse3.Pose(eye, t) for t in ts], scans, [0.0] * n_frames, **kw)
    (xyz, args, kwargs), = calls
    np.testing.assert_array_equal(xyz, np.stack(scans))  # every point, no stride
    assert len(args) == 4 and not kwargs  # rings, sectors, radius, height: no max_bin_points

    m = M.Mapper(cfg(tconfig), "cpu")
    m.replay([se3.Pose(eye, t) for t in ts], scans, [0.0] * n_frames, **kw)
    got = m.state.desc_db.descriptors[:n_frames].numpy()
    ones = np.ones((n_frames, cap), bool)
    np.testing.assert_array_equal(got, binning(np.stack(scans), ones, *args))
    strided = plain_images(np.stack(scans), ones, dataclasses.replace(
        sc.ScanContextConfig(), max_bin_points=512))
    assert (np.abs(got - strided) > 1e-5).any()  # the card's make would stride
