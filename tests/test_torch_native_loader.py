"""The C++ prefetching loader of the PyTorch port
(``io/native_loader.py``, ``csrc/dataloader.cpp``), the counterparts of
``tests/test_native_loader.py``'s loader cases, each held bit for bit
against the JAX package's ``io/kitti.read_velodyne_bin``; a lagging-worker
schedule (the first file far larger than the rest, two workers, a queue
of one) that the JAX package's copy of the loader deadlocks on; a read
error; and ``run --dataset kitti --loader native`` against ``--loader
python`` on a miniature KITTI tree (the same keyframes and trajectory).
"""
import json
import os
import threading

import numpy as np
import pytest

from scl_slam_tpu.io import kitti as jkio
from scl_slam_tpu_torch import run as trun
from scl_slam_tpu_torch.io import kitti as kio
from scl_slam_tpu_torch.io import native_loader


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


def test_builds():
    lib = native_loader.load_library()
    assert lib is native_loader.load_library()
    assert native_loader.build().name.startswith("libscl_loader_")


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
