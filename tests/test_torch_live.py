"""The live single-robot path of the PyTorch port against the JAX package:
``Mapper.add_frame`` + ``spin_once`` + ``optimize`` on 40 frames of a
revisiting synthetic drive with random-walk odometry drift, so that
descriptor hits, solo ICP, the loop queue, the drain and the pose-graph
solve all run; then the runner ``scl_slam_tpu_torch.run`` on the CPU, and
the KITTI configuration that ``chip_smoke.py`` builds in code.

Held equal: the keyframes, every loop decision and matched index, the
frames at which the throttled solve ran, the factor-graph rows (loop
endpoints included) and the dedup markers. Tolerances, with their
reasons: ICP fitness 2e-2 relative (see test_torch_registration.py: on the
CPU JAX's NN ranks by the expanded-form distance); the trajectory after a
rigid alignment 5e-3 m, and its ATE 1e-3 m: the weak default prior leaves
the solve a near-gauge freedom (translation sigma 1e4 m) along which two
CG runs that differ by f32 rounding end a few cm apart before alignment.
"""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import scl_slam_tpu.config as jconfig
from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.ops import pointcloud as jpc
from scl_slam_tpu.runtime import mapper as JM
from scl_slam_tpu_torch import config as tconfig
from scl_slam_tpu_torch import run as trun
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.io import kitti
from scl_slam_tpu_torch.io import trajectory as tio
from scl_slam_tpu_torch.runtime import mapper as M
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)

N_FRAMES = 40
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(mod):
    return mod.SlamConfig(
        keyframe=mod.KeyframeConfig(
            max_keyframes=64, points_per_keyframe=1024, raw_points_capacity=4096,
        ),
        loop=mod.LoopConfig(
            near_keyframes=4, submap_capacity=2048, icp_iterations=20,
            queue_capacity=16,
            # sparse surface samples: tests/test_pipeline.py's fitness gate
            history_fitness_score=8.0,
        ),
        # the demo's noise model: the odometry sigmas state the drift, the
        # loop noise is calibrated to this world's fitness floor
        optimizer=mod.OptimizerConfig(
            edge_capacity=128, gn_iters=6, cg_iters=32, loop_noise_scale=0.01,
            odometry_sigmas=(0.005,) * 3 + (0.05,) * 3,
        ),
        scan_context=mod.ScanContextParams(
            exclude_recent=10, num_candidates=6, distance_threshold=0.25,
        ),
    )


def _rot(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K


@pytest.fixture(scope="module")
def workload():
    world = kitti.SyntheticWorld(seed=3, extent=120.0, n_clusters=80, pts_per_cluster=800)
    gt = kitti.loop_trajectory(n_frames=N_FRAMES, radius=25.0, laps=1.6)
    rng = np.random.RandomState(5)
    odom = [gt[0]]
    for k in range(1, N_FRAMES):
        drift = np.eye(4)
        drift[:3, :3] = _rot(rng.normal(0, 0.005, 3))
        drift[:3, 3] = rng.normal(0, 0.05, 3)
        odom.append(odom[-1] @ np.linalg.inv(gt[k - 1]) @ gt[k] @ drift)
    scans = [world.scan_at(gt[k], max_points=4096, seed=k) for k in range(N_FRAMES)]
    return gt, np.asarray(odom, np.float32), scans


def _drive(m, pose_of, odom, scans):
    """The live loop on the sensor clock; returns (keyframe frames, loop
    result per keyframe, frames where the solve ran, final chi2)."""
    kfs, loops, solved = [], [], []
    for k in range(N_FRAMES):
        if m.add_frame(pose_of(odom[k]), scans[k], stamp=0.1 * k) is not None:
            info = m.spin_once(now=0.1 * k)
            kfs.append(k)
            loops.append(info["loop"])
            if "chi2" in info:
                solved.append(k)
    return kfs, loops, solved, m.optimize()


@pytest.fixture(scope="module")
def jax_live(workload):
    _, odom, scans = workload
    m = JM.Mapper(_cfg(jconfig))
    out = _drive(m, lambda T: jse3.Pose(jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3])), odom, scans)
    st = m.state
    return out, {
        "traj": m.trajectory(),
        "num_edges": int(st.graph.num_edges),
        "i": np.asarray(st.graph.i), "j": np.asarray(st.graph.j),
        "sqrt_info": np.asarray(st.graph.sqrt_info),
        "loop_target": np.asarray(st.loop_target),
        "queue_count": int(st.loop_queue.count),
    }


def test_live_mapper_matches_jax(workload, jax_live):
    gt, odom, scans = workload
    (kfs_r, loops_r, solved_r, _), ref = jax_live
    m = M.Mapper(_cfg(tconfig), "cpu")
    kfs, loops, solved, chi2 = _drive(m, lambda T: se3.Pose(T[:3, :3], T[:3, 3]), odom, scans)

    assert kfs == kfs_r
    assert [x is None for x in loops] == [x is None for x in loops_r]
    assert sum(x is not None for x in loops) >= 10, "the workload closed too few loops"
    for x, y in zip(loops, loops_r):
        if x is not None:
            assert x["matched_index"] == y["matched_index"]
            np.testing.assert_allclose(x["fitness"], y["fitness"], rtol=2e-2)
            np.testing.assert_allclose(x["yaw"], y["yaw"], atol=1e-6)
    assert solved == solved_r and len(solved) >= 2
    assert m.icp_attempts >= sum(x is not None for x in loops)

    st = m.state
    n = ref["num_edges"]
    assert int(st.graph.num_edges) == n and int(st.loop_queue.count) == ref["queue_count"] == 0
    np.testing.assert_array_equal(st.graph.i.numpy()[:n], ref["i"][:n])
    np.testing.assert_array_equal(st.graph.j.numpy()[:n], ref["j"][:n])
    np.testing.assert_allclose(st.graph.sqrt_info.numpy()[:n], ref["sqrt_info"][:n], rtol=2e-2)
    np.testing.assert_array_equal(st.loop_target.numpy(), ref["loop_target"])
    assert not bool(st.loop_closed) and chi2.shape == (7,)

    traj = m.trajectory()
    s, R, t = tio.umeyama_align(traj[:, :3, 3], ref["traj"][:, :3, 3])
    aligned = (R @ traj[:, :3, 3].T).T + t
    np.testing.assert_allclose(aligned, ref["traj"][:, :3, 3], rtol=0, atol=5e-3)
    ate = tio.ate_rmse(traj, gt[kfs])
    np.testing.assert_allclose(ate, tio.ate_rmse(ref["traj"], gt[kfs]), atol=1e-3)
    assert ate < 0.5 * tio.ate_rmse(odom[kfs].astype(np.float64), gt[kfs])

    poses, stamps = m.trajectory_with_stamps()
    np.testing.assert_allclose(stamps, 0.1 * np.asarray(kfs), rtol=1e-6)
    full, full_stamps = m.full_trajectory()
    np.testing.assert_array_equal(full, poses)
    np.testing.assert_array_equal(m.keyframe_stamps(), stamps)


def test_single_frame_ingest_matches_jax(workload):
    """``_ingest`` alone: the first frame takes the prior, the next ones
    chain odometry factors; state rows against JAX's ``_ingest``."""
    _, odom, scans = workload
    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    jst = JM.make_state(jcfg)
    tst = M.make_state(tcfg, "cpu")
    cap = tcfg.keyframe.raw_points_capacity
    for k in range(3):
        jc = jpc.from_points(jnp.asarray(scans[k]), cap)
        pose = jse3.Pose(jnp.asarray(odom[k][:3, :3]), jnp.asarray(odom[k][:3, 3]))
        jst, jwire = JM._ingest(jst, jnp.array(0), pose, jc.xyz, jc.mask, jnp.float32(0.1 * k), jcfg)
        tst, twire = M._ingest(
            tst, 0, se3.Pose(torch.from_numpy(odom[k][:3, :3]), torch.from_numpy(odom[k][:3, 3])),
            torch.from_numpy(np.array(jc.xyz)), torch.from_numpy(np.array(jc.mask)),
            torch.tensor(0.1 * k, dtype=torch.float32), tcfg,
        )
        np.testing.assert_allclose(twire.numpy(), np.asarray(jwire), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tst.kf_xyz.numpy(), np.asarray(jst.kf_xyz))
    np.testing.assert_array_equal(tst.kf_mask.numpy(), np.asarray(jst.kf_mask))
    for name in ("i", "j", "num_edges", "prior_idx", "num_priors"):
        np.testing.assert_array_equal(getattr(tst.graph, name).numpy(), np.asarray(getattr(jst.graph, name)))
    np.testing.assert_allclose(tst.graph.z.t.numpy(), np.asarray(jst.graph.z.t), atol=1e-5)
    np.testing.assert_allclose(tst.opt_t.numpy(), np.asarray(jst.opt_t), atol=1e-5)
    np.testing.assert_allclose(tst.opt_R.numpy(), np.asarray(jst.opt_R), atol=1e-6)
    np.testing.assert_array_equal(tst.desc_db.index.numpy(), np.asarray(jst.desc_db.index))
    np.testing.assert_allclose(tst.stamps.numpy(), np.asarray(jst.stamps))


def test_runner_on_cpu(tmp_path, capsys):
    """``python -m scl_slam_tpu_torch.run --device cpu`` with a handful of
    frames (a live run, then a batched one), its report, exports and run
    figure; ``--loader native`` without ``--dataset kitti`` exits 2 with a
    reason."""
    out = str(tmp_path / "run")
    assert trun.main(["--device", "cpu", "--frames", "12", "--output", out]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == report["keyframes"] == 12 and report["device"] == "cpu"
    assert report["loops_closed"] == 0  # inside the demo's exclusion window
    for key in ("ate_rmse_m", "ate_rmse_odom_only_m", "wall_s"):
        assert np.isfinite(report[key])
    assert sorted(os.listdir(out)) == ["a_kitti.txt", "a_tum.txt", "trajectory.png"]
    assert report["figure"] == os.path.join(out, "trajectory.png")
    out2 = str(tmp_path / "run_batched")
    assert trun.main(["--device", "cpu", "--frames", "10", "--batch", "4", "--no-figure",
                      "--output", out2]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["batch"] == 4 and "figure" not in report
    assert sorted(os.listdir(out2)) == ["a_kitti.txt", "a_tum.txt"]
    assert trun.main(["--device", "cpu", "--loader", "native"]) == 2
    assert "requires --dataset kitti" in capsys.readouterr().err


def test_mapper_defaults_to_cuda():
    cfg = _cfg(tconfig)
    if torch.cuda.is_available():
        assert M.Mapper(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            M.Mapper(cfg)
    assert M.Mapper(cfg, "cpu").device.type == "cpu"
    # PCM is ported: a drain with use_pcm runs (an empty queue adds nothing)
    pcm_cfg = tconfig.SlamConfig(optimizer=tconfig.OptimizerConfig(use_pcm=True))
    _, n_new, queue = M._drain_queue(M.make_state(pcm_cfg, "cpu"), pcm_cfg)
    assert int(n_new) == 0 and int(queue.count) == 0


def test_kitti_config_in_code_equals_yaml():
    """The KITTI Velodyne configuration ``chip_smoke.py`` builds in code
    (the card machine may lack PyYAML) equals the shipped YAML, field for
    field, in both packages."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    path = os.path.join(ROOT, "configs", "kitti_velodyne.yaml")
    built = smoke.kitti_velodyne_cfg()
    assert built == tconfig.load_config(path)
    ref = jconfig.load_config(path)

    def plain(c):
        return json.loads(json.dumps(dataclasses.asdict(c), default=str))

    assert plain(built) == plain(ref)
    assert built.keyframe.raw_points_capacity == 131072
    assert built.loop.submap_capacity == 16384 and built.loop.icp_source_points == 1024
