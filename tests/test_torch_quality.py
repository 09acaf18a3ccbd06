"""The port's quality anchor (``scl_slam_tpu_torch/bench_quality.py``)
against the JAX package's session (``scripts/bench_quality.py``, whose
helpers are rebuilt here from the JAX package: importing the script would
point JAX's compilation cache at a shared directory).

Stated tolerances: the lap poses and the configuration equal; the drifted
odometry within 1e-4 m over a lap (f32 exp and compose of the two
libraries). The session prefix crosses a revisit at the anchor's storage
widths (8,192 / 16,384 points: at the quick widths no loop passes the 0.3
fitness gate) on a cut of the anchor's frames, to fit the file's time: 16
frames of the first lap and 4 of the second, 512-azimuth scans, a raw
capacity of 32,768 (a scan's ~30,000 points whole) and a 4-frame
exclusion window instead of 100 (so the second lap's frames may match the
first's). Held: every frame's Scan Context candidate exactly (the
descriptors within 1e-4: f32 atan2 and sums), the loop decisions of every
attempted frame, the factor graph's endpoints, and the trajectories
within 1e-4 m; the ICP fitness of lanes more than 10% from the gate within
5e-2 relative. The loops' ICP does not converge in its 30 iterations (no
lane meets tol 1e-4), so its final fitness depends on the path it took,
and JAX's CPU path ranks neighbours by the expanded form where the port
ranks by the exact distance (tests/test_torch_registration.py): 3.8% apart
on this prefix's rejected lane (0.371 against 0.357), up to 9% on other
prefixes of the anchor (0.276 against 0.301 on one lane, identical
inputs), which can flip a decision near the gate.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import scl_slam_tpu.config as jcfg
from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.io import lidar_sim as J
from scl_slam_tpu.runtime import Mapper as JMapper
from scl_slam_tpu.runtime import mapper as JM
from scl_slam_tpu_torch import bench_quality as bq
from scl_slam_tpu_torch.io import lidar_sim as T
from scl_slam_tpu_torch.runtime import mapper as M
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)


def _jax_build_gt(scene, laps):
    gt = []
    for offset in laps:
        gt += scene.circuit(lane_offset=offset, step=1.0)
    return gt


def _jax_drift_odometry(gt, seed=3, rot_sigma=0.002, trans_sigma=0.02):
    """scripts/bench_quality.py::drift_odometry on the JAX package's se3."""
    rng = np.random.RandomState(seed)
    odom = [jse3.Pose(jnp.asarray(gt[0][:3, :3], jnp.float32),
                      jnp.asarray(gt[0][:3, 3], jnp.float32))]
    for k in range(1, len(gt)):
        inc_np = np.linalg.inv(gt[k - 1]) @ gt[k]
        noise = jse3.exp(jnp.asarray(
            np.concatenate([rng.randn(3) * rot_sigma, rng.randn(3) * trans_sigma]), jnp.float32))
        inc = jse3.Pose(jnp.asarray(inc_np[:3, :3], jnp.float32),
                        jnp.asarray(inc_np[:3, 3], jnp.float32))
        odom.append(jse3.compose(odom[-1], jse3.compose(inc, noise)))
    return odom


def _jax_quality_config(quick):
    """scripts/bench_quality.py's SlamConfig (max_keyframes at its default
    1,024, capped at 256 in quick mode)."""
    return jcfg.SlamConfig(
        keyframe=jcfg.KeyframeConfig(
            max_keyframes=256 if quick else 1024,
            points_per_keyframe=2048 if quick else 8192,
            raw_points_capacity=65536 if quick else 131072,
            distance_threshold=1.0, angle_threshold=0.2,
        ),
        loop=jcfg.LoopConfig(
            near_keyframes=6, submap_capacity=4096 if quick else 16384,
            history_fitness_score=0.3, icp_iterations=30, icp_max_corr_dist=10.0,
        ),
        optimizer=jcfg.OptimizerConfig(edge_capacity=2048, gn_iters=5, cg_iters=32),
        scan_context=jcfg.ScanContextParams(lidar_height=J.SENSOR_HEIGHT),
    )


def test_build_gt_and_config_equal():
    jgt = _jax_build_gt(J.UrbanScene(seed=7, blocks=1, block_size=40.0), bq.LAPS)
    gt = bq.build_gt(T.UrbanScene(seed=7, blocks=1, block_size=40.0), bq.LAPS)
    assert len(gt) == 1224
    np.testing.assert_array_equal(np.stack(gt), np.stack(jgt))
    for quick in (False, True):
        assert dataclasses.asdict(bq.quality_config(quick)) == dataclasses.asdict(
            _jax_quality_config(quick))


def test_drift_odometry_agrees_over_a_lap():
    gt = bq.build_gt(T.UrbanScene(seed=7, blocks=1, block_size=40.0), bq.LAPS[:1])
    got = bq.drift_odometry(gt)
    ref = _jax_drift_odometry(gt)
    assert len(got) == len(ref) == 216
    np.testing.assert_allclose(np.stack([p.t.numpy() for p in got]),
                               np.stack([np.asarray(p.t) for p in ref]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.stack([p.R.numpy() for p in got]),
                               np.stack([np.asarray(p.R) for p in ref]), rtol=0, atol=1e-5)


def test_session_prefix_matches_jax(monkeypatch):
    """A session that crosses a revisit, through the port's run_session and
    JAX's Mapper.replay on the same numpy scans: 16 frames of the first lap
    (76-91), then 4 frames of the second past its first revisit (292-295),
    4-frame chunks with a drain after each. Every frame's loop candidate,
    the 3 loops closed and the trajectories are held (see the module
    note)."""
    scene = T.UrbanScene(seed=7, blocks=1, block_size=40.0)
    sim = T.LidarSim(scene, n_azimuth=512, device="cpu")
    laps = bq.build_gt(scene, bq.LAPS[:2])
    frames = list(range(76, 92)) + list(range(292, 296))
    gt = [laps[k] for k in frames]
    n = len(gt)
    odom = bq.drift_odometry(gt)
    scans = [sim.scan_at(gt[k], seed=frames[k]) for k in range(n)]
    assert max(len(s) for s in scans) <= 32768

    def narrow(c):
        return dataclasses.replace(
            c, keyframe=dataclasses.replace(c.keyframe, raw_points_capacity=32768,
                                            points_per_keyframe=8192),
            loop=dataclasses.replace(c.loop, submap_capacity=16384),
            scan_context=dataclasses.replace(c.scan_context, exclude_recent=4))

    per_frame = {"port": [], "jax": []}

    def keep(name, fn, host):
        def call(*a, **k):
            out = fn(*a, **k)
            per_frame[name].append([host(x) for x in out[1:]])
            return out
        return call

    monkeypatch.setattr(M, "_replay_batches",
                        keep("port", M._replay_batches, lambda x: x.numpy()))
    monkeypatch.setattr(JM, "_replay_batches",
                        keep("jax", JM._replay_batches, np.asarray))
    rec, m, loops = bq.run_session(narrow(bq.quality_config(True)), gt, odom, lambda k: scans[k],
                                   "cpu", 4, 1, n_frames=n)
    jm = JMapper(narrow(_jax_quality_config(True)))
    jloops = []
    for pos in range(0, n, 4):
        idx = range(pos, pos + 4)
        out = jm.replay(
            [jse3.Pose(jnp.asarray(odom[k].R.numpy()), jnp.asarray(odom[k].t.numpy())) for k in idx],
            [scans[k] for k in idx], stamps=[1.0 * k for k in idx],
            apply_gate=False, batch=4, chunk_batches=1,
        )
        jloops += out["loops"]
        jm.optimize()
    (ok, idx, fit), (jok, jidx, jfit) = (
        [np.concatenate([f[i] for f in per_frame[name]]) for i in range(3)]
        for name in ("port", "jax"))
    # every frame's candidate: the descriptors are equal, so exactly
    np.testing.assert_array_equal(idx, jidx)
    attempted = idx >= 0
    assert attempted.sum() == 4 and not attempted[:16].any()
    # the decisions, and the fitness of the lanes away from the gate
    np.testing.assert_array_equal(ok, jok)
    assert [x is not None for x in loops] == [x is not None for x in jloops] == list(ok)
    assert [x["matched_index"] for x in loops if x] == [x["matched_index"] for x in jloops if x]
    assert ok.sum() >= 3
    gate = bq.quality_config(True).loop.history_fitness_score
    clear = attempted & (np.abs(fit - gate) > 0.1 * gate) & (np.abs(jfit - gate) > 0.1 * gate)
    assert clear.sum() >= attempted.sum() - 1
    np.testing.assert_allclose(fit[clear], jfit[clear], rtol=5e-2, atol=0)
    assert rec["keyframes"] == jm._keyframes == n and rec["evicted"] == 0
    np.testing.assert_allclose(m.state.desc_db.descriptors[:n].numpy(),
                               np.asarray(jm.state.desc_db.descriptors[:n]), rtol=0, atol=1e-4)
    E = int(jm.state.graph.num_edges)
    assert int(m.state.graph.num_edges) == E
    np.testing.assert_array_equal(m.state.graph.i[:E].numpy(), np.asarray(jm.state.graph.i[:E]))
    np.testing.assert_array_equal(m.state.graph.j[:E].numpy(), np.asarray(jm.state.graph.j[:E]))
    est, stamps = m.full_trajectory()
    jest, jstamps = jm.full_trajectory()
    np.testing.assert_array_equal(stamps, jstamps)
    np.testing.assert_allclose(est, jest, rtol=0, atol=1e-4)


@pytest.mark.parametrize("value, ratio, rc", [
    (3.272, 0.9, 0), (3.2721, 0.5, 1), (2.0, 0.9001, 1), (2.6, 0.76, 0),
])
def test_gate_exits_1_above_each_bound(monkeypatch, capsys, value, ratio, rc):
    """main() gates on the golden file as it stands (ATE <= 3.272 m, ratio
    <= 0.9): exit 1 above either bound, with its JSON line printed."""
    def fake_session(cfg, gt, odom, scan, device, batch, chunk_batches, log=None):
        assert (len(gt), batch, chunk_batches, device) == (1224, 32, 6, "cpu")
        assert cfg.keyframe.max_keyframes == 1024
        return {"metric": "quality_ate_m", "value": value, "ratio": ratio}, None, []

    monkeypatch.setattr(bq, "run_session", fake_session)
    monkeypatch.setattr(bq, "drift_odometry", lambda gt: gt)
    assert bq.main(["--device", "cpu", "--azimuth", "16"]) == rc
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["golden_bound"] == 3.272 and line.get("regression", False) == bool(rc)
