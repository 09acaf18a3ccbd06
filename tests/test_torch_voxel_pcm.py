"""The voxel storage modes and PCM outlier rejection of the PyTorch port
against the JAX package, on the same numpy inputs.

Stated tolerances, with their reasons:
- ``voxel_downsample_hash``: the same occupied slots (exact integer
  arithmetic) and the same representatives; the 15-bit quantization of a
  point's distance to its voxel's center could round one step apart
  between the libraries' f32 sums and pick another point of the voxel:
  none did on these scans (``MOVED_REPS``);
- the consistency matrix within 1e-4 relative or 1e-5 absolute, ``inf``
  in the same places: the SE(3) log of a four-pose cycle over poses up to
  26 m apart carries ~1e-6 of f32 rounding, 2e-7 in a squared error of
  1e-3 (1.7e-4 relative), against gates of threshold^2 >= 0.25; clique
  masks and the drain's edges, counts and queue equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import scl_slam_tpu.config as jcfg
from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.geometry import so3 as jso3
from scl_slam_tpu.graph import pcm as jpcm
from scl_slam_tpu.ops import pointcloud as jpc
from scl_slam_tpu.runtime import mapper as JM
from scl_slam_tpu.runtime.state import make_state as jmake_state
import scl_slam_tpu_torch.config as tcfg
from scl_slam_tpu_torch import run_multi
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.graph import pcm
from scl_slam_tpu_torch.io import lidar_sim as sim
from scl_slam_tpu_torch.ops import pointcloud as pc
from scl_slam_tpu_torch.runtime import mapper as M
from scl_slam_tpu_torch.runtime.state import state_from_numpy, state_to_numpy
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)

# representatives that may differ from JAX's by the distance quantization
MOVED_REPS = 0


@pytest.fixture(scope="module")
def dense_scan():
    """A 1,024-azimuth urban-proxy scan (~60,000 points)."""
    scene = sim.UrbanScene(seed=7, blocks=1, block_size=40.0)
    return sim.LidarSim(scene, n_azimuth=1024, device="cpu").scan_at(scene.circuit()[20], seed=1)


def _both_clouds(scan, capacity):
    c = pc.from_points(torch.from_numpy(scan), capacity)
    return c, jpc.Cloud(jnp.asarray(c.xyz.numpy()), jnp.asarray(c.mask.numpy()))


@pytest.mark.parametrize("capacity, out_capacity, path", [
    (65536, 2048, "pre-decimated"),
    (40000, 16384, "every point"),
    (131072, 4096, "exact fallback"),
])
def test_voxel_downsample_hash_matches_jax(dense_scan, capacity, out_capacity, path):
    c, jc = _both_clouds(dense_scan, capacity)
    got = pc.voxel_downsample_hash(c, 0.2, out_capacity)
    ref = jpc.voxel_downsample_hash(jc, 0.2, out_capacity)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert int(got.mask.sum()) > out_capacity // 2
    moved = (got.xyz.numpy() != np.asarray(ref.xyz)).any(-1)
    assert int(moved.sum()) <= MOVED_REPS, path


def _storage_cfgs(**kw):
    k = dict(max_keyframes=8, points_per_keyframe=2048, raw_points_capacity=65536,
             descript_leaf_size=0.3, **kw)
    return tcfg.SlamConfig(keyframe=tcfg.KeyframeConfig(**k)), jcfg.SlamConfig(
        keyframe=jcfg.KeyframeConfig(**k))


@pytest.mark.parametrize("kw", [
    dict(storage_downsample="stride"), dict(storage_downsample="voxel_hash"),
    dict(storage_downsample="voxel"), dict(storage_downsample="stride", fast_voxel=False),
])
def test_prepare_cloud_per_mode(dense_scan, kw):
    """The mapper's storage dispatch on a batch of two frames (the second
    shifted) against JAX's per frame."""
    tc, jc = _storage_cfgs(**kw)
    c, _ = _both_clouds(dense_scan, 65536)
    xyz = torch.stack([c.xyz, torch.where(c.mask[:, None], c.xyz + 3.0, c.xyz)])
    got = M._prepare_cloud(pc.Cloud(xyz, torch.stack([c.mask, c.mask])), tc)
    assert got.xyz.shape == (2, 2048, 3)
    for b in range(2):
        ref = JM._prepare_cloud(jpc.Cloud(jnp.asarray(xyz[b].numpy()), jnp.asarray(c.mask.numpy())), jc)
        np.testing.assert_array_equal(got.mask[b].numpy(), np.asarray(ref.mask))
        np.testing.assert_array_equal(got.xyz[b].numpy(), np.asarray(ref.xyz))


def _loops(n_good=6, n_bad=3, seed=0):
    """tests/test_pcm.py's loops from a numpy seed: robot a's poses along
    x, robot b's the same places in a frame offset by T_ab; the last
    ``n_bad`` measurements are gross outliers. Returns numpy (R, t) pairs."""
    rng = np.random.RandomState(seed)
    T_ab = jse3.Pose(jso3.exp(jnp.array([0.0, 0.0, 0.4])), jnp.array([5.0, -2.0, 0.0]))
    ai, bj, z = [], [], []
    for k in range(n_good + n_bad):
        a = jse3.Pose(jso3.exp(jnp.array([0, 0, 0.1 * k], jnp.float32)), jnp.array([2.0 * k, 0, 0]))
        b = jse3.compose(T_ab, a)
        sig = np.float32([0.01] * 6) if k < n_good else np.float32([0.5] * 3 + [8.0] * 3)
        noise = jse3.exp(jnp.asarray(rng.normal(size=6).astype(np.float32) * sig))
        ai.append(a), bj.append(b), z.append(jse3.compose(jse3.between(a, b), noise))
    return [tuple(np.stack([np.asarray(getattr(p, f)) for p in ps]) for f in ("R", "t"))
            for ps in (ai, bj, z)]


def _poses(arrs, lib):
    if lib == "jax":
        return [jse3.Pose(jnp.asarray(R), jnp.asarray(t)) for R, t in arrs]
    return [se3.Pose(torch.from_numpy(R), torch.from_numpy(t)) for R, t in arrs]


def test_consistency_matrix_and_filter_match_jax():
    arrs = _loops(n_good=10, n_bad=4)
    M_ = 14
    valid = np.ones(M_, bool)
    valid[[3, 11]] = False
    ref = np.asarray(jpcm.consistency_matrix(*_poses(arrs, "jax"), jnp.asarray(valid)))
    got = pcm.consistency_matrix(*_poses(arrs, "torch"), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    assert fin.sum() == 12 * 12
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4, atol=1e-5)
    for thr in (0.5, 0.75):
        acc = pcm.pcm_filter(*_poses(arrs, "torch"), torch.from_numpy(valid), threshold=thr)
        jacc = jpcm.pcm_filter(*_poses(arrs, "jax"), jnp.asarray(valid), threshold=thr)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    assert acc.numpy()[[0, 1, 2, 4]].all() and not acc.numpy()[[3, 11, 12, 13]].any()


@pytest.mark.parametrize("seed", range(6))
def test_greedy_max_clique_matches_jax(seed):
    """Random symmetric graphs, and (odd seeds) disjoint cliques of equal
    size, where every step's degree ties and the first maximum must win."""
    rng = np.random.RandomState(seed)
    n = [5, 17, 40, 64, 70, 96][seed]
    if seed % 2:
        labels = rng.permutation(np.arange(n) % 4)
        adj = labels[:, None] == labels[None, :]
    else:
        adj = rng.rand(n, n) < 0.35
        adj = adj | adj.T
    got = pcm.greedy_max_clique(torch.from_numpy(adj)).numpy()
    ref = np.asarray(jpcm.greedy_max_clique(jnp.asarray(adj)))
    np.testing.assert_array_equal(got, ref)
    members = np.nonzero(got)[0]
    assert len(members) >= 1 and adj[np.ix_(members, members)][~np.eye(len(members), dtype=bool)].all()


def _drain_cfgs(use_pcm):
    """tests/test_pcm_drain.py's configuration in both packages."""
    def build(m):
        return m.SlamConfig(
            keyframe=m.KeyframeConfig(max_keyframes=16, points_per_keyframe=512,
                                      raw_points_capacity=1024),
            loop=m.LoopConfig(near_keyframes=2, submap_capacity=1024, queue_capacity=16),
            optimizer=m.OptimizerConfig(edge_capacity=64, gn_iters=3, cg_iters=16,
                                        use_pcm=use_pcm, pcm_threshold=0.5),
            scan_context=m.ScanContextParams(exclude_recent=2),
        )
    return build(tcfg), build(jcfg)


def _queued_jax_state(cfg):
    """tests/test_pcm_drain.py's state: 12 keyframes 2 m apart, four
    consistent loops, one wildly inconsistent one, and one to a keyframe
    not ingested yet (deferred)."""
    state = jmake_state(cfg)
    rng = np.random.RandomState(0)
    for k in range(12):
        xyz = jnp.asarray(rng.uniform(-20, 20, (512, 3)), jnp.float32)
        pose = jse3.Pose(jnp.eye(3), jnp.array([2.0 * k, 0.0, 0.0]))
        state, _ = JM._ingest(state, jnp.array(0), pose, xyz, jnp.ones(512, bool),
                              jnp.array(0.0, jnp.float32), cfg)
    noise = jnp.array(0.05, jnp.float32)
    for i, j in [(0, 8), (1, 9), (2, 10), (3, 11)]:
        z = jse3.Pose(jnp.eye(3), jnp.array([2.0 * (j - i), 0.0, 0.0]))
        state = JM._queue_loop(state, jnp.array(i), jnp.array(j), z, noise, cfg)
    bad = jse3.Pose(jso3.from_euler(jnp.array([0.0, 0.0, 2.0])), jnp.array([-15.0, 9.0, 2.0]))
    state = JM._queue_loop(state, jnp.array(4), jnp.array(7), bad, noise, cfg)
    ahead = jse3.Pose(jnp.eye(3), jnp.array([30.0, 0.0, 0.0]))
    return JM._queue_loop(state, jnp.array(5), jnp.array(20), ahead, noise, cfg)


@pytest.mark.parametrize("use_pcm", [True, False])
def test_drain_with_pcm_matches_jax(use_pcm):
    tc, jc = _drain_cfgs(use_pcm)
    jstate = _queued_jax_state(jc)
    assert int(jstate.loop_queue.count) == 6
    graph, n_new, queue = M._drain_queue(state_from_numpy(state_to_numpy(jstate), "cpu"), tc)
    jgraph, jn_new, jqueue = JM._drain_queue(jstate, jc)
    assert int(n_new) == int(jn_new) == (4 if use_pcm else 5)
    got, ref = state_to_numpy(graph), state_to_numpy(jgraph)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6, err_msg=k)
    assert int(queue.count) == int(jqueue.count) == 1  # only the deferred loop stays
    got, ref = state_to_numpy(queue), state_to_numpy(jqueue)
    for k in ("i", "j", "z_R", "z_t", "noise"):
        np.testing.assert_array_equal(got[k][:1], ref[k][:1])

    # through the drain and solve: the outlier never reaches the graph
    state = state_from_numpy(state_to_numpy(jstate), "cpu")
    before = int(state.graph.num_edges)
    state, chi2, broken = M._drain_queue_and_optimize(state, tc)
    assert int(state.graph.num_edges) - before == (4 if use_pcm else 5)
    assert np.isfinite(chi2.numpy()).all() and broken.tolist() == [0, 0]


@pytest.mark.parametrize("broken", ["warm", "both", "measurement"])
def test_drain_never_takes_a_broken_solve(broken, monkeypatch):
    """A start whose solve ends non-finite (a Cholesky or PCG breakdown,
    seen as a NaN trajectory on the card) never replaces the estimate: the
    finite start wins, or the estimate from before the drain stays. The
    Mapper counts the drain and names where each broken start broke down:
    a start broken from outside the solver (``warm``, ``both``) is flagged
    by no step; a NaN loop measurement breaks both starts in the linear
    system of the first Gauss-Newton step."""
    tc, jc = _drain_cfgs(False)
    m = M.Mapper(tc, device="cpu")
    m.state = state_from_numpy(state_to_numpy(_queued_jax_state(jc)), "cpu")
    if broken == "measurement":
        q = m.state.loop_queue
        m.state = m.state._replace(loop_queue=q._replace(z_t=q.z_t.clone().index_fill_(
            0, torch.tensor([0]), float("nan"))))
    R0, t0 = m.state.opt_R.clone(), m.state.opt_t.clone()
    solve, calls = M.solver.solve, []

    def breaking(*a, **k):
        r = solve(*a, **k)
        calls.append(r)
        if broken == "both" or (broken == "warm" and len(calls) == 1):  # warm runs first
            r = r._replace(poses=se3.Pose(r.poses.R, torch.full_like(r.poses.t, float("nan"))))
        return r

    monkeypatch.setattr(M.solver, "solve", breaking)
    chi2 = m.optimize()
    assert len(calls) == 2 and m.broken_drains == 1
    if broken == "warm":
        assert torch.equal(m.state.opt_t, calls[1].poses.t) and np.isfinite(chi2).all()
        assert m.solve_breakdowns == ["warm: no step flagged"]
    else:
        assert torch.equal(m.state.opt_R, R0) and torch.equal(m.state.opt_t, t0)
    if broken == "both":
        assert m.solve_breakdowns == ["warm: no step flagged", "chordal: no step flagged"]
    if broken == "measurement":
        assert [int(r.breakdown) for r in calls] != [0, 0]
        assert all(s.split(": ", 1)[1].startswith("GN step 0: linear system")
                   for s in m.solve_breakdowns) and len(m.solve_breakdowns) == 2


CITYSCALE_SMALL = """\
# configs/four_robot_cityscale.yaml's loop and optimizer settings at
# small widths
number_of_robots: 4
descriptor_type: scan_context
keyframe:
  distance_threshold: 1.0
  max_keyframes: 64
  points_per_keyframe: 1024
  raw_points_capacity: 4096
loop:
  history_fitness_score: 0.3
  near_keyframes: 25
  submap_capacity: 2048
  ransac_inlier_ratio: 0.45
  icp_iterations: 10
optimizer:
  gn_iters: 8
  cg_iters: 96
  coarse_stride: 32
  edge_capacity: 512
  use_pcm: true
  pcm_threshold: 0.75
scan_context:
  num_rings: 20
  num_sectors: 60
  exclude_recent: 100
  distance_threshold: 0.14
"""


def test_run_multi_cityscale_settings_on_cpu(tmp_path, capsys):
    import json

    path = tmp_path / "cityscale_small.yaml"
    path.write_text(CITYSCALE_SMALL)
    cfg = tcfg.load_config(str(path))
    ref = tcfg.load_config("configs/four_robot_cityscale.yaml")
    for a, b in ((cfg.loop, ref.loop), (cfg.optimizer, ref.optimizer)):
        for f in ("history_fitness_score", "near_keyframes", "ransac_inlier_ratio", "gn_iters",
                  "cg_iters", "coarse_stride", "use_pcm", "pcm_threshold"):
            if hasattr(a, f):
                assert getattr(a, f) == getattr(b, f), f
    assert cfg.scan_context == ref.scan_context
    rc = run_multi.main(["--robots", "4", "--frames", "48", "--device", "cpu", "--config",
                         str(path), "--output", str(tmp_path / "out")])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["robots"] == 4 and set(rep["ate_rmse_m"]) == {"a", "b", "c", "d"}
    assert all(np.isfinite(v) for v in rep["ate_rmse_m"].values())
