"""The inter-robot path of the PyTorch port against the JAX package: kernel
K3's plain version, the RANSAC pieces, the mapper's inter-robot
transitions on a state handed over from JAX, the global map, and a whole
two-robot session over the in-process bus.

Stated tolerances, with their reasons:

- K3's d2 is bit-equal to a numpy evaluation of the contract; against the
  Pallas kernel in interpret mode it agrees to 2 ulp (XLA:CPU reorders the
  multiply-adds; see test_torch_kernels.py), the index equal wherever no
  other target lies within those 2 ulp.
- RANSAC cannot draw JAX's ``jax.random`` stream; with JAX's own samples
  injected and the same 1-NN on both sides (JAX's ``nearest_neighbors``
  patched to K3 in interpret mode) the success flag and inlier count are
  equal and the pose agrees to 1e-4 (SVD libraries). Inside the mapper
  JAX's CPU 1-NN is its expanded-form matmul, which can pick another
  neighbour at near-ties: the inlier ratio then agrees to 5e-3 and the
  factor to 5e-3 m / 5e-4 rad.
- RANSAC's own draws against JAX's pick other best hypotheses, so the
  inlier ratio of a verified pair differs by up to 5e-2 (measured 2.7e-2
  on the single pair here) and the factor by centimetres (one refine over
  the inliers of a 1 m threshold). In the whole session the retrieval
  hits and the verification decisions are held equal (no verification on
  this workload is borderline: every ratio is at least 0.25 above the 0.3
  gate), the joint trajectories after a rigid alignment to 6e-2 m
  (measured 3.2e-2 m) and robot b's ATE to 1e-2 m.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import scl_slam_tpu.config as jconfig
from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.ops import pallas_kernels as pk
from scl_slam_tpu.ops import pointcloud as jpc
from scl_slam_tpu.ops import registration as jreg
from scl_slam_tpu.runtime import mapper as JM
from scl_slam_tpu.runtime.transport import LocalBus as JLocalBus
from scl_slam_tpu_torch import config as tconfig
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.io import kitti
from scl_slam_tpu_torch.io import trajectory as tio
from scl_slam_tpu_torch.ops import kernels
from scl_slam_tpu_torch.ops import pointcloud as pc
from scl_slam_tpu_torch.ops import registration as reg
from scl_slam_tpu_torch.runtime import mapper as M
from scl_slam_tpu_torch.runtime.state import state_from_numpy, state_to_numpy
from scl_slam_tpu_torch.runtime.transport import LocalBus
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)


def nn_targets(seed, nq, nt):
    """K3 inputs: queries near random targets; every 4th target duplicated
    at the next index (the lower index must win), a quarter of the queries
    on an integer grid at unit distance from two distinct targets, ~5% of
    the targets padded at PAD_VALUE."""
    rng = np.random.RandomState(seed)
    t = rng.uniform(-30, 30, (nt, 3)).astype(np.float32)
    q = (t[rng.randint(0, nt, nq)] + rng.normal(0, 0.3, (nq, 3))).astype(np.float32)
    t[1::4] = t[0::4][: len(t[1::4])]
    n_grid = min(nq // 4, nt // 8)
    c = rng.randint(-7, 7, (n_grid, 3)).astype(np.float32) * 4.0
    q[:n_grid] = c
    hi = nt - 2 * n_grid
    t[hi : hi + n_grid] = c - np.float32([1, 0, 0])
    t[hi + n_grid :] = c + np.float32([0, 1, 0])
    pad = rng.rand(nt) < 0.05
    pad[hi:] = False
    t[pad] = pc.PAD_VALUE
    return q, t, n_grid


def _nn_contract_numpy(q, t):
    dx = q[:, None, 0] - t[None, :, 0]
    dy = q[:, None, 1] - t[None, :, 1]
    dz = q[:, None, 2] - t[None, :, 2]
    d2 = ((dx * dx) + (dy * dy)) + (dz * dz)
    idx = d2.argmin(-1)
    best = d2[np.arange(len(q)), idx]
    second = np.where(d2 == best[:, None], np.inf, d2).min(-1)
    return best, idx, second, (d2 == best[:, None]).sum(-1)


def test_k3_plain_matches_contract_and_pallas_interpret():
    q, t, n_grid = nn_targets(21, 256, 4096)
    d, idx = kernels.nearest_neighbors(torch.from_numpy(q), torch.from_numpy(t))
    d, idx = d.numpy(), idx.numpy()
    assert idx.dtype == np.int32
    d_np, idx_np, second, ties = _nn_contract_numpy(q, t)
    np.testing.assert_array_equal(d, d_np)
    np.testing.assert_array_equal(idx, idx_np)
    assert (ties > 1).sum() > 20, "too few exact ties planted"
    on_grid = d[:n_grid] == 1.0
    assert on_grid.sum() > 5
    np.testing.assert_array_equal(t[idx[:n_grid][on_grid], 0], q[:n_grid, 0][on_grid] - 1.0)
    assert not np.isin(idx, np.flatnonzero(t[:, 0] == pc.PAD_VALUE)).any()

    d_ref, idx_ref = pk.nearest_neighbors_pallas(jnp.asarray(q), jnp.asarray(t), interpret=True)
    d_ref, idx_ref = np.asarray(d_ref), np.asarray(idx_ref)
    np.testing.assert_allclose(d, d_ref, rtol=2.0**-22, atol=0)
    clear = (second > d_np * (1 + 2.0**-21)) | (d_np == 1.0)
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(idx[clear], idx_ref[clear])


def test_k3_plain_chunking_empty_and_masked_clouds():
    """Any chunk size gives the same bits; no target or a NaN query gives
    (inf, 0); an all-padded target gives the first pad (every distance
    ties), as the TPU kernel does."""
    q, t, _ = nn_targets(22, 100, 777)
    qt, tt = torch.from_numpy(q), torch.from_numpy(t)
    d_all, i_all = kernels.nearest_neighbors_plain(qt, tt, chunk=777)
    for chunk in (1, 64, 500):
        d, i = kernels.nearest_neighbors_plain(qt, tt, chunk=chunk)
        assert torch.equal(d, d_all) and torch.equal(i, i_all)
    qn = qt.clone()
    qn[5] = float("nan")
    d, i = kernels.nearest_neighbors(qn, tt)
    assert torch.isinf(d[5]) and i[5] == 0 and torch.equal(i[6:], i_all[6:])
    d, i = kernels.nearest_neighbors(qt, tt[:0])
    assert torch.isinf(d).all() and (i == 0).all() and i.dtype == torch.int32
    pads = torch.full((1024, 3), pc.PAD_VALUE)
    d, i = kernels.nearest_neighbors(qt, pads)
    d_ref, i_ref = pk.nearest_neighbors_pallas(
        jnp.asarray(np.pad(q, ((0, 156), (0, 0)))), jnp.asarray(pads.numpy()), interpret=True
    )
    assert (i == 0).all() and np.array_equal(np.asarray(i_ref)[:100], i.numpy())
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref)[:100], rtol=2.0**-22)


def test_rigid_from_triangles_and_triangles_ok_match_jax():
    rng = np.random.RandomState(3)
    p = rng.normal(0, 5, (64, 3, 3)).astype(np.float32)
    R = np.asarray(jse3.exp(jnp.asarray(rng.normal(0, 0.5, 6), jnp.float32)).R)
    q = (p @ R.T + np.float32([1.0, -2.0, 0.5])).astype(np.float32)
    q[11:] += rng.normal(0, 0.01, q[11:].shape).astype(np.float32)  # row 10 exact
    # degenerate triples: collinear, a repeated point, all three equal,
    # and a nearly collinear one (sine 1e-3, below the 1e-2 gate)
    p[0, 2] = p[0, 0] + 2.0 * (p[0, 1] - p[0, 0])
    p[1, 1] = p[1, 0]
    p[2, :] = p[2, 0]
    p[3, 2] = p[3, 0] + (p[3, 1] - p[3, 0]) * 3.0 + np.float32([1e-3, 0, 0]) * np.linalg.norm(p[3, 1] - p[3, 0])
    hyp = reg.rigid_from_triangles(torch.from_numpy(p), torch.from_numpy(q))
    ref = jreg.rigid_from_triangles(jnp.asarray(p), jnp.asarray(q))
    ok = reg.triangles_ok(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(ok, np.asarray(jreg.triangles_ok(jnp.asarray(p))))
    assert not ok[:4].any() and ok[4:].all()
    np.testing.assert_allclose(hyp.R.numpy()[ok], np.asarray(ref.R)[ok], atol=1e-5)
    np.testing.assert_allclose(hyp.t.numpy()[ok], np.asarray(ref.t)[ok], atol=1e-4)
    assert np.isfinite(hyp.R.numpy()).all()
    # a congruent triple maps exactly
    np.testing.assert_allclose(hyp.R.numpy()[10], R, atol=1e-5)


def test_ransac_samples_are_valid_distinct_and_device_free():
    valid = torch.from_numpy(np.random.RandomState(1).rand(500) > 0.3)
    s = reg.ransac_samples(valid, 64, 3, seed=2, attempt=0)
    assert s.shape == (64, 3)
    assert valid[s].all()
    assert all(len(set(row)) == 3 for row in s.tolist())
    assert torch.equal(s, reg.ransac_samples(valid, 64, 3, seed=2, attempt=0))
    assert not torch.equal(s, reg.ransac_samples(valid, 64, 3, seed=2, attempt=1))
    assert not torch.equal(s, reg.ransac_samples(valid, 64, 3, seed=3, attempt=0))
    # roughly uniform over the valid points
    counts = np.bincount(reg.ransac_samples(valid, 4096, 3, 5, 0).flatten().numpy(), minlength=500)
    assert counts[~valid.numpy()].sum() == 0
    assert counts[valid.numpy()].std() / counts[valid.numpy()].mean() < 0.3


# ---------------------------------------------------------------------------
# a small two-robot world
# ---------------------------------------------------------------------------


def _cfg(mod, rid=0, **loop):
    return mod.SlamConfig(
        number_of_robots=2, robot_id=rid, robot_name=chr(ord("a") + rid),
        keyframe=mod.KeyframeConfig(
            max_keyframes=16, points_per_keyframe=512, raw_points_capacity=4096,
            distance_threshold=2.0,
        ),
        loop=mod.LoopConfig(
            near_keyframes=2, submap_capacity=2048, ransac_max_iter=64,
            ransac_inlier_ratio=0.3, ransac_outlier_threshold=1.0, **loop,
        ),
        optimizer=mod.OptimizerConfig(edge_capacity=64),
        scan_context=mod.ScanContextParams(exclude_recent=10, num_candidates=6),
    )


@pytest.fixture(scope="module")
def world():
    w = kitti.SyntheticWorld(seed=5, extent=100.0, n_clusters=70, pts_per_cluster=800)
    gt = kitti.loop_trajectory(n_frames=80, radius=35.0, revisit=False).astype(np.float32)
    return w, gt


def _jpose(T):
    return jse3.Pose(jnp.asarray(T[:3, :3], jnp.float32), jnp.asarray(T[:3, 3], jnp.float32))


def _tpose(T):
    T = np.asarray(T, np.float32)
    return se3.Pose(torch.from_numpy(T[:3, :3].copy()), torch.from_numpy(T[:3, 3].copy()))


@pytest.fixture(scope="module")
def own_state(world):
    """A JAX state in which robot 0 holds six keyframes (frames 30-35)."""
    w, gt = world
    cfg = _cfg(jconfig)
    st = JM.make_state(cfg)
    for n, k in enumerate(range(30, 36)):
        c = jpc.from_points(jnp.asarray(w.scan_at(gt[k], max_points=4096, seed=k)), 4096)
        st, _ = JM._ingest(st, jnp.array(0), _jpose(gt[k]), c.xyz, c.mask, jnp.float32(0.1 * k), cfg)
    return st


def _peer_msgs(st, gt):
    """Two peer descriptors of robot 1 whose images are robot 0's frames 34
    and 35, at poses that drift from the ground truth."""
    drift = np.eye(4, dtype=np.float32)
    drift[:3, 3] = [0.3, -0.2, 0.05]
    imgs = np.array(st.desc_db.descriptors)
    return [
        (0, gt[34] @ drift, gt[34] @ drift, imgs[4].reshape(-1), 3.4),
        (1, gt[34] @ drift, gt[35] @ drift @ drift, imgs[5].reshape(-1), 3.5),
    ]


def _assert_states_close(tst, jst):
    t, j = state_to_numpy(tst), state_to_numpy(jst)
    assert t.keys() == j.keys()
    for k in t:
        if t[k].dtype.kind == "f":
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=2e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_peer_ingest_and_inter_detect_match_jax(world, own_state):
    _, gt = world
    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    jst = own_state
    tst = state_from_numpy(state_to_numpy(jst), "cpu")
    for index, pre, cur, wire, stamp in _peer_msgs(jst, gt):
        jst = JM._ingest_peer(
            jst, jnp.array(1), jnp.array(index), _jpose(pre), _jpose(cur),
            jnp.asarray(wire), jnp.float32(stamp), jcfg,
        )
        tst = M._ingest_peer(tst, 1, index, _tpose(pre), _tpose(cur), torch.from_numpy(wire), stamp, tcfg)
    _assert_states_close(tst, jst)
    assert int(tst.counts[1]) == 2 and int(tst.graph.num_priors) == 2  # robot 0's and the peer's

    jfound, jmatch, jxyz, jmask = JM._detect_inter(jst, jnp.array(0), jcfg)
    found, match, xyz, mask = M._detect_inter(tst, 0, tcfg)
    assert bool(found) == bool(jfound) is True
    assert (int(match.robot), int(match.index)) == (int(jmatch.robot), int(jmatch.index)) == (1, 1)
    np.testing.assert_allclose(float(match.distance), float(jmatch.distance), atol=1e-6)
    np.testing.assert_allclose(float(match.yaw), float(jmatch.yaw), atol=1e-6)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(xyz.numpy(), np.asarray(jxyz), rtol=0, atol=2e-4)


def _jax_samples(key, valid, H):
    """The indices JAX's gumbel top-k draws for ``key`` over ``valid``."""
    g = jax.random.gumbel(key, (H, valid.shape[0]))
    g = jnp.where(jnp.asarray(valid)[None, :], g, -jnp.inf)
    return torch.from_numpy(np.asarray(jax.lax.top_k(g, 3)[1]))


def _request(world, st, cfg, k=35):
    """A verification request: robot 0's keyframe of frame ``k`` in the map
    frame of an estimate 0.4 m and 0.02 rad off."""
    _, gt = world
    slot = k - 30
    P = cfg.keyframe.points_per_keyframe
    xyz = np.asarray(st.kf_xyz[slot]).reshape(P, 3)
    mask = np.array(st.kf_mask[slot])
    off = np.asarray(jse3.to_matrix(jse3.exp(jnp.asarray([0, 0, 0.02, 0.4, -0.1, 0.0], jnp.float32))))
    est = (gt[k] @ off).astype(np.float32)
    world_xyz = np.where(mask[:, None], xyz @ est[:3, :3].T + est[:3, 3], pc.PAD_VALUE).astype(np.float32)
    return world_xyz, mask, est


def test_ransac_align_matches_jax_with_injected_samples(world, own_state, monkeypatch):
    """The same samples and the same 1-NN (JAX's patched to K3 in interpret
    mode): success and inlier count equal, pose to 1e-4. Then an
    all-masked target: no valid correspondence, identity, ratio 0."""
    cfg = _cfg(tconfig)
    tst = state_from_numpy(state_to_numpy(own_state), "cpu")
    src_xyz, src_mask, _ = _request(world, own_state, cfg)
    _, submap, _ = M._verify_inputs(tst, 0, 3, cfg)
    src = pc.Cloud(torch.from_numpy(src_xyz), torch.from_numpy(src_mask))
    tgt = torch.where(submap.mask[:, None], submap.xyz, pc.PAD_VALUE)
    _, idx = reg.nearest_neighbors(src.xyz, tgt)
    valid = (src.mask & submap.mask[idx.long()]).numpy()
    key = jax.random.PRNGKey(7)
    samples = _jax_samples(key, valid, 64)

    monkeypatch.setattr(
        jreg, "nearest_neighbors",
        lambda q, t: pk.nearest_neighbors_pallas(q, t, interpret=True),
    )
    kw = dict(num_hypotheses=64, inlier_thresh=1.0, min_inlier_ratio=0.3)
    ref = jreg.ransac_align(
        jpc.Cloud(jnp.asarray(src_xyz), jnp.asarray(src_mask)),
        jpc.Cloud(jnp.asarray(submap.xyz.numpy()), jnp.asarray(submap.mask.numpy())), key, **kw,
    )
    res = reg.ransac_align(src, submap, seed=0, attempt=0, samples=samples, **kw)
    assert bool(res.success) == bool(ref.success) is True
    assert int(res.num_inliers) == int(ref.num_inliers)
    np.testing.assert_allclose(float(res.inlier_ratio), float(ref.inlier_ratio), rtol=1e-6)
    np.testing.assert_allclose(res.pose.R.numpy(), np.asarray(ref.pose.R), atol=1e-4)
    np.testing.assert_allclose(res.pose.t.numpy(), np.asarray(ref.pose.t), atol=1e-4)
    # its own draws verify this pair too
    own = reg.ransac_align(src, submap, seed=1, attempt=0, **kw)
    assert bool(own.success) and abs(float(own.inlier_ratio) - float(ref.inlier_ratio)) < 5e-2

    masked = pc.Cloud(submap.xyz, torch.zeros_like(submap.mask))
    res = reg.ransac_align(src, masked, seed=1, attempt=0, **kw)
    ref = jreg.ransac_align(
        jpc.Cloud(jnp.asarray(src_xyz), jnp.asarray(src_mask)),
        jpc.Cloud(jnp.asarray(submap.xyz.numpy()), jnp.zeros(2048, bool)), key, **kw,
    )
    assert not bool(res.success) and not bool(ref.success)
    assert float(res.inlier_ratio) == float(ref.inlier_ratio) == 0.0
    np.testing.assert_array_equal(res.pose.R.numpy(), np.eye(3, dtype=np.float32))


def test_verify_ransac_and_queue_loop_match_jax(world, own_state):
    """The server side on a state from JAX, with JAX's samples injected
    (JAX's own CPU 1-NN here: the stated 5e-3 tolerances), then the
    verified factor queued in both orders."""
    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    jst = own_state
    tst = state_from_numpy(state_to_numpy(jst), "cpu")
    xyz, mask, est = _request(world, jst, tcfg)
    key = jax.random.PRNGKey(11)
    jok, jz, jratio = JM._verify_ransac(
        jst, jnp.asarray(xyz), jnp.asarray(mask), _jpose(est), jnp.array(0), jnp.array(3), key, jcfg,
    )
    inputs = M._verify_inputs(tst, 0, 3, tcfg)
    src = torch.from_numpy(xyz)
    tgt = torch.where(inputs[1].mask[:, None], inputs[1].xyz, pc.PAD_VALUE)
    _, idx = reg.nearest_neighbors(src, tgt)
    valid = (torch.from_numpy(mask) & inputs[1].mask[idx.long()]).numpy()
    ok, z, ratio = M._verify_ransac(
        tst, src, torch.from_numpy(mask), _tpose(est), 0, 3, tcfg, seed=0, attempt=0,
        samples=_jax_samples(key, valid, 64),
    )
    assert bool(ok) == bool(jok) is True
    np.testing.assert_allclose(float(ratio), float(jratio), atol=5e-3)
    np.testing.assert_allclose(z.t.numpy(), np.asarray(jz.t), atol=5e-3)
    np.testing.assert_allclose(z.R.numpy(), np.asarray(jz.R), atol=5e-4)
    # the factor it found is the ground truth's between pose 33 -> 35, to
    # what one refine over the inliers of a 1 m threshold leaves (both
    # packages: 0.27 m of the 0.4 m injected error here)
    _, gt = world
    np.testing.assert_allclose(z.t.numpy(), (np.linalg.inv(gt[33]) @ gt[35])[:3, 3], atol=0.35)
    # a frame that is not resident fails
    ok_missing, _, _ = M._verify_ransac(tst, src, torch.from_numpy(mask), _tpose(est), 0, 9, tcfg, 0, 0)
    assert not bool(ok_missing)

    zT = np.asarray(jse3.to_matrix(jz)).astype(np.float32)
    for i_enc, j_enc in ((M.encode_kf(0, 3), M.encode_kf(0, 5)), (M.encode_kf(1, 7), M.encode_kf(0, 1))):
        jst = JM._queue_loop(
            jst, jnp.array(i_enc), jnp.array(j_enc), _jpose(zT), jnp.float32(0.25), jcfg,
        )
        tst = M._queue_loop(tst, i_enc, j_enc, _tpose(zT), 0.25, tcfg)
    _assert_states_close(tst, jst)
    assert int(tst.loop_queue.count) == 2 and int(tst.loop_target[5]) == 3
    assert bool(tst.loop_closed)


def test_add_frames_queues_served_loops_first(world, own_state):
    """A loop served for a peer and still pending is queued before
    ``add_frames`` ingests its batch, as JAX's ``add_frames`` queues it
    (``_drain_server_loops`` before the gate): after the batch (two frames
    inside the exclusion window: no intra loop) the port's queue rows
    equal JAX's ``_queue_loop`` of that loop."""
    w, gt = world
    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    m = M.Mapper(tcfg, "cpu")
    m.state = state_from_numpy(state_to_numpy(own_state), "cpu")
    zT = np.eye(4, dtype=np.float32)
    zT[:3, 3] = [0.5, -0.25, 0.125]
    i_enc, j_enc = M.encode_kf(1, 7), M.encode_kf(0, 1)
    m._pending_server_loops.append((i_enc, j_enc, zT, 0.25))
    jst = JM._queue_loop(own_state, jnp.array(i_enc), jnp.array(j_enc), _jpose(zT),
                         jnp.float32(0.25), jcfg)
    frames = (36, 37)
    out = m.add_frames([_tpose(gt[k]) for k in frames],
                       [w.scan_at(gt[k], max_points=4096, seed=k) for k in frames],
                       stamps=[0.1 * k for k in frames], apply_gate=False)
    assert out["loops"] == [None, None] and m._pending_server_loops == []
    t, j = state_to_numpy(m.state), state_to_numpy(jst)
    for k in t:
        if "loop_queue" in k or k in ("loop_target", "loop_closed"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert int(m.state.loop_queue.count) == 1


def test_global_map_matches_jax(world, own_state):
    """``voxel_downsample`` and the assembled map against JAX's: the same
    representatives (as sets, to f32 rounding of the transform)."""
    jst = own_state
    tst = state_from_numpy(state_to_numpy(jst), "cpu")
    jm = JM.Mapper(_cfg(jconfig))
    jm.state = jst
    tm = M.Mapper(_cfg(tconfig), "cpu")
    tm.state = tst
    ref, got = jm.global_map(max_points=2048), tm.global_map(max_points=2048)
    assert got.shape == ref.shape and len(got) > 500
    order = lambda a: a[np.lexsort(np.round(a, 3).T)]  # noqa: E731
    np.testing.assert_allclose(order(got), order(ref), atol=1e-4)
    cloud = pc.Cloud(torch.from_numpy(got.astype(np.float32)), torch.ones(len(got), dtype=torch.bool))
    jcloud = jpc.Cloud(jnp.asarray(got.astype(np.float32)), jnp.ones(len(got), bool))
    ds, jds = pc.voxel_downsample(cloud, 2.0, 256), jpc.voxel_downsample(jcloud, 2.0, 256)
    np.testing.assert_array_equal(ds.mask.numpy(), np.asarray(jds.mask))
    np.testing.assert_array_equal(ds.xyz.numpy(), np.asarray(jds.xyz))
    assert tm.loop_constraints() == [] and M.Mapper(_cfg(tconfig), "cpu").global_map().shape == (0, 3)


# ---------------------------------------------------------------------------
# the whole slice: two robots over the in-process bus, both packages
# ---------------------------------------------------------------------------


def _session_cfg(mod, rid):
    """tests/test_multi_robot.py's two-robot configuration."""
    return mod.SlamConfig(
        number_of_robots=2, robot_id=rid, robot_name=chr(ord("a") + rid),
        keyframe=mod.KeyframeConfig(
            max_keyframes=64, points_per_keyframe=2048, raw_points_capacity=4096,
            distance_threshold=2.0, descript_leaf_size=0.3,
        ),
        loop=mod.LoopConfig(
            near_keyframes=4, submap_capacity=8192, icp_iterations=20,
            history_fitness_score=8.0, ransac_inlier_ratio=0.3, ransac_outlier_threshold=1.0,
        ),
        optimizer=mod.OptimizerConfig(
            edge_capacity=512, gn_iters=6, cg_iters=48,
            odometry_sigmas=(0.005,) * 3 + (0.05,) * 3, loop_noise_scale=0.05,
        ),
        scan_context=mod.ScanContextParams(exclude_recent=10, num_candidates=6),
    )


SPLIT = [list(range(16, 40)), list(range(32, 48))]  # 40 frames, 8 overlapping


def _odometry(gt):
    """Robot a gets ground truth; robot b's odometry drifts forward 5 cm
    and 1 mrad a frame (tests/test_multi_robot.py's drift)."""
    drift = np.asarray(jse3.to_matrix(jse3.exp(jnp.asarray([0, 0, 0.001, 0.05, 0, 0], jnp.float32))))
    odom = {0: {k: gt[k] for k in SPLIT[0]}, 1: {SPLIT[1][0]: gt[SPLIT[1][0]]}}
    for k in SPLIT[1][1:]:
        odom[1][k] = (odom[1][k - 1] @ np.linalg.inv(gt[k - 1]) @ gt[k] @ drift).astype(np.float32)
    return odom


def _session(mod, mapper_cls, bus_cls, pose_fn, world, monkeypatch):
    """Feed both robots frame by frame (spin_once on the sensor clock);
    returns (mappers, retrieval hits, verified inter loops)."""
    w, gt = world
    odom = _odometry(gt)
    hits = []
    real = mod._detect_inter

    def recording(state, robot, cfg):
        out = real(state, robot, cfg)
        if bool(out[0]):
            hits.append((int(robot), int(out[1].robot), int(out[1].index)))
        return out

    monkeypatch.setattr(mod, "_detect_inter", recording)
    bus = bus_cls()
    mappers = [mapper_cls(r) for r in range(2)]
    for m in mappers:
        m.attach_bus(bus)
    inter = []
    for step in range(max(len(s) for s in SPLIT)):
        for r, frames in enumerate(SPLIT):
            if step >= len(frames):
                continue
            k = frames[step]
            wire = mappers[r].add_frame(pose_fn(odom[r][k]), w.scan_at(gt[k], max_points=4096, seed=k), stamp=0.1 * k)
            if wire is not None:
                mappers[r].broadcast_latest(wire)
                info = mappers[r].spin_once(now=0.1 * k)
                if info.get("inter_loop"):
                    x = info["inter_loop"]
                    inter.append((r, k, x["robot"], x["matched_index"], x["inlier_ratio"]))
    for m in mappers:
        m.optimize()
    monkeypatch.undo()
    return mappers, hits, inter


def test_two_robot_session_matches_jax(world, monkeypatch):
    _, gt = world
    jm, jhits, jinter = _session(
        JM, lambda r: JM.Mapper(_session_cfg(jconfig, r)), JLocalBus, _jpose, world, monkeypatch,
    )
    tm, hits, inter = _session(
        M, lambda r: M.Mapper(_session_cfg(tconfig, r), "cpu"), LocalBus, _tpose, world, monkeypatch,
    )
    # each mapper holds the same keyframes of both robots
    for a, b in zip(tm, jm):
        t, j = a.state, b.state
        np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
        np.testing.assert_array_equal(t.desc_db.robot.numpy(), np.asarray(j.desc_db.robot))
        np.testing.assert_array_equal(t.desc_db.index.numpy(), np.asarray(j.desc_db.index))
        np.testing.assert_array_equal(t.stamps.numpy(), np.asarray(j.stamps))
        assert int(t.counts[0]) == len(SPLIT[0]) and int(t.counts[1]) == len(SPLIT[1])
    # the same retrieval hits and the same verified loops
    assert hits == jhits and len(hits) >= 6
    assert [x[:4] for x in inter] == [x[:4] for x in jinter]
    np.testing.assert_allclose([x[4] for x in inter], [x[4] for x in jinter], atol=5e-2)
    assert min(x[4] for x in inter) > 0.55  # far from the 0.3 gate
    # both graphs hold every verified factor (the server's copy too)
    for a, b in zip(tm, jm):
        kinds = [c["kind"] for c in a.loop_constraints()]
        assert kinds == [c["kind"] for c in b.loop_constraints()]
        assert kinds.count("inter") == len(inter)
    # the joint trajectories after a rigid alignment, and robot b's gain
    gaps = []
    for r in range(2):
        for a, b in zip(tm, jm):
            est, ref = a.trajectory(robot=r), b.trajectory(robot=r)
            _, R, t = tio.umeyama_align(est[:, :3, 3], ref[:, :3, 3])
            gaps.append(float(np.abs((R @ est[:, :3, 3].T).T + t - ref[:, :3, 3]).max()))
    assert max(gaps) < 6e-2, gaps  # measured 3.2e-2 m
    # robot b's drift as each package's robot a sees it after the joint solve
    frames_b = SPLIT[1]
    ate = [tio.ate_rmse(m[0].trajectory(robot=1), gt[frames_b]) for m in (tm, jm)]
    assert abs(ate[0] - ate[1]) < 1e-2, ate
