"""LiDAR-Iris of the PyTorch port (``scl_slam_tpu_torch/descriptors/
lidar_iris.py``) against the JAX package, on the same numpy inputs.

Stated tolerances, with their reasons:
- ``make``: the image bit-equal on clouds whose points sit away from every
  row, column and arc boundary; elsewhere an atan2 that differs by an ulp
  between XLA and torch may move a point on a boundary to the next column
  or arc, as Scan Context's sectors (ROADMAP queue 3: up to 0.1% of the
  points), so at most two bins a moved point differ. The row key (a mean
  of 360 maxima, summed in another order) within 1e-6 of its magnitude.
- ``encode_features``: the template and mask bits of the same image equal
  but where a response sits within f32 rounding of its threshold (0 for
  T, 1e-4/cols for M): pocketfft on both sides here, so none flipped at
  these inputs (``FLIPPED_BITS``); cuFFT on the card is held in
  ``chip_smoke.py``.
- ``fft_match``: the sub-pixel shift within 1e-3 column; the rounded shift
  equal unless its fraction lies within ``HALF_GAP`` of 0.5.
- ``match_pair``, ``query``: equal distances (a ratio of integer bit
  counts) and yaws.
- the session: the same keyframes, descriptor hits, matched indices and
  loop decisions; fitness 2e-2 relative, as ``test_torch_live.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import scl_slam_tpu.config as jconfig
from scl_slam_tpu.descriptors import lidar_iris as jli
from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.ops import pointcloud as jpc
from scl_slam_tpu.runtime import checkpoint as jck
from scl_slam_tpu.runtime import mapper as JM
from scl_slam_tpu_torch import config as tconfig
from scl_slam_tpu_torch.descriptors import lidar_iris as li
from scl_slam_tpu_torch.descriptors import registry
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.io.lidar_sim import LidarSim, UrbanScene
from scl_slam_tpu_torch.ops import pointcloud as pc
from scl_slam_tpu_torch.runtime import Mapper
from scl_slam_tpu_torch.runtime import checkpoint as ck
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)

CFG_J = jli.LidarIrisConfig(exclude_recent=5)
CFG_T = li.LidarIrisConfig(exclude_recent=5)
# template/mask bits of one image that may flip between jnp.fft and torch.fft
FLIPPED_BITS = 0
# a rounded fft_match shift may differ where its fraction is this near 0.5
HALF_GAP = 1e-3


def ring_cloud(seed, n=4096, scale=60.0):
    """tests/test_scan_context.py's ring cloud in numpy: points at varying
    radii, heights correlated with the angle."""
    rng = np.random.RandomState(seed)
    theta = rng.uniform(-np.pi, np.pi, n)
    r = rng.uniform(2.0, scale, n)
    z = np.sin(theta * 3.0) * 2.0 + rng.normal(0, 0.3, n)
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], -1).astype(np.float32)


def rotate(xyz, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    return (xyz @ R.T).astype(np.float32)


def centred_cloud(seed, n, n_scan):
    """Points at the centres of random (row, column, arc) bins, so that no
    rounding moves one across a boundary."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, 79, n) + 0.5
    col = rng.randint(0, 360, n) + rng.uniform(-0.3, 0.3, n)
    origin = 15.0 if n_scan == 16 else 24.9
    arc = rng.randint(0, 8, n) * 4.0 + 2.0 - origin
    yaw = np.deg2rad(col - 180.0)
    z = row * np.tan(np.deg2rad(arc))
    return np.stack([row * np.cos(yaw), row * np.sin(yaw), z], -1).astype(np.float32)


# one compiled JAX program a function and configuration, shared by the cases
_fft_match_j = jax.jit(jli.fft_match)
_match_pair_j = jax.jit(jli.match_pair, static_argnums=2)
_encode_j = jax.jit(jli.encode_features, static_argnums=1)


def jmake(xyz, cfg=CFG_J):
    return jli.make(jpc.Cloud(jnp.asarray(xyz), jnp.ones(len(xyz), bool)), cfg)


def tmake(xyz, cfg=CFG_T):
    return li.make(pc.Cloud(torch.from_numpy(xyz), torch.ones(len(xyz), dtype=torch.bool)), cfg)


@pytest.mark.parametrize("n_scan", [64, 16])
def test_make_bit_equal_away_from_boundaries(n_scan):
    """Both arc origins; a batch of two clouds in one K2 image (its plain
    version here), one of them partly padded."""
    cj = jli.LidarIrisConfig(n_scan=n_scan)
    ct = li.LidarIrisConfig(n_scan=n_scan)
    xyz = np.stack([centred_cloud(n_scan, 3000, n_scan), centred_cloud(n_scan + 1, 3000, n_scan)])
    mask = np.ones((2, 3000), bool)
    mask[1, 2000:] = False
    got = li.make(pc.Cloud(torch.from_numpy(xyz), torch.from_numpy(mask)), ct)
    assert got.image.shape == (2, 80, 360) and got.row_key.shape == (2, 80)
    for b in range(2):
        ref = jli.make(jpc.Cloud(jnp.asarray(xyz[b]), jnp.asarray(mask[b])), cj)
        np.testing.assert_array_equal(got.image[b].numpy(), np.asarray(ref.image))
        np.testing.assert_allclose(got.row_key[b].numpy(), np.asarray(ref.row_key), rtol=1e-6, atol=1e-6)
    assert got.image.max() <= 255 and (got.image > 0).float().mean() > 0.05


def test_make_on_random_and_simulated_clouds():
    """ring clouds and a simulator scan (64 beams, 512 azimuths): at most
    two bins a boundary point (0.1% of the points) differ."""
    sim = LidarSim(UrbanScene(seed=7, blocks=1, block_size=40.0), n_azimuth=512, device="cpu")
    clouds = [ring_cloud(0), rotate(ring_cloud(1), 0.37),
              sim.scan_at(UrbanScene(seed=7, blocks=1, block_size=40.0).circuit()[30], seed=30)]
    for xyz in clouds:
        ref, got = jmake(xyz), tmake(xyz)
        moved = int((np.asarray(ref.image) != got.image.numpy()).sum())
        assert moved <= 2 * int(0.001 * len(xyz)), moved
        np.testing.assert_allclose(got.row_key.numpy(), np.asarray(ref.row_key), rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def images():
    """JAX-made images: two scenes, one rotated by 25 columns, and a
    third scene; both packages then work on the same images."""
    a = np.asarray(jmake(ring_cloud(4)).image)
    b = np.asarray(jmake(rotate(ring_cloud(4), 25 * 2 * np.pi / 360)).image)
    c = np.asarray(jmake(ring_cloud(6, scale=40.0)).image)
    return a, b, c


def test_encode_features_bits(images):
    for img in images:
        Tj, Mj = _encode_j(jnp.asarray(img), CFG_J)
        Tt, Mt = li.encode_features(torch.from_numpy(img), CFG_T)
        assert Tt.shape == (4, 80, 360, 2) and Mt.shape == (4, 80, 360)
        flipped = int((np.asarray(Tj) != Tt.numpy()).sum() + (np.asarray(Mj) != Mt.numpy()).sum())
        assert flipped <= FLIPPED_BITS
    np.testing.assert_allclose(li.log_gabor_bank(CFG_T).numpy(), np.asarray(jli.log_gabor_bank(CFG_J)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shift", [25, -25, 40, -40])
def test_fft_match_on_rolled_images(images, shift):
    img = images[0]
    rolled = np.roll(img, shift, axis=1)
    txj = float(_fft_match_j(jnp.asarray(img), jnp.asarray(rolled)))
    txt = float(li.fft_match(torch.from_numpy(img), torch.from_numpy(rolled)))
    assert abs(txt - txj) < 1e-3 and abs(txt - shift) < 0.5
    if abs(abs(txj - np.floor(txj)) - 0.5) > HALF_GAP:
        assert round(txt) == round(txj)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_match_pair_modes(images, mode):
    """A rotated revisit, another scene, a 180-degree roll, and an empty
    image (a flat correlation: both take the first peak)."""
    a, b, c = images
    cj = jli.LidarIrisConfig(match_mode=mode)
    ct = li.LidarIrisConfig(match_mode=mode)
    empty = np.zeros_like(a)
    pairs = [(b, a), (a, c), (a, np.roll(a, 180, axis=1)), (empty, a), (empty, empty)]
    for q, cand in pairs:
        dj, yj = _match_pair_j(jnp.asarray(q), jnp.asarray(cand), cj)
        dt, yt = li.match_pair(torch.from_numpy(q), torch.from_numpy(cand), ct)
        assert float(dt) == float(dj) and float(yt) == float(yj), (mode, float(dt), float(dj))
    # batched: the same pairs as one [5] batch
    qs = torch.from_numpy(np.stack([p[0] for p in pairs]))
    cs = torch.from_numpy(np.stack([p[1] for p in pairs]))
    dt, yt = li.match_pair(qs, cs, ct)
    for k, (q, cand) in enumerate(pairs):
        dj, yj = _match_pair_j(jnp.asarray(q), jnp.asarray(cand), cj)
        assert float(dt[k]) == float(dj) and float(yt[k]) == float(yj)


def test_query_on_a_small_db():
    """Intra queries of three frames at once against 16 stored frames of
    two robots: found, index, distance and yaw equal to JAX's (one JAX
    program); the inter query of the same frames finds the other robot's
    frames only."""
    clouds = [ring_cloud(20 + i, n=2048) for i in range(16)]
    jdb = jli.make_db(24, CFG_J)
    tdb = li.make_db(24, CFG_T, "cpu")
    for i, xyz in enumerate(clouds):
        robot, index = i % 2, i // 2
        jdb = jli.insert(jdb, jmake(xyz), robot=robot, index=index, pos=i)
        li.insert(tdb, tmake(xyz), robot, index, i)
    np.testing.assert_array_equal(tdb.descriptors.numpy(), np.asarray(jdb.descriptors))
    queries = [rotate(clouds[4], 0.4), rotate(clouds[5], -0.2), ring_cloud(99, n=2048)]
    jq = [jmake(x) for x in queries]
    tq = li.Iris(torch.from_numpy(np.stack([np.asarray(q.image) for q in jq])),
                 torch.from_numpy(np.stack([np.asarray(q.row_key) for q in jq])))
    got = li.query(tdb, tq, 0, torch.tensor([12, 12, 12]), CFG_T, mode="intra")
    for k, q in enumerate(jq):
        ref = jli.query(jdb, q, jnp.array(0), jnp.array(12), CFG_J, mode="intra")
        assert bool(got.found[k]) == bool(ref.found)
        assert int(got.index[k]) == int(ref.index) and int(got.robot[k]) == int(ref.robot)
        assert float(got.distance[k]) == float(ref.distance)
        assert float(got.yaw[k]) == float(ref.yaw)
    assert bool(got.found[0]) and int(got.index[0]) == 2 and int(got.robot[0]) == 0
    inter = li.query(tdb, tq, 0, torch.tensor([12, 12, 12]), CFG_T, mode="inter")
    assert not bool(inter.found[0])  # frame 4 is robot 0's own, frame 5 robot 1's
    assert (inter.robot[inter.found] == 1).all() and int(inter.index[1]) == 2


def test_family_wire_and_window():
    cfg = tconfig.SlamConfig(descriptor_type=tconfig.DescriptorType.LIDAR_IRIS,
                             lidar_iris=tconfig.LidarIrisParams(exclude_recent=7))
    fam = registry.get_family(cfg)
    iris = tmake(ring_cloud(8))
    wire = fam.to_wire(iris)
    assert fam.name == "lidar_iris" and wire.shape == (fam.wire_dim,) == (80 * 360 + 80,)
    np.testing.assert_array_equal(wire.numpy(), np.asarray(jli.to_wire(jli.Iris(
        jnp.asarray(iris.image.numpy()), jnp.asarray(iris.row_key.numpy())))))
    back = fam.from_wire(wire)
    assert torch.equal(back.image, iris.image) and torch.equal(back.row_key, iris.row_key)
    assert registry.exclude_recent(cfg) == 7


# ---------------------------------------------------------------------------
# a loop-closing Iris session at small widths, and a JAX checkpoint of it
# ---------------------------------------------------------------------------

N_LAP0, N_LAP1, SPLIT = 40, 7, 45


def _session_cfg(mod):
    return mod.SlamConfig(
        descriptor_type=mod.DescriptorType.LIDAR_IRIS,
        keyframe=mod.KeyframeConfig(
            max_keyframes=64, points_per_keyframe=2048, raw_points_capacity=16384,
            distance_threshold=0.5,
        ),
        loop=mod.LoopConfig(near_keyframes=6, submap_capacity=8192, icp_iterations=30),
        optimizer=mod.OptimizerConfig(edge_capacity=128, gn_iters=4, cg_iters=24),
    )


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """The simulator's urban block at 256 azimuths: 40 frames of one lap,
    then 7 of a second lap 0.5 m aside (every frame a keyframe), with
    drifting odometry; the JAX Mapper's run, checkpointed at SPLIT."""
    scene = UrbanScene(seed=7, blocks=1, block_size=40.0)
    sim = LidarSim(scene, n_azimuth=256, device="cpu")
    gt = scene.circuit(step=1.0)[:N_LAP0] + scene.circuit(lane_offset=0.5, step=1.0)[:N_LAP1]
    rng = np.random.RandomState(3)
    odom = [np.float32(gt[0])]
    for k in range(1, len(gt)):
        w, u = rng.normal(0, 0.002, 3), rng.normal(0, 0.02, 3)
        drift = np.eye(4)
        drift[:3, :3] = _rodrigues(w)
        drift[:3, 3] = u
        odom.append(np.float32(odom[-1] @ np.linalg.inv(gt[k - 1]) @ gt[k] @ drift))
    scans = [sim.scan_at(T, seed=k) for k, T in enumerate(gt)]
    jm = JM.Mapper(_session_cfg(jconfig))
    ckpt = str(tmp_path_factory.mktemp("iris") / "jax.npz")
    ref = _drive(jm, _jpose, odom, scans, 0, len(gt), save=(SPLIT, ckpt))
    return odom, scans, ref, ckpt, jm


def _rodrigues(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K


def _jpose(T):
    return jse3.Pose(jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3]))


def _tpose(T):
    return se3.Pose(torch.from_numpy(T[:3, :3]), torch.from_numpy(T[:3, 3]))


def _drive(m, pose_of, odom, scans, k0, k1, save=(None, None)):
    """Frames [k0, k1) on the sensor clock; per frame: whether it became a
    keyframe, and the loop's (matched index, fitness) or None. With
    ``save`` = (frame, path), a JAX checkpoint is written before that
    frame."""
    out = []
    for k in range(k0, k1):
        if k == save[0]:
            jck.save(m, save[1])
        wire = m.add_frame(pose_of(odom[k]), scans[k], stamp=float(k))
        loop = None if wire is None else m.spin_once(now=float(k))["loop"]
        out.append((wire is not None, loop and (loop["matched_index"], loop["fitness"])))
    return out


def _assert_decisions_equal(got, ref):
    assert [g[0] for g in got] == [r[0] for r in ref]
    assert [g[1] and g[1][0] for g in got] == [r[1] and r[1][0] for r in ref]
    for g, r in zip(got, ref):
        if g[1]:
            np.testing.assert_allclose(g[1][1], r[1][1], rtol=2e-2)


def test_iris_session_matches_jax(session):
    odom, scans, ref, _, jm = session
    m = Mapper(_session_cfg(tconfig), "cpu")
    got = _drive(m, _tpose, odom, scans, 0, len(scans))
    _assert_decisions_equal(got, ref)
    assert sum(bool(r[1]) for r in ref) >= 2, "the session closed too few loops"
    np.testing.assert_array_equal(m.state.loop_target.numpy(), np.asarray(jm.state.loop_target))
    db, jdb = m.state.desc_db, jm.state.desc_db
    np.testing.assert_array_equal(db.index.numpy(), np.asarray(jdb.index))
    moved = int((db.descriptors.numpy() != np.asarray(jdb.descriptors)).sum())
    assert moved <= 2 * int(0.001 * sum(len(s) for s in scans)), moved


def test_jax_checkpoint_with_iris_db_loads(session):
    """The JAX session saved at SPLIT (an Iris DB of 45 frames) loads into
    the port bit for bit and goes on to the end with JAX's decisions."""
    odom, scans, ref, path, jm = session
    m = ck.load(Mapper(_session_cfg(tconfig), "cpu"), path)
    assert m.state.desc_db.descriptors.shape == (64, 80, 360)
    assert int(m.state.desc_db.count) == SPLIT == m._keyframes
    got = _drive(m, _tpose, odom, scans, SPLIT, len(scans))
    _assert_decisions_equal(got, ref[SPLIT:])
    assert any(g[1] for g in got)
