"""The plain-vector descriptor families of the PyTorch port (GRSD, FPFH,
SHOT, M2DP), ``pointcloud.estimate_normals`` and the six-family registry
against the JAX package, on the same numpy inputs.

Stated tolerances, with their reasons:
- k-NN: the port ranks neighbours by the exact per-coordinate d2, JAX by
  the expanded form |q|^2 - 2 q.x + |x|^2; the neighbour sets are held
  equal where the k-th and (k+1)-th exact d2 lie further apart than the
  expanded form's rounding (``KNN_GAP`` of |q|^2 + |x|^2).
- normals: |dot| >= 1 - 1e-4 against JAX's, the sign equal where the
  viewpoint rule decides it (|n.p| > 1e-3 |p|). Where a normal is
  perpendicular to its point's ray (a surface seen edge-on) or the cloud
  is degenerate (a plane through the sensor), the rule ties and the sign
  is the eigensolver's, which differs between LAPACK builds: such points
  are counted, not held.
- the stages after the k-NN and the normals, fed JAX's: the RSD radii
  within 4 ulp (``RSD_RTOL``: XLA:CPU contracts the distance's sum of
  squares into fused multiply-adds, fma(z, z, fma(y, y, x x)), where the
  port rounds each step, as the kernels' d2), their validity equal; the
  GRSD, FPFH and SHOT histograms equal. End to end: GRSD, SHOT and M2DP
  within 1e-5 (M2DP is an SVD: a few ulp), FPFH within the bins that its
  tied-sign neighbours may move (``fpfh_bound``).
- queries: the same decisions, indices and distances.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import scl_slam_tpu.config as jconfig
from scl_slam_tpu.descriptors import geometric as jg
from scl_slam_tpu.descriptors import m2dp as jm
from scl_slam_tpu.descriptors import registry as jregistry
from scl_slam_tpu.descriptors import shot as js
from scl_slam_tpu.ops import pointcloud as jpc
from scl_slam_tpu_torch import config as tconfig
from scl_slam_tpu_torch.descriptors import base, geometric as tg, m2dp as tm
from scl_slam_tpu_torch.descriptors import registry
from scl_slam_tpu_torch.descriptors import shot as ts
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.io.lidar_sim import LidarSim, UrbanScene
from scl_slam_tpu_torch.ops import pointcloud as pc
from scl_slam_tpu_torch.runtime import FleetMapper, Mapper
from scl_slam_tpu_torch.runtime import checkpoint as ck
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)

N = 1024          # every cloud here: one JAX program a function
KNN_GAP = 4e-7    # the expanded form's rounding, relative to |q|^2 + |x|^2
RSD_RTOL = 4.8e-7  # 4 ulp
FAMILIES = ["scan_context", "lidar_iris", "m2dp", "grsd", "fpfh", "shot"]


@pytest.fixture(scope="module")
def clouds():
    """Two simulator scans of the urban block (256 azimuths), strided to N
    points, and a padded ring of 700 points; numpy (xyz, mask) pairs."""
    scene = UrbanScene(seed=7, blocks=1, block_size=40.0)
    sim = LidarSim(scene, n_azimuth=256, device="cpu")
    out = []
    for k in (10, 60):
        c = pc.from_points(torch.from_numpy(sim.scan_at(scene.circuit()[k], seed=k)), N)
        out.append((c.xyz.numpy(), c.mask.numpy()))
    rng = np.random.RandomState(4)
    th, r = rng.uniform(-np.pi, np.pi, 700), rng.uniform(3, 40, 700)
    ring = np.stack([r * np.cos(th), r * np.sin(th), np.sin(3 * th) + rng.normal(0, 0.2, 700)], -1)
    c = pc.from_points(torch.from_numpy(ring.astype(np.float32)), N)
    out.append((c.xyz.numpy(), c.mask.numpy()))
    return out


def _jc(xyz, mask):
    return jpc.Cloud(jnp.asarray(xyz), jnp.asarray(mask))


def _tc(xyz, mask):
    return pc.Cloud(torch.from_numpy(xyz), torch.from_numpy(mask))


_JIT = {}


def jit(name, fn):
    """One compiled JAX program a name, shared by the cases."""
    if name not in _JIT:
        _JIT[name] = jax.jit(fn)
    return _JIT[name]


def _exact_knn(pts, k):
    d2 = ((pts[:, None, :].astype(np.float64) - pts[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1, kind="stable")
    return order[:, :k], np.take_along_axis(d2, order[:, : k + 1], 1), (pts.astype(np.float64) ** 2).sum(-1)


def _tied_sign(normals, xyz, mask):
    """Points whose viewpoint rule cannot decide the normal's sign."""
    dot = np.abs((normals * xyz).sum(-1))
    return mask & (dot <= 1e-3 * np.linalg.norm(xyz, axis=-1))


def test_knn_and_estimate_normals(clouds):
    k = 16
    for xyz, mask in clouds:
        pts = np.where(mask[:, None], xyz, np.float32(pc.PAD_VALUE))
        idx = pc.knn_indices(torch.from_numpy(pts), k).numpy()
        ref_idx, d2, sq = _exact_knn(pts, k)
        # the exact ranking: the port's sets equal it everywhere, and
        # JAX's where the k-th neighbour is clear of the expanded rounding
        np.testing.assert_array_equal(np.sort(idx, 1), np.sort(ref_idx, 1))
        jidx = np.asarray(jit("knn", lambda c: jg._knn_normals(c, k)[0])(_jc(xyz, mask)))
        clear = mask & (d2[:, k] - d2[:, k - 1] > KNN_GAP * (sq + sq[mask].max()))
        np.testing.assert_array_equal(np.sort(idx[clear], 1), np.sort(jidx[clear], 1))
        assert clear.sum() > 0.9 * mask.sum()
        assert (idx[mask] < mask.sum()).all()  # no pad among a valid point's neighbours

        nj = np.asarray(jit("normals", lambda c: jpc.estimate_normals(c, k=16))(_jc(xyz, mask)))
        nt = pc.estimate_normals(_tc(xyz, mask), k=16).numpy()
        dot = (nj * nt).sum(-1)
        assert (np.abs(dot[clear]) >= 1 - 1e-4).all()
        tied = _tied_sign(nj, xyz, mask)
        assert (dot[clear & ~tied] > 0).all()
        assert tied.sum() < 0.1 * mask.sum()
        assert (nt[~mask] == 0).all()


def test_normals_on_a_degenerate_cloud():
    """A plane through the sensor: every normal is the plane's, in both
    packages, up to the sign (the viewpoint rule ties on every point).
    A cloud of fewer than k valid points takes pads (at 1e6) into its
    neighbourhoods in both packages: a covariance of ~1e11 whose small
    eigenvectors are f32 rounding noise, not held; the port's normals are
    unit vectors there, and zero on the pads."""
    g = np.stack(np.meshgrid(np.arange(32.0), np.arange(32.0)), -1).reshape(-1, 2) - 15.5
    xyz = np.c_[g, np.zeros(len(g))].astype(np.float32)
    mask = np.ones(N, bool)
    nt = pc.estimate_normals(_tc(xyz, mask), k=16).numpy()
    nj = np.asarray(jit("normals", lambda c: jpc.estimate_normals(c, k=16))(_jc(xyz, mask)))
    assert (np.abs(nt[:, 2]) >= 1 - 1e-6).all() and (np.abs(nj[:, 2]) >= 1 - 1e-6).all()
    assert _tied_sign(nj, xyz, mask).all()
    few = np.full((N, 3), np.float32(pc.PAD_VALUE))
    few[:10] = xyz[:10]
    mask = np.arange(N) < 10
    nt = pc.estimate_normals(_tc(few, mask), k=16).numpy()
    np.testing.assert_allclose(np.linalg.norm(nt[:10], axis=-1), 1.0, rtol=1e-5)
    assert (nt[10:] == 0).all()


def fpfh_bound(normals, xyz, mask, cfg):
    """How far FPFH may move through tied-sign normals: each of the centre
    point's neighbours with one moves at most its alpha and theta bins, a
    count of 100/valid each, twice (out and in); a tied centre normal may
    move all."""
    pts = np.where(mask[:, None], xyz, 1e6)
    w = mask.astype(np.float64)
    centroid = (pts * w[:, None]).sum(0) / max(w.sum(), 1)
    c = int(np.argmin(((pts - centroid) ** 2).sum(-1)))
    nbr = np.argsort(((pts - pts[c]) ** 2).sum(-1), kind="stable")[: cfg.knn]
    tied = _tied_sign(normals, xyz, mask)
    n_valid = max(int((mask[nbr] & (nbr != c)).sum()), 1)
    if tied[c]:
        return 600.0
    return 4 * int(tied[nbr].sum()) * 100.0 / n_valid + 1e-4


VECTOR_CASES = {
    "grsd": (lambda c: jg.grsd_make(c, jg.GRSDConfig()).descriptor,
             lambda c: tg.grsd_make(c, tg.GRSDConfig()).descriptor),
    "fpfh": (lambda c: jg.fpfh_make(c, jg.FPFHConfig()).descriptor,
             lambda c: tg.fpfh_make(c, tg.FPFHConfig()).descriptor),
    "shot": (lambda c: js.shot_make(c, js.SHOTConfig()).descriptor,
             lambda c: ts.shot_make(c, ts.SHOTConfig()).descriptor),
    "m2dp": (lambda c: jm.make(c, jm.M2DPConfig()).descriptor,
             lambda c: tm.make(c, tm.M2DPConfig()).descriptor),
}


@pytest.mark.parametrize("name", sorted(VECTOR_CASES))
def test_vector_make_matches_jax(clouds, name):
    """End to end, then the stages after the k-NN and the normals fed
    JAX's; a batch of the clouds at once on the port's side."""
    jfn, tfn = VECTOR_CASES[name]
    batch = tfn(pc.Cloud(torch.from_numpy(np.stack([c[0] for c in clouds])),
                         torch.from_numpy(np.stack([c[1] for c in clouds])))).numpy()
    for b, (xyz, mask) in enumerate(clouds):
        ref = np.asarray(jit(name, jfn)(_jc(xyz, mask)))
        got = tfn(_tc(xyz, mask)).numpy()
        np.testing.assert_array_equal(batch[b], got)
        t_x, t_m = torch.from_numpy(xyz), torch.from_numpy(mask)
        if name == "grsd":
            cfg = jg.GRSDConfig()
            idx, nbrs, normals = jit("knn_normals", lambda c: jg._knn_normals(c, cfg.knn))(_jc(xyz, mask))
            r_j = jit("rsd", lambda c: jg._rsd_radii(c, cfg))(_jc(xyz, mask))
            r_t = tg.rsd_from_neighbours(
                t_x, t_m, torch.from_numpy(np.asarray(idx)).long(),
                torch.from_numpy(np.asarray(nbrs)), torch.from_numpy(np.asarray(normals)), tg.GRSDConfig())
            np.testing.assert_array_equal(r_t[2].numpy(), np.asarray(r_j[2]))
            for a, t in zip(r_j[:2], r_t[:2]):
                np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=RSD_RTOL, atol=0)
            hist = tg.grsd_histogram(t_x, *(torch.from_numpy(np.asarray(a)) for a in r_j), tg.GRSDConfig())
            np.testing.assert_array_equal(hist.numpy(), ref)
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        elif name in ("fpfh", "shot"):
            nj = np.asarray(jit("normals", lambda c: jpc.estimate_normals(c, k=16))(_jc(xyz, mask)))
            stage = (tg.fpfh_one(t_x, t_m, torch.from_numpy(nj), tg.FPFHConfig()) if name == "fpfh"
                     else ts.shot_one(t_x, t_m, torch.from_numpy(nj), ts.SHOTConfig()))
            np.testing.assert_allclose(stage.numpy(), ref, rtol=0, atol=1e-5)
            bound = fpfh_bound(nj, xyz, mask, tg.FPFHConfig()) if name == "fpfh" else (
                2 * int(_tied_sign(nj, xyz, mask).sum()) * 100.0 / max(int(mask.sum()), 1) + 1e-4)
            assert np.abs(got - ref).sum() <= bound
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
            np.testing.assert_allclose(np.linalg.norm(got), 1.0, rtol=1e-5)


def test_vector_query_decisions_match_jax():
    """vector_query for 4 queries at once against 12 stored vectors of two
    robots, intra and inter, at a gate that splits them."""
    rng = np.random.RandomState(2)
    vecs = rng.normal(0, 1, (12, 33)).astype(np.float32)
    queries = np.stack([vecs[3] + 0.1, vecs[8] - 0.05, rng.normal(0, 1, 33), vecs[0]]).astype(np.float32)
    jdb = jg.make_db(16, 33)
    tdb = tg.make_db(16, 33, "cpu")
    for i, v in enumerate(vecs):
        jdb = jg.insert(jdb, jnp.asarray(v), i % 2, i // 2, pos=i)
        tg.insert(tdb, tg.Vector(torch.from_numpy(v)), i % 2, i // 2, i)
    for mode, robot in (("intra", 1), ("inter", 0), ("intra", 0)):
        got = tg.vector_query(tdb, torch.from_numpy(queries), robot, torch.full((4,), 9), 5, 2, 2.0, mode)
        for k, q in enumerate(queries):
            ref = jg.vector_query(jdb, jnp.asarray(q), jnp.array(robot), jnp.array(9), 5, 2, 2.0, mode)
            assert bool(got.found[k]) == bool(ref.found), (mode, k)
            assert int(got.index[k]) == int(ref.index) and int(got.robot[k]) == int(ref.robot)
            np.testing.assert_allclose(float(got.distance[k]), float(ref.distance), rtol=1e-6)
            assert float(got.yaw[k]) == 0.0
        assert bool(got.found.any())


def _family_cfg(mod, kind):
    """tests/test_descriptor_families.py's widths."""
    return mod.SlamConfig(
        descriptor_type=mod.DescriptorType(kind),
        keyframe=mod.KeyframeConfig(max_keyframes=16, points_per_keyframe=512, raw_points_capacity=N),
        loop=mod.LoopConfig(near_keyframes=2, submap_capacity=1024, icp_iterations=4),
        optimizer=mod.OptimizerConfig(edge_capacity=64, gn_iters=2, cg_iters=8),
        scan_context=mod.ScanContextParams(exclude_recent=2),
        lidar_iris=mod.LidarIrisParams(exclude_recent=2),
    )


# the largest wire difference a family's make may show between the
# packages on these frames (uniform random points: FPFH and SHOT through
# tied-sign normals, at most a count of 100/valid in two bins each)
WIRE_ATOL = {"scan_context": 1e-6, "lidar_iris": 1e-6, "m2dp": 1e-5, "grsd": 1e-5,
             "fpfh": 2 * 100.0 / 63, "shot": 2 * 100.0 / 800}


@pytest.mark.parametrize("kind", FAMILIES)
def test_mapper_round_trip_and_peer_wire(kind):
    """The port's counterpart of tests/test_descriptor_families.py: four
    frames through ``Mapper.add_frame`` (wires against the JAX family's
    make on the same padded scans), a spin, and a zero wire of the
    family's length through ``ingest_peer_descriptor``."""
    jcfg, cfg = _family_cfg(jconfig, kind), _family_cfg(tconfig, kind)
    jfam, fam = jregistry.get_family(jcfg), registry.get_family(cfg)
    assert fam.name == jfam.name == kind and fam.wire_dim == jfam.wire_dim
    assert registry.exclude_recent(cfg) == jregistry.exclude_recent(jcfg)
    make_wire = jit(f"wire_{kind}", lambda c: jfam.to_wire(jfam.make(c)))
    m = Mapper(cfg, "cpu")
    rng = np.random.RandomState(sum(map(ord, kind)))
    for k in range(4):
        # a box of distinct extents: M2DP's principal axes are well posed
        # (in a cube they tie, and its frame is the eigensolver's choice)
        xyz = (rng.uniform(-1, 1, (800, 3)) * [30.0, 15.0, 3.0]).astype(np.float32)
        wire = m.add_frame(se3.Pose(np.eye(3, dtype=np.float32), np.float32([2.0 * k, 0, 0])),
                           xyz, 0.1 * k)
        assert wire is not None and wire.shape == (fam.wire_dim,)
        c = pc.from_points(torch.from_numpy(xyz), N)
        ref = np.asarray(make_wire(jpc.Cloud(jnp.asarray(c.xyz.numpy()), jnp.asarray(c.mask.numpy()))))
        np.testing.assert_allclose(wire, ref, rtol=0, atol=WIRE_ATOL[kind])
    m.spin_once(now=1.0)
    assert int(m.state.counts[0]) == 4 and int(m.state.desc_db.count) == 4

    peer = Mapper(cfg, "cpu")
    ident = se3.Pose(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    assert peer.ingest_peer_descriptor(0, 0, ident, ident, np.zeros(fam.wire_dim, np.float32))
    assert int(peer.state.desc_db.count) == 1


@pytest.mark.parametrize("kind", FAMILIES[1:])
def test_replay_fleet_and_checkpoint_take_every_family(kind, tmp_path):
    """The batched paths under each family beside Scan Context: a replay
    chunk of 2 x 2 frames, its checkpoint loaded back, and a two-robot
    fleet of 2 steps (a query of per-lane robots): every descriptor stored
    equals its frame's ``make``."""
    cfg = _family_cfg(tconfig, kind)
    fam = registry.get_family(cfg)
    rng = np.random.RandomState(7)
    scans = [(rng.uniform(-1, 1, (800, 3)) * [30.0, 15.0, 3.0]).astype(np.float32) for _ in range(4)]
    poses = [se3.Pose(np.eye(3, dtype=np.float32), np.float32([2.0 * k, 0, 0])) for k in range(4)]
    made = [fam.parts(fam.make(pc.from_points(torch.from_numpy(x), N)))[0] for x in scans]
    m = Mapper(cfg, "cpu")
    out = m.replay(poses, scans, apply_gate=False, batch=2, chunk_batches=2)
    assert len(out["loops"]) == 4
    for k in range(4):
        torch.testing.assert_close(m.state.desc_db.descriptors[k], made[k], rtol=0, atol=1e-5)
    path = str(tmp_path / "ckpt.npz")
    ck.save(m, path)
    back = ck.load(Mapper(cfg, "cpu"), path)
    assert torch.equal(back.state.desc_db.descriptors, m.state.desc_db.descriptors)
    fleet = FleetMapper(dataclasses.replace(cfg, number_of_robots=2), "cpu")
    for step in range(2):
        for r in range(2):
            fleet.add_robot_frame(r, poses[step], scans[2 * r + step], stamp=0.1 * step)
        fleet.step()
    K = cfg.keyframe.max_keyframes
    for r in range(2):
        for step in range(2):
            torch.testing.assert_close(fleet.state.desc_db.descriptors[r * K + step],
                                       made[2 * r + step], rtol=0, atol=1e-5)


def test_get_family_for_every_type():
    for kind in FAMILIES:
        cfg = _family_cfg(tconfig, kind)
        fam = registry.get_family(cfg)
        assert fam.name == kind
        db = fam.make_db(4, "cpu")
        assert isinstance(db, base.DescriptorDB) and db.keys.shape[0] == 4
    cfg = tconfig.SlamConfig(m2dp=tconfig.M2DPParams(exclude_recent=5),
                             grsd=tconfig.GRSDParams(exclude_recent=6))
    for kind, window in (("m2dp", 5), ("grsd", 6), ("fpfh", 30), ("scan_context", 100)):
        assert registry.exclude_recent(
            dataclasses.replace(cfg, descriptor_type=tconfig.DescriptorType(kind))) == window
    assert registry.get_family(dataclasses.replace(
        cfg, descriptor_type=tconfig.DescriptorType.SHOT, shot=tconfig.SHOTParams(cos_bins=7))).wire_dim == 4 * 2 * 2 * 7
    with pytest.raises(ValueError):
        registry.get_family(dataclasses.replace(cfg, descriptor_type="bogus"))
