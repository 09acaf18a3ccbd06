"""The batched-ICP switches of the PyTorch port against the JAX package's:
kernels K5 (``icp_moments_batched``), K7 (``nn_index_batched``), K8
(``nn_select_batched_mxu``) and K1's argmin body, and the paths of
``icp_batched``, ``Mapper.replay`` and ``ransac_align_batched`` that
``FUSED_ICP``, ``NN_INDEX``, ``MXU_NN`` and ``SELECT_VARIANT`` select.

On the CPU the JAX package never takes these paths (its
``_matches_batched`` and ``icp_batched`` test ``jax.default_backend() !=
"cpu"``). The ``tpu_paths`` fixture takes them as ``tests/test_pallas.py``
does: the backend reads "tpu" and every Pallas kernel the path reaches
runs in interpret mode (the patch is global: ``jax.clear_caches()`` after
setting and after undoing it, so that no trace made under the other
backend is reused). Under it JAX's batched 1-NN is the exact
per-coordinate kernel, as the port's is, so the tolerances are tighter
than in ``test_torch_registration.py``. Stated, with their reasons:

- kernels: d2 of K1-argmin and K7 within 2 ulp of the interpret-mode
  kernel (XLA:CPU contracts or reorders the kernel's multiply-adds), the
  index and the selection equal; K5's 18 sums within 1e-5 of max(|a|, 1)
  (sums in another order); K8 the TPU kernel's own criterion
  (``test_pallas.py::TestMXUSelectKernel``): at least 99% identical
  winners, and each winner's exact d2 within 5e-3 of the other's (the
  expanded form's error at these coordinates; JAX takes the cross term as
  a matmul, the port elementwise);
- ``icp_batched``: the decisions equal (finite, under the gate,
  converged); on converged lanes rotation 2e-5, translation 5e-4 m,
  fitness 1e-4 relative, inlier fraction 1e-6 (float32 sums and SVDs in
  other orders, through an ICP that stops at tol=1e-4 per update);
- ``Mapper.replay`` under ``FUSED_ICP``: ``test_torch_replay.py``'s
  decisions and tolerances (z_t 5e-3 m, fitness 2e-2 relative);
- ``ransac_align_batched`` under ``NN_INDEX``, JAX's uniforms injected:
  correspondences and inlier counts equal, the pose to 1e-4.
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import scl_slam_tpu.config as jconfig
from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.io import kitti
from scl_slam_tpu.ops import pallas_kernels as pk
from scl_slam_tpu.ops import pointcloud as jpc
from scl_slam_tpu.ops import registration as jreg
from scl_slam_tpu.runtime.mapper import Mapper as JMapper
from scl_slam_tpu_torch import config as tconfig
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.ops import kernels
from scl_slam_tpu_torch.ops import pointcloud as pc
from scl_slam_tpu_torch.ops import registration as reg
from scl_slam_tpu_torch.runtime import mapper as M
from scl_slam_tpu_torch.runtime.state import state_to_numpy
from test_torch_cuda import nn_inputs
from test_torch_fleet import _ransac_lanes
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)
from test_torch_registration import _lanes
from test_torch_replay import _cfg as replay_cfg
from test_torch_replay import _same_loops

torch.set_num_threads(2)

ULP2 = 2.0**-22   # 2 ulp, relative
SWITCHES = ("FUSED_ICP", "MXU_NN", "NN_INDEX", "SELECT_VARIANT")
PALLAS = ("nn_select_batched_pallas", "nn_index_batched_pallas",
          "nn_select_batched_mxu_pallas", "icp_moments_batched_pallas")
PORT = ("nn_select_batched", "nn_index_batched", "nn_select_batched_mxu",
        "icp_moments_batched")


@pytest.fixture
def tpu_paths(monkeypatch):
    """JAX's TPU paths on the CPU: the backend reads "tpu", each Pallas
    kernel of the batched ICP runs in interpret mode. Yields the names of
    the kernels JAX traced; undone (and the caches cleared) afterwards."""
    traced = []

    def interpreted(name, f):
        def call(*a, **k):
            traced.append(name)
            return f(*a, **k, interpret=True)
        return call

    for name in PALLAS:
        monkeypatch.setattr(pk, name, interpreted(name, getattr(pk, name)))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jax.clear_caches()
    yield traced
    monkeypatch.undo()
    jax.clear_caches()


@pytest.fixture
def port_calls(monkeypatch):
    """Counts the port's calls of its batched kernel wrappers (K1 by
    body), so a test can show which path ran on the CPU."""
    calls = collections.Counter()

    def counted(name, f):
        def call(*a, **k):
            key = f"{name}:{k.get('variant', 'mineq')}" if name == "nn_select_batched" else name
            calls[key] += 1
            return f(*a, **k)
        return call

    for name in PORT:
        monkeypatch.setattr(kernels, name, counted(name, getattr(kernels, name)))
    return calls


def _switch(monkeypatch, name, value):
    monkeypatch.setattr(jreg, name, value)
    monkeypatch.setattr(reg, name, value)


def _moments_inputs(B=3, nq=256, nt=1024, seed=0):
    """tests/test_pallas.py::TestICPMomentsKernel._inputs, with the pose as
    R [B, 3, 3], t [B, 3] beside JAX's 128-lane pose rows."""
    rng = np.random.RandomState(seed)
    src = rng.uniform(-20, 20, (B, nq, 3)).astype(np.float32)
    smask = rng.rand(B, nq) > 0.1
    tgt = rng.uniform(-20, 20, (B, nt, 3)).astype(np.float32)
    tmask = rng.rand(B, nt) > 0.1
    payload = np.concatenate(
        [np.where(tmask[:, :, None], tgt, 1e6).transpose(0, 2, 1),
         tmask[:, None, :].astype(np.float32)], axis=1,
    )
    src4 = np.concatenate([src.transpose(0, 2, 1), smask[:, None, :].astype(np.float32)], axis=1)
    R = np.zeros((B, 3, 3), np.float32)
    t = np.zeros((B, 3), np.float32)
    for b in range(B):
        a = 0.2 * b
        R[b] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        t[b] = [1.0 * b, -2.0, 0.5]
    rows = np.zeros((B, 128), np.float32)
    rows[:, 0:9] = R.reshape(B, 9)
    rows[:, 9:12] = t
    return [np.ascontiguousarray(x) for x in (src4, payload, R, t, rows)]


@pytest.mark.parametrize("variant", ["mineq", "argmin"])
def test_k5_plain_matches_pallas_interpret(variant):
    src4, payload, R, t, rows = _moments_inputs()
    active = np.array([1, 1, 0], np.int32)
    m = kernels.icp_moments_batched(
        *(torch.from_numpy(x) for x in (src4, payload, R, t, active)), 5.0, variant=variant,
    ).numpy()
    ref = np.asarray(pk.icp_moments_batched_pallas(
        jnp.asarray(src4), jnp.asarray(payload), jnp.asarray(rows), jnp.asarray(active), 5.0,
        variant=variant, interpret=True,
    ))[:, : kernels.M_SLOTS]
    assert m.shape == (3, kernels.M_SLOTS)
    rel = np.abs(m - ref) / np.maximum(np.abs(ref), 1.0)
    assert rel.max() < 1e-5, rel.max()
    assert np.all(m[2] == 0.0)                          # the inactive lane
    assert m[0, kernels.M_W] > 100 and m[0, kernels.M_W] == ref[0, kernels.M_W]
    np.testing.assert_array_equal(m[:, kernels.M_NSRC], ref[:, kernels.M_NSRC])


@pytest.mark.parametrize("nt", [1024, 2048])
def test_k7_and_k1_argmin_plain_match_pallas_interpret(nt):
    """On inputs with exact ties planted (nn_inputs: triplicated targets,
    equidistant integer points) the lowest index wins in both; d2 within
    2 ulp, index and selection equal; inactive lanes (inf, 0)."""
    q, payload, active = nn_inputs(11, 3, 256, nt)
    args = [torch.from_numpy(x) for x in (q, payload, active)]
    d7, i7 = kernels.nn_index_batched(*args)
    d1, s1 = kernels.nn_select_batched(*args, variant="argmin")
    jargs = [jnp.asarray(x) for x in (q, payload, active)]
    rd7, ri7 = pk.nn_index_batched_pallas(*jargs, interpret=True)
    rd1, rs1 = pk.nn_select_batched_pallas(*jargs, variant="argmin", interpret=True)
    assert i7.dtype == torch.int32
    np.testing.assert_array_equal(i7.numpy(), np.asarray(ri7))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(rs1))
    for d, rd in ((d7, rd7), (d1, rd1)):
        np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=ULP2, atol=0)
    assert torch.equal(d1, d7)
    # the argmin payload is the indexed column, exactly
    np.testing.assert_array_equal(
        s1.numpy()[[0, 2]], np.take_along_axis(payload, i7.numpy()[:, None, :].astype(np.int64), 2)[[0, 2]]
    )
    assert torch.isinf(d7[1]).all() and (i7[1] == 0).all() and (s1[1] == 0).all()
    # lane 2's equidistant ties take the lowest index: c + e_x, at index k
    n_tie = min(nt // 3, 256)
    np.testing.assert_array_equal(i7[2, :n_tie].numpy(), np.arange(n_tie))


def test_k8_plain_matches_mxu_pallas_interpret():
    """tests/test_pallas.py::TestMXUSelectKernel's inputs and criterion."""
    rng = np.random.RandomState(0)
    B, nq, nt = 2, 256, 1024
    q = rng.uniform(-40, 40, (B, nq, 3)).astype(np.float32)
    tgt = rng.uniform(-40, 40, (B, nt, 3)).astype(np.float32)
    tmask = rng.rand(B, nt) > 0.1
    payload = np.ascontiguousarray(np.concatenate(
        [np.where(tmask[:, :, None], tgt, 1e6).transpose(0, 2, 1),
         tmask[:, None, :].astype(np.float32)], axis=1,
    ))
    active = np.array([1, 1], np.int32)
    d8, s8 = kernels.nn_select_batched_mxu(*(torch.from_numpy(x) for x in (q, payload, active)))
    _, rs8 = pk.nn_select_batched_mxu_pallas(
        jnp.asarray(q), jnp.asarray(payload), jnp.asarray(active), interpret=True
    )
    _, s_ex = kernels.nn_select_batched(
        *(torch.from_numpy(x) for x in (q, payload, active)), variant="argmin"
    )
    m8 = np.swapaxes(s8.numpy()[:, :3], -1, -2)
    rm8 = np.swapaxes(np.asarray(rs8)[:, :3], -1, -2)
    m_ex = np.swapaxes(s_ex.numpy()[:, :3], -1, -2)
    d2 = np.sum((q - m8) ** 2, axis=-1)
    rd2 = np.sum((q - rm8) ** 2, axis=-1)
    d2_ex = np.sum((q - m_ex) ** 2, axis=-1)
    assert np.mean(np.all(m8 == rm8, axis=-1)) > 0.99
    assert np.abs(d2 - rd2).max() <= 5e-3
    assert np.all(d2 <= d2_ex + 5e-3)
    assert np.mean(np.all(m8 == m_ex, axis=-1)) > 0.99
    assert (s8[:, 3] == 1.0).all()                       # never a pad column
    # its d2 is the expanded form's, clamped at 0: close to the exact one
    np.testing.assert_allclose(d8.numpy(), d2_ex, rtol=0, atol=5e-3)


def _icp_both(src, smask, tgt, tmask, active, **kw):
    B = src.shape[0]
    got = reg.icp_batched(
        pc.Cloud(torch.from_numpy(src), torch.from_numpy(smask)),
        pc.Cloud(torch.from_numpy(tgt), torch.from_numpy(tmask)),
        se3.identity((B,)), torch.from_numpy(active), **kw,
    )
    ref = jreg.icp_batched(
        jpc.Cloud(jnp.asarray(src), jnp.asarray(smask)),
        jpc.Cloud(jnp.asarray(tgt), jnp.asarray(tmask)),
        jse3.identity((B,)), jnp.asarray(active), **kw,
    )
    return got, ref


def _same_icp(got, ref, gate, rot, trans, fit_rtol, inl_atol):
    fit, rfit = got.fitness.numpy(), np.asarray(ref.fitness)
    np.testing.assert_array_equal(np.isfinite(fit), np.isfinite(rfit))
    np.testing.assert_array_equal(fit < gate, rfit < gate)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    conv = fit < gate
    np.testing.assert_allclose(fit[conv], rfit[conv], rtol=fit_rtol, atol=1e-7)
    np.testing.assert_allclose(got.pose.R.numpy()[conv], np.asarray(ref.pose.R)[conv], rtol=0, atol=rot)
    np.testing.assert_allclose(got.pose.t.numpy()[conv], np.asarray(ref.pose.t)[conv], rtol=0, atol=trans)
    np.testing.assert_allclose(got.inlier_frac.numpy()[conv], np.asarray(ref.inlier_frac)[conv],
                               rtol=0, atol=inl_atol)
    return fit


# each switch: (value, the port's kernel calls it must make, JAX's kernels)
SWITCH_PATHS = {
    "FUSED_ICP": (True, {"icp_moments_batched"}, {"icp_moments_batched_pallas"}),
    "MXU_NN": (True, {"nn_select_batched_mxu", "nn_select_batched:mineq"},
               {"nn_select_batched_mxu_pallas", "nn_select_batched_pallas"}),
    "NN_INDEX": (True, {"nn_index_batched"}, {"nn_index_batched_pallas"}),
    "SELECT_VARIANT": ("argmin", {"nn_select_batched:argmin"}, {"nn_select_batched_pallas"}),
}


@pytest.mark.parametrize("switch", SWITCHES)
def test_icp_batched_under_switch_matches_jax(switch, monkeypatch, tpu_paths, port_calls):
    """``_lanes`` at nq = 1,024, nt = 4,096 and coarse_factor 4, so that the
    path rule holds on both stages; ``reuse_final_fitness`` on (the replay
    default), which the fused and MXU paths do not honour."""
    value, port_kernels, jax_kernels = SWITCH_PATHS[switch]
    _switch(monkeypatch, switch, value)
    src, smask, tgt, tmask, active = _lanes(0, nq=1024, nt=4096)
    got, ref = _icp_both(src, smask, tgt, tmask, active, max_iters=20, max_corr_dist=10.0,
                         tol=1e-4, coarse_factor=4, gate_fitness=0.3, reuse_final_fitness=True)
    fit = _same_icp(got, ref, 0.3, rot=2e-5, trans=5e-4, fit_rtol=1e-4, inl_atol=1e-6)
    assert np.isinf(fit[3]) and (fit[:3] < 0.1).all() and not fit[4] < 0.3
    assert set(port_calls) == port_kernels, dict(port_calls)
    assert set(tpu_paths) == jax_kernels, tpu_paths


def test_fused_switch_off_rule_takes_the_selection_stage(monkeypatch, tpu_paths, port_calls):
    """nq = 512 with coarse_factor 4 puts the coarse stage at 128 x 512,
    which fails the path rule: under ``FUSED_ICP`` both packages take the
    selection stages (coarse, target-stride, full), with no K5. JAX's
    coarse stage then ranks by the expanded form (its CPU fallback), so
    this holds ``test_torch_registration.py``'s tolerances."""
    _switch(monkeypatch, "FUSED_ICP", True)
    stages = {"jax": 0, "port": 0}

    def counting(side, f):
        def stage(*a, **k):
            stages[side] += 1
            return f(*a, **k)
        return stage

    monkeypatch.setattr(jreg, "_icp_stage_batched", counting("jax", jreg._icp_stage_batched))
    monkeypatch.setattr(reg, "_icp_stage_batched", counting("port", reg._icp_stage_batched))
    src, smask, tgt, tmask, active = _lanes(0, nq=512, nt=2048)
    assert reg._tile_shapes_ok(512, 2048) and not reg._tile_shapes_ok(128, 512)
    got, ref = _icp_both(src, smask, tgt, tmask, active, max_iters=20, max_corr_dist=10.0,
                         tol=1e-4, coarse_factor=4, gate_fitness=0.3, target_stride=2,
                         reuse_final_fitness=False)
    _same_icp(got, ref, 0.3, rot=2e-4, trans=2e-3, fit_rtol=2e-3, inl_atol=2e-3)
    assert stages == {"jax": 3, "port": 3}
    assert "icp_moments_batched" not in port_calls and port_calls["nn_select_batched:mineq"] > 0
    assert "icp_moments_batched_pallas" not in tpu_paths


N_FRAMES = 24


def _replay_workload():
    """tests/test_torch_replay.py's revisiting synthetic trajectory."""
    world = kitti.SyntheticWorld(seed=3, extent=120.0, n_clusters=80, pts_per_cluster=800)
    gt = kitti.loop_trajectory(n_frames=N_FRAMES, radius=30.0, revisit=True, laps=1.6)
    scans = [np.asarray(world.scan_at(gt[k], max_points=4096, seed=k)) for k in range(N_FRAMES)]
    return gt[:, :3, :3].astype(np.float32), gt[:, :3, 3].astype(np.float32), scans


def _fused_cfg(mod):
    """test_torch_replay.py's widths with 4,096-point submaps, so that the
    path rule holds on both stages (1,024 x 4,096 and 256 x 1,024)."""
    c = replay_cfg(mod)
    return dataclasses.replace(c, loop=dataclasses.replace(c.loop, submap_capacity=4096))


def test_replay_under_fused_icp_matches_jax(monkeypatch, tpu_paths, port_calls):
    _switch(monkeypatch, "FUSED_ICP", True)
    R, t, scans = _replay_workload()
    stamps = [0.1 * k for k in range(N_FRAMES)]
    kw = dict(apply_gate=False, batch=8, chunk_batches=2)
    jm = JMapper(_fused_cfg(jconfig))
    jout = jm.replay([jse3.Pose(jnp.asarray(R[k]), jnp.asarray(t[k])) for k in range(N_FRAMES)],
                     scans, stamps, **kw)
    m = M.Mapper(_fused_cfg(tconfig), "cpu")
    out = m.replay([se3.Pose(torch.from_numpy(R[k]), torch.from_numpy(t[k])) for k in range(N_FRAMES)],
                   scans, stamps, **kw)
    assert sum(1 for x in jout["loops"] if x) >= 3, "the workload closed too few loops"
    _same_loops(out["loops"], jout["loops"])
    got, ref = state_to_numpy(m.state), state_to_numpy(jm.state)
    nq = int(ref["loop_queue.count"])
    assert int(got["loop_queue.count"]) == nq
    for k in ("loop_queue.i", "loop_queue.j"):
        np.testing.assert_array_equal(got[k][:nq], ref[k][:nq], err_msg=k)
    np.testing.assert_allclose(got["loop_queue.z_t"][:nq], ref["loop_queue.z_t"][:nq], atol=5e-3)
    assert port_calls["icp_moments_batched"] > 0 and set(port_calls) == {"icp_moments_batched"}
    assert set(tpu_paths) == {"icp_moments_batched_pallas"}


def test_ransac_align_batched_under_nn_index_matches_jax(monkeypatch, tpu_paths, port_calls):
    """The fleet RANSAC's exact 1-NN goes through K7 (+ one gather) in both
    packages; with JAX's uniforms injected the correspondences, the samples
    and so every decision are equal."""
    _switch(monkeypatch, "NN_INDEX", True)
    src, smask, tgt, tmask, active = _ransac_lanes()
    B, H, thr = src.shape[0], 64, 0.5
    key = jax.random.PRNGKey(11)
    uniforms = np.asarray(jax.random.uniform(key, (B, H, 3), dtype=jnp.float32))
    seen = {}

    def recording(side, f):
        def matches(*a, **k):
            seen[side] = out = f(*a, **k)
            return out
        return matches

    monkeypatch.setattr(jreg, "_matches_batched", recording("jax", jreg._matches_batched))
    monkeypatch.setattr(reg, "_matches_batched", recording("port", reg._matches_batched))
    kw = dict(num_hypotheses=H, inlier_thresh=thr, min_inlier_ratio=0.3)
    ref = jreg.ransac_align_batched(
        jpc.Cloud(jnp.asarray(src), jnp.asarray(smask)),
        jpc.Cloud(jnp.asarray(tgt), jnp.asarray(tmask)), key, jnp.asarray(active), **kw,
    )
    res = reg.ransac_align_batched(
        pc.Cloud(torch.from_numpy(src), torch.from_numpy(smask)),
        pc.Cloud(torch.from_numpy(tgt), torch.from_numpy(tmask)), 0, 0,
        torch.from_numpy(active), uniforms=torch.from_numpy(uniforms.copy()), **kw,
    )
    _, _, jmatched, jgood = seen["jax"]
    _, _, matched, good = seen["port"]
    np.testing.assert_array_equal(good.numpy(), np.asarray(jgood))
    np.testing.assert_array_equal(matched.numpy()[good.numpy()], np.asarray(jmatched)[np.asarray(jgood)])
    np.testing.assert_array_equal(res.success.numpy(), np.asarray(ref.success))
    assert res.success.tolist() == [True, True, False, False]
    np.testing.assert_array_equal(res.num_inliers.numpy(), np.asarray(ref.num_inliers))
    np.testing.assert_allclose(res.inlier_ratio.numpy(), np.asarray(ref.inlier_ratio), rtol=1e-6)
    np.testing.assert_allclose(res.pose.R.numpy(), np.asarray(ref.pose.R), atol=1e-4)
    np.testing.assert_allclose(res.pose.t.numpy(), np.asarray(ref.pose.t), atol=1e-4)
    assert set(port_calls) == {"nn_index_batched"}
    assert set(tpu_paths) == {"nn_index_batched_pallas"}
