"""Solo and batched ICP of the PyTorch port against the JAX package.

On the CPU the JAX ``_matches_batched`` takes ``vmap(nearest_select)``,
which ranks neighbours by the expanded form |q|^2 - 2 q.t + |t|^2 and
keeps the first index on a tie, while the port's K1 contract ranks by the
exact per-coordinate distance and averages exact ties. The two can pick
different neighbours where two targets are nearly equidistant, and the
expanded form's d2 carries an absolute error of ~eps (|q|^2 + |t|^2)
(measured: 3% of a 0.04 m^2 fitness for a lane 200 m from the origin),
so the lanes here sit within ~40 m of it. The lanes are held on their
decisions (active, under the gate or not, fitness finite, converged), and
the converged lanes' poses and fitness to stated tolerances: rotation
2e-4, translation 2e-3 m (an ICP that stops at tol=1e-4 per update), and
fitness 2e-3 relative + 1e-5 absolute. The hopeless lane stops where its
stall counter trips, so only its decision is compared.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.geometry import so3 as jso3
from scl_slam_tpu.ops import pointcloud as jpc
from scl_slam_tpu.ops import registration as jreg
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.ops import pointcloud as pc
from scl_slam_tpu_torch.ops import registration as reg
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)


def _lanes(seed, B=5, nq=512, nt=2048):
    """Lane 0-2: the source is a noisy subset of the target moved by a
    small rigid offset (converging lanes); lane 3 is inactive; lane 4's
    source is unrelated (a hopeless lane that stalls far above the gate)."""
    rng = np.random.RandomState(seed)
    tgt = np.zeros((B, nt, 3), np.float32)
    src = np.zeros((B, nq, 3), np.float32)
    tmask = np.ones((B, nt), bool)
    smask = np.ones((B, nq), bool)
    for b in range(B):
        # surfaces: a ground plane and walls (structure for ICP to grip)
        n1 = nt // 2
        ground = np.column_stack([rng.uniform(-30, 30, (n1, 2)), rng.normal(0, 0.02, n1)])
        walls = np.column_stack([rng.uniform(-30, 30, nt - n1), rng.choice([-12.0, 15.0], nt - n1), rng.uniform(0, 6, nt - n1)])
        walls[::2, :2] = walls[::2, 1::-1]
        t = np.concatenate([ground, walls]).astype(np.float32) + np.float32([4.0 * b, -3.0 * b, 0.0])
        tgt[b] = t[rng.permutation(nt)]
        w = rng.normal(0, 0.03, 3)
        R = np.asarray(jso3.exp(jnp.asarray(w, jnp.float32)))
        off = rng.normal(0, 0.4, 3).astype(np.float32)
        s = tgt[b, rng.choice(nt, nq, replace=False)] + rng.normal(0, 0.02, (nq, 3))
        c = tgt[b].mean(0)
        src[b] = ((s - c) @ R.T + c + off).astype(np.float32)
    tmask[:, -100:] = False
    tgt[:, -100:] = 1e6
    smask[:, -10:] = False
    src[4] = rng.uniform(-30, 30, (nq, 3)).astype(np.float32) + np.float32([400, 40, 30])
    active = np.array([True, True, True, False, True])
    return src, smask, tgt, tmask, active


@pytest.mark.parametrize("reuse_final_fitness", [True, False])
def test_icp_batched_matches_jax(reuse_final_fitness):
    src, smask, tgt, tmask, active = _lanes(0)
    B = src.shape[0]
    kw = dict(max_iters=20, max_corr_dist=10.0, tol=1e-4, coarse_factor=4,
              gate_fitness=0.3, reuse_final_fitness=reuse_final_fitness)
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
    fit, rfit = got.fitness.numpy(), np.asarray(ref.fitness)
    np.testing.assert_array_equal(np.isfinite(fit), np.isfinite(rfit))
    np.testing.assert_array_equal(fit < 0.3, rfit < 0.3)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert np.isinf(fit[3]) and (fit[:3] < 0.1).all() and fit[4] > 0.3
    conv = fit < 0.3
    np.testing.assert_allclose(fit[conv], rfit[conv], rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(got.pose.R.numpy()[conv], np.asarray(ref.pose.R)[conv], rtol=0, atol=2e-4)
    np.testing.assert_allclose(got.pose.t.numpy()[conv], np.asarray(ref.pose.t)[conv], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got.inlier_frac.numpy()[conv], np.asarray(ref.inlier_frac)[conv], rtol=0, atol=2e-3)


def test_kabsch_matches_jax():
    rng = np.random.RandomState(1)
    src = rng.uniform(-20, 20, (6, 200, 3)).astype(np.float32)
    R = np.asarray(jso3.exp(jnp.asarray(rng.normal(0, 0.5, (6, 3)), jnp.float32)))
    dst = (np.einsum("bij,bnj->bni", R, src) + rng.normal(0, 2, (6, 1, 3))).astype(np.float32)
    w = (rng.rand(6, 200) > 0.3).astype(np.float32)
    got = reg.kabsch(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w))
    ref = jreg.kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.R.numpy(), R, rtol=0, atol=1e-5)


@pytest.mark.parametrize("reuse_final_fitness", [True, False])
def test_icp_solo_matches_jax(reuse_final_fitness):
    """The live path's solo ``icp`` (K4's contract: the lowest index on
    exact ties) against JAX's solo ``icp`` (on the CPU: the expanded-form
    argmin + gather of ``nearest_select``), one converging lane and one
    hopeless lane of the batched test's inputs, with its tolerances."""
    src, smask, tgt, tmask, _ = _lanes(2)
    kw = dict(max_iters=20, max_corr_dist=10.0, tol=1e-4, coarse_factor=4,
              gate_fitness=0.3, reuse_final_fitness=reuse_final_fitness)
    jicp = jax.jit(functools.partial(jreg.icp, **kw))
    for b, converges in ((1, True), (4, False)):
        got = reg.icp(
            pc.Cloud(torch.from_numpy(src[b]), torch.from_numpy(smask[b])),
            pc.Cloud(torch.from_numpy(tgt[b]), torch.from_numpy(tmask[b])), **kw,
        )
        ref = jicp(
            jpc.Cloud(jnp.asarray(src[b]), jnp.asarray(smask[b])),
            jpc.Cloud(jnp.asarray(tgt[b]), jnp.asarray(tmask[b])),
        )
        fit, rfit = float(got.fitness), float(ref.fitness)
        assert (fit < 0.3) == (rfit < 0.3) == converges
        assert bool(got.converged) == bool(ref.converged)
        if converges:
            np.testing.assert_allclose(fit, rfit, rtol=2e-3, atol=1e-5)
            np.testing.assert_allclose(got.pose.R.numpy(), np.asarray(ref.pose.R), rtol=0, atol=2e-4)
            np.testing.assert_allclose(got.pose.t.numpy(), np.asarray(ref.pose.t), rtol=0, atol=2e-3)
            np.testing.assert_allclose(float(got.inlier_frac), float(ref.inlier_frac), atol=2e-3)


def test_nearest_select_matches_jax_on_tie_free_targets():
    """On the CPU JAX's ``nearest_select`` ranks by the expanded form; with
    no near-ties within its error the winners and payload columns equal the
    port's, and d2 agrees to that form's absolute error."""
    rng = np.random.RandomState(3)
    q = rng.uniform(-20, 20, (300, 3)).astype(np.float32)
    payload = np.concatenate(
        [rng.uniform(-20, 20, (3, 2000)), rng.normal(0, 1, (5, 2000))]
    ).astype(np.float32)
    d2, sel = reg.nearest_select(torch.from_numpy(q), torch.from_numpy(payload))
    rd2, rsel = jreg.nearest_select(jnp.asarray(q), jnp.asarray(payload))
    np.testing.assert_allclose(d2.numpy(), np.asarray(rd2), rtol=0, atol=1e-3)
    d_all = ((q[:, None] - payload[:3].T[None]) ** 2).sum(-1)
    part = np.partition(d_all, 1, axis=1)
    clear = part[:, 1] - part[:, 0] > 1e-2
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(sel.numpy()[:, clear], np.asarray(rsel)[:, clear])
