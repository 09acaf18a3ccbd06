"""Kernels K1, K2, K4 and K6 of the PyTorch port against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; those
are held here against the Pallas kernels in interpret mode (as
``tests/test_pallas.py`` runs them) and against the XLA reference. The
wrapper checks and the CUDA kernels themselves are tested in
``test_torch_cuda.py``, which imports no JAX.
"""
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_slam_tpu.ops import pallas_kernels as pk
from scl_slam_tpu.ops.pointcloud import scatter_max_image as jax_scatter_max_image
from scl_slam_tpu_torch.ops import kernels
from test_torch_cuda import TIE_ATOL, image_inputs, nn_inputs, nn_solo_inputs, ransac_inputs

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def release_jax_programs():
    """Drop the compiled JAX programs of earlier test files before a module
    and the module's own after it (the port's JAX-using test files import
    this fixture). Each loaded XLA:CPU executable holds memory maps, an
    xdist worker runs many files in one process, and a process may hold at
    most vm.max_map_count maps (65,530 by default on Linux); past that the
    compile-cache loader segfaults."""
    jax.clear_caches()
    gc.collect()
    yield
    jax.clear_caches()
    gc.collect()


def _nn_contract_numpy(q, payload, active):
    """The K1 contract in numpy: d2 = ((dx*dx) + (dy*dy)) + (dz*dz) with
    every step rounded to f32, payload averaged over exact ties. Also
    returns the second-smallest distinct d2 (to find near-ties) and the
    number of targets tied at the minimum."""
    dx = q[:, :, None, 0] - payload[:, None, 0]
    dy = q[:, :, None, 1] - payload[:, None, 1]
    dz = q[:, :, None, 2] - payload[:, None, 2]
    d2 = ((dx * dx) + (dy * dy)) + (dz * dz)                  # [B, Nq, Nt]
    best = d2.min(-1)
    eq = d2 == best[..., None]
    sel = np.einsum("bqt,bpt->bpq", eq.astype(np.float64), payload) / eq.sum(-1)[:, None]
    second = np.where(eq, np.inf, d2).min(-1)
    lanes = active.astype(bool)
    best = np.where(lanes[:, None], best, np.inf).astype(np.float32)
    sel = np.where(lanes[:, None, None], sel, 0.0).astype(np.float32)
    return best, sel, second, eq.sum(-1)


@pytest.mark.parametrize("nt", [1024, 2048])
def test_k1_plain_matches_contract_and_pallas_interpret(nt):
    """d2 is bit-equal to the contract computed in numpy. Against the
    Pallas kernel in interpret mode d2 agrees to 2 ulp (rtol 2**-22):
    XLA:CPU does not keep the kernel's rounding order for the three
    multiply-adds (some are contracted or reordered), which the TPU
    kernel and the CUDA kernel both do. sel equals the interpret-mode
    kernel's wherever no other target lies within that 2 ulp."""
    B, nq = 3, 256
    q, payload, active = nn_inputs(1, B, nq, nt)
    d, sel = kernels.nn_select_batched(
        torch.from_numpy(q), torch.from_numpy(payload), torch.from_numpy(active)
    )
    d, sel = d.numpy(), sel.numpy()
    d_np, sel_np, second, ties = _nn_contract_numpy(q, payload, active)
    np.testing.assert_array_equal(d, d_np)
    np.testing.assert_allclose(sel, sel_np, rtol=0, atol=TIE_ATOL)

    d_ref, sel_ref = pk.nn_select_batched_pallas(
        jnp.asarray(q), jnp.asarray(payload), jnp.asarray(active), interpret=True
    )
    d_ref, sel_ref = np.asarray(d_ref), np.asarray(sel_ref)
    np.testing.assert_allclose(d, d_ref, rtol=2.0**-22, atol=0)
    clear = (second > d_np * (1 + 2.0**-21)) & active.astype(bool)[:, None]
    assert clear[active.astype(bool)].mean() > 0.99
    np.testing.assert_allclose(
        np.swapaxes(sel, 1, 2)[clear], np.swapaxes(sel_ref, 1, 2)[clear],
        rtol=0, atol=TIE_ATOL,
    )
    # the inactive lane and the planted ties really happened
    assert np.all(np.isinf(d[1])) and np.all(sel[1] == 0)
    n_tie = min(nt // 3, nq)
    assert np.all(d[2, :n_tie] == 1.0)
    # x averages c-1, c+1, c to c exactly; y averages c, c, c+1 to c + 1/3
    np.testing.assert_array_equal(sel[2, 0, :n_tie], q[2, :n_tie, 0])
    np.testing.assert_allclose(sel[2, 1, :n_tie], q[2, :n_tie, 1] + 1 / 3, rtol=1e-6)
    # three of every four lane-0 targets are copies of one point, so many
    # nearest points tie three ways (fl(3x) / 3 need not give x back,
    # hence TIE_ATOL above)
    assert np.isin(ties[0], [1, 3]).all() and (ties[0] == 3).mean() > 0.3
    assert np.all(ties[2, :n_tie] >= 3)


def test_k1_plain_chunking_is_invisible():
    """The plain version walks the target in chunks; any chunk size gives
    the same d2 bits and the same selection."""
    q, payload, active = nn_inputs(2, 3, 256, 1024)
    args = (torch.from_numpy(q), torch.from_numpy(payload), torch.from_numpy(active))
    d_all, sel_all = kernels.nn_select_batched_plain(*args, chunk=1024)
    for chunk in (1, 100, 333):
        d, sel = kernels.nn_select_batched_plain(*args, chunk=chunk)
        assert torch.equal(d, d_all)
        torch.testing.assert_close(sel, sel_all, rtol=0, atol=TIE_ATOL)


def test_k2_plain_bit_equal_to_scatter_max_image():
    B, n, R, S = 2, 8192, 20, 60
    z, ring, sector, valid = image_inputs(3, B, n, R, S)
    img = kernels.max_image(
        torch.from_numpy(z), torch.from_numpy(ring), torch.from_numpy(sector),
        torch.from_numpy(valid), R, S,
    ).numpy()
    for b in range(B):
        ref = np.asarray(
            jax_scatter_max_image(
                jnp.asarray(z[b]), jnp.asarray(ring[b]), jnp.asarray(sector[b]),
                jnp.asarray(valid[b]), R, S, init=0.0,
            )
        )
        np.testing.assert_array_equal(img[b], ref)
    assert np.all(img[:, 0, 0] == 0.0)


def test_k2_plain_within_quantization_of_max_image_pallas():
    """The TPU kernel quantizes to span / 9**4 below the true maximum."""
    n, R, S = pk.MB_T, 20, 60
    z, ring, sector, valid = image_inputs(4, 1, n, R, S)
    img = kernels.max_image(
        torch.from_numpy(z), torch.from_numpy(ring), torch.from_numpy(sector),
        torch.from_numpy(valid), R, S,
    ).numpy()[0]
    tpu = np.asarray(
        pk.max_image_pallas(
            jnp.asarray(z[0]), jnp.asarray(ring[0]), jnp.asarray(sector[0]),
            jnp.asarray(valid[0]), R, S, interpret=True,
        )
    )
    slot = 64.0 / pk.MB_K**pk.MB_PASSES
    assert np.all(tpu <= img + 1e-5)
    assert np.all(img - tpu <= slot + 1e-4)


def _nn_solo_contract_numpy(q, payload):
    """The K4 contract in numpy: d2 = ((dx*dx) + (dy*dy)) + (dz*dz) with
    every step rounded to f32, the lowest target index among exact ties.
    Also returns the second-smallest distinct d2 (to find near-ties)."""
    dx = q[:, None, 0] - payload[None, 0]
    dy = q[:, None, 1] - payload[None, 1]
    dz = q[:, None, 2] - payload[None, 2]
    d2 = ((dx * dx) + (dy * dy)) + (dz * dz)                  # [Nq, Nt]
    idx = d2.argmin(-1)                                       # first minimum
    best = d2[np.arange(len(q)), idx]
    second = np.where(d2 == best[:, None], np.inf, d2).min(-1)
    return best, payload[:, idx], second, (d2 == best[:, None]).sum(-1)


@pytest.mark.parametrize("P", [4, 8])
def test_k4_plain_matches_contract_and_pallas_interpret(P):
    """d2 bit-equal and the selection exactly equal to the contract computed
    in numpy, planted exact ties included (the lowest index wins). Against
    the Pallas kernel in interpret mode d2 agrees to 2 ulp (rtol 2**-22,
    the rounding-order difference of XLA:CPU described for K1), and the
    selection is equal wherever no other target lies within that 2 ulp."""
    nq, nt = 256, 2048
    q, payload, n_grid = nn_solo_inputs(10 + P, nq, nt, P)
    d, sel = kernels.nn_select(torch.from_numpy(q), torch.from_numpy(payload))
    d, sel = d.numpy(), sel.numpy()
    d_np, sel_np, second, ties = _nn_solo_contract_numpy(q, payload)
    np.testing.assert_array_equal(d, d_np)
    np.testing.assert_array_equal(sel, sel_np)
    assert (ties > 1).sum() > 20, "too few exact ties planted"
    # grid queries at unit distance from two distinct targets (where no
    # random target is nearer) take the lower index: c - e_x
    on_grid = d[:n_grid] == 1.0
    assert on_grid.sum() > 5
    np.testing.assert_array_equal(sel[0, :n_grid][on_grid], q[:n_grid, 0][on_grid] - 1.0)

    d_ref, sel_ref = pk.nn_select_pallas(
        jnp.asarray(q), jnp.asarray(payload), interpret=True
    )
    d_ref, sel_ref = np.asarray(d_ref), np.asarray(sel_ref)
    np.testing.assert_allclose(d, d_ref, rtol=2.0**-22, atol=0)
    clear = (second > d_np * (1 + 2.0**-21)) | (d_np == 1.0)
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(sel[:, clear], sel_ref[:, clear])


def test_k4_plain_chunking_no_target_and_nan():
    """Any chunk size gives the same bits; a query with no finite distance
    (no target, or NaN) keeps (inf, 0), as the kernel's strict < does."""
    q, payload, _ = nn_solo_inputs(3, 100, 777, 8)
    args = (torch.from_numpy(q), torch.from_numpy(payload))
    d_all, sel_all = kernels.nn_select_plain(*args, chunk=777)
    for chunk in (1, 64, 500):
        d, sel = kernels.nn_select_plain(*args, chunk=chunk)
        assert torch.equal(d, d_all) and torch.equal(sel, sel_all)
    qn = args[0].clone()
    qn[5] = float("nan")
    d, sel = kernels.nn_select(qn, args[1])
    assert torch.isinf(d[5]) and (sel[:, 5] == 0).all()
    assert torch.equal(d[:5], d_all[:5]) and torch.equal(sel[:, 6:], sel_all[:, 6:])
    d, sel = kernels.nn_select(args[0], args[1][:, :0])
    assert torch.isinf(d).all() and sel.shape == (8, 100) and (sel == 0).all()


def _ransac_res2_numpy(src, matched, R, t):
    """res2 [B, H, N] of the K6 contract in numpy, every step rounded to
    f32 in the contract's order."""
    x, y, z = (src[:, None, :, c] for c in range(3))
    res2 = np.zeros(R.shape[:2] + src.shape[1:2], np.float32)
    for i in range(3):
        m = ((R[..., i, 0, None] * x + R[..., i, 1, None] * y) + R[..., i, 2, None] * z) + t[..., i, None]
        d = m - matched[:, None, :, i]
        res2 = res2 + d * d
    return res2


def _jax_slab_counts(src, matched, good, R, t, thr2):
    """The XLA scoring slab of ``registration.ransac_align_batched`` (its
    ``chunk_counts``, one chunk), as the JAX package runs it on the CPU."""
    sx, sy, sz = (jnp.asarray(src[..., i]) for i in range(3))
    Rc, tc, mt = jnp.asarray(R), jnp.asarray(t), jnp.asarray(matched)

    @jax.jit
    def counts():
        res2 = 0.0
        for i in range(3):
            mi = (
                Rc[..., i, 0][:, :, None] * sx[:, None, :]
                + Rc[..., i, 1][:, :, None] * sy[:, None, :]
                + Rc[..., i, 2][:, :, None] * sz[:, None, :]
                + tc[..., i][:, :, None]
            )
            res2 = res2 + jnp.square(mi - mt[..., i][:, None, :])
        return jnp.sum((res2 < thr2) & jnp.asarray(good)[:, None, :], axis=-1).astype(jnp.int32)

    return np.asarray(counts())


def test_k6_plain_matches_contract_pallas_interpret_and_slab():
    """K6's plain version equals the contract computed in numpy. Against the
    Pallas kernel in interpret mode and against the JAX package's XLA slab
    the counts are equal, or differ by at most the number of good points
    whose res2 lies within 4 ulp of thr2 (XLA:CPU may contract the
    transform's multiply-adds, which the TPU kernel and the CUDA kernel do
    not): the test counts those points per hypothesis. The planted
    on-threshold points (res2 == thr2 exactly) are out on every side."""
    B, H, N = 3, 16, 256  # the Pallas kernel needs H % 8 == 0, N % 128 == 0
    src, matched, good, R, t, thr2 = ransac_inputs(21, B, H, N)
    counts = kernels.ransac_counts_batched(
        *(torch.from_numpy(x) for x in (src, matched, good, R, t)), thr2
    ).numpy()
    res2 = _ransac_res2_numpy(src, matched, R, t)
    contract = ((res2 < np.float32(thr2)) & good[:, None, :]).sum(-1)
    np.testing.assert_array_equal(counts, contract)
    assert counts.dtype == np.int32 and (counts[1] == 0).all()
    q = N // 4
    assert (res2[0, 0, :q] == np.float32(thr2)).all() and (res2[0, 0, q : 2 * q] < thr2).all()
    assert counts[0].max() > 0 and counts[2].min() > 0 and (counts[2] < good[2].sum()).all()
    ulp = np.spacing(np.float32(thr2))
    near = ((np.abs(res2 - np.float32(thr2)) <= 4 * ulp) & good[:, None, :]).sum(-1)
    near[0, 0] = 0  # the identity rows are exact on every side

    src4 = np.concatenate([np.swapaxes(src, 1, 2), good[:, None].astype(np.float32)], 1)
    mt4 = np.concatenate([np.swapaxes(matched, 1, 2), np.zeros((B, 1, N), np.float32)], 1)
    rows = np.zeros((B, H, 128), np.float32)
    rows[..., :9] = R.reshape(B, H, 9)
    rows[..., 9:12] = t
    pallas = np.asarray(pk.ransac_counts_batched_pallas(
        jnp.asarray(src4), jnp.asarray(mt4), jnp.asarray(rows), thr2, interpret=True
    ))
    slab = _jax_slab_counts(src, matched, good, R, t, thr2)
    for ref in (pallas, slab):
        assert (np.abs(counts - ref) <= near).all(), (counts - ref, near)
        assert ref[0, 0] == counts[0, 0]


def test_k6_plain_chunking_and_edges():
    """Any hypothesis chunk gives the same counts; H = 0 and N = 0 give
    empty and zero counts."""
    args = [torch.from_numpy(x) for x in ransac_inputs(5, 2, 13, 300)[:5]]
    full = kernels.ransac_counts_batched_plain(*args, 0.0625, chunk=13)
    for chunk in (1, 4, 7):
        assert torch.equal(kernels.ransac_counts_batched_plain(*args, 0.0625, chunk=chunk), full)
    src, matched, good, R, t = args
    assert kernels.ransac_counts_batched(src, matched, good, R[:, :0], t[:, :0], 1.0).shape == (2, 0)
    empty = kernels.ransac_counts_batched(src[:, :0], matched[:, :0], good[:, :0], R, t, 1.0)
    assert empty.shape == (2, 13) and (empty == 0).all()
