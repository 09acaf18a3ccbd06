"""Kernel wrappers of the PyTorch port, without JAX.

This file imports neither JAX nor the JAX package, so that on a machine
with a card and no JAX it runs on its own (``tests/conftest.py`` imports
JAX, hence ``--noconftest``; ``-o addopts=`` drops the suite's xdist
options):

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts= -q

The ``cuda`` tests launch the CUDA kernels and hold them against their
plain PyTorch versions on the card; they skip without one. The input
makers here are shared with ``test_torch_kernels.py``, which holds the
plain versions against the JAX package.
"""
import numpy as np
import pytest
import torch

from scl_slam_tpu_torch.ops import kernels

torch.set_num_threads(2)

# Payload values of nn_inputs are |x| <= 4 * 20 + 1 (or 1e6 pads, never
# nearest); a tie average of distinct points may be summed in another
# order than the reference's: allowed 2 ulp at 2**7, i.e. 2 * 2**-16.
TIE_ATOL = 2 * 2.0**-16


def nn_inputs(seed, B, nq, nt):
    """Random lanes with exact ties planted on purpose: lane 0 duplicates
    target points (identical payload ties), lane 2 puts integer-coordinate
    queries at unit distance from several distinct integer targets
    (equidistant distinct points, where the payload average is a real
    mean); lane 1 is inactive."""
    rng = np.random.RandomState(seed)
    q = rng.uniform(-30, 30, (B, nq, 3)).astype(np.float32)
    t = rng.uniform(-30, 30, (B, nt, 3)).astype(np.float32)
    valid = rng.rand(B, nt) > 0.1
    # lane 0: every query's nearest point appears three times
    t[0, 1::4] = t[0, 0::4]
    t[0, 2::4] = t[0, 0::4]
    valid[0, 1::4] = valid[0, 0::4]
    valid[0, 2::4] = valid[0, 0::4]
    # lane 2: integer grid; query k at c_k, targets at c_k +- e_x, c_k + e_y
    c = rng.randint(-20, 20, (nq, 3)).astype(np.float32) * 4.0
    q[2] = c
    n_tie = min(nt // 3, nq)
    t[2, :n_tie] = c[:n_tie] + np.float32([1, 0, 0])
    t[2, n_tie : 2 * n_tie] = c[:n_tie] - np.float32([1, 0, 0])
    t[2, 2 * n_tie : 3 * n_tie] = c[:n_tie] + np.float32([0, 1, 0])
    valid[2, : 3 * n_tie] = True
    t[2, 3 * n_tie :] += 500.0  # keep lane 2's other targets out of the way
    t = np.where(valid[..., None], t, 1e6).astype(np.float32)
    payload = np.concatenate(
        [np.swapaxes(t, -1, -2), valid[:, None].astype(np.float32)], axis=1
    )
    active = np.array([1, 0, 1] + [1] * (B - 3), np.int32)
    return q, np.ascontiguousarray(payload), active


def nn_solo_inputs(seed, nq, nt, P=4):
    """One query set and a [P, Nt] payload with exact ties planted: every
    4th target is duplicated at the next index (identical points, where
    the lowest index must win), a quarter of the queries sit on an integer
    grid at unit distance from two distinct integer targets (equidistant
    distinct points), and ~5% of the targets are invalid pads. Rows 4.. of
    the payload (P = 8: normals and the like) are random."""
    rng = np.random.RandomState(seed)
    t = rng.uniform(-30, 30, (nt, 3)).astype(np.float32)
    valid = rng.rand(nt) > 0.05
    pick = rng.randint(0, nt, nq)
    q = (t[pick] + rng.normal(0, 0.3, (nq, 3))).astype(np.float32)
    t[1::4] = t[0::4][: len(t[1::4])]
    valid[1::4] = valid[0::4][: len(valid[1::4])]
    n_grid = min(nq // 4, nt // 8)
    c = rng.randint(-7, 7, (n_grid, 3)).astype(np.float32) * 4.0
    q[:n_grid] = c
    hi = nt - 2 * n_grid
    t[hi : hi + n_grid] = c - np.float32([1, 0, 0])   # the lower index wins
    t[hi + n_grid :] = c + np.float32([0, 1, 0])
    valid[hi:] = True
    t = np.where(valid[:, None], t, 1e6).astype(np.float32)
    extra = rng.normal(0, 1, (P - 3, nt)).astype(np.float32)
    extra[0] = valid
    payload = np.concatenate([t.T, extra], axis=0)
    return q, np.ascontiguousarray(payload), n_grid


def image_inputs(seed, B, n, R=20, S=60):
    rng = np.random.RandomState(seed)
    ring = rng.randint(0, R, (B, n)).astype(np.int32)
    sector = rng.randint(0, S, (B, n)).astype(np.int32)
    z = rng.uniform(-2, 40, (B, n)).astype(np.float32)
    valid = rng.rand(B, n) > 0.1
    # some bins see only negative values and must read 0
    z[:, :64] = -np.abs(z[:, :64]) - 0.5
    ring[:, :64], sector[:, :64] = 0, 0
    z[:, 64:] = np.where((ring[:, 64:] == 0) & (sector[:, 64:] == 0), -1.0, z[:, 64:])
    return z, ring, sector, valid


def test_wrappers_take_plain_path_on_cpu_and_count_no_launch():
    kernels.reset_launch_counts()
    q, payload, active = nn_inputs(5, 3, 64, 256)
    kernels.nn_select_batched(
        torch.from_numpy(q), torch.from_numpy(payload), torch.from_numpy(active)
    )
    z, ring, sector, valid = image_inputs(6, 1, 512)
    kernels.max_image(
        torch.from_numpy(z), torch.from_numpy(ring), torch.from_numpy(sector),
        torch.from_numpy(valid), 20, 60,
    )
    q, payload, _ = nn_solo_inputs(6, 64, 256)
    kernels.nn_select(torch.from_numpy(q), torch.from_numpy(payload))
    assert kernels.LAUNCHES == {"nn_select_batched": 0, "max_image": 0, "nn_select": 0}


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(2, 8, 3)
    with pytest.raises(ValueError):
        kernels.nn_select_batched(q, torch.zeros(2, 4, 16, dtype=torch.float64), torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError):
        kernels.nn_select_batched(q, torch.zeros(3, 4, 16), torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError):  # a batched query
        kernels.nn_select(q, torch.zeros(4, 16))
    with pytest.raises(ValueError):  # fewer than 3 payload rows
        kernels.nn_select(q[0], torch.zeros(2, 16))
    z = torch.zeros(1, 16)
    with pytest.raises(ValueError):
        kernels.max_image(z, torch.zeros(1, 16, dtype=torch.int64), torch.zeros(1, 16, dtype=torch.int32), torch.ones(1, 16, dtype=torch.bool), 20, 60)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1_cuda_kernel_matches_plain(cuda_device):
    kernels.reset_launch_counts()
    for nq, nt in ((256, 2048), (1000, 3000)):
        q, payload, active = nn_inputs(7, 5, nq, nt)
        args = [torch.from_numpy(x).to(cuda_device) for x in (q, payload, active)]
        d, sel = kernels.nn_select_batched(*args)
        d_ref, sel_ref = kernels.nn_select_batched_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(d, d_ref)
        torch.testing.assert_close(sel, sel_ref, rtol=0, atol=TIE_ATOL)
    assert kernels.LAUNCHES["nn_select_batched"] == 2


@pytest.mark.cuda
def test_k2_cuda_kernel_matches_plain(cuda_device):
    kernels.reset_launch_counts()
    z, ring, sector, valid = image_inputs(8, 4, 65536)
    args = [torch.from_numpy(x).to(cuda_device) for x in (z, ring, sector, valid)]
    img = kernels.max_image(*args, 20, 60)
    ref = kernels.max_image_plain(*args, 20, 60)
    torch.cuda.synchronize()
    assert torch.equal(img, ref)
    assert kernels.LAUNCHES["max_image"] == 1


@pytest.mark.cuda
def test_k4_cuda_kernel_matches_plain(cuda_device):
    """d2 bit-equal and the selection equal (lowest index on exact ties) at
    the live path's ICP shapes, at P = 8, and at ragged sizes."""
    kernels.reset_launch_counts()
    shapes = ((256, 4096, 4), (1024, 16384, 4), (1024, 16384, 8), (1000, 3001, 4), (7, 50, 4))
    for nq, nt, P in shapes:
        q, payload, _ = nn_solo_inputs(nq + P, nq, nt, P)
        args = [torch.from_numpy(x).to(cuda_device) for x in (q, payload)]
        d, sel = kernels.nn_select(*args)
        d_ref, sel_ref = kernels.nn_select_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(d, d_ref)
        assert torch.equal(sel, sel_ref)
    assert kernels.LAUNCHES["nn_select"] == len(shapes)
