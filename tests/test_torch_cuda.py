"""Kernel wrappers of the PyTorch port, without JAX.

This file imports neither JAX nor the JAX package, so that on a machine
with a card and no JAX it runs on its own (``tests/conftest.py`` imports
JAX, hence ``--noconftest``; ``-o addopts=`` drops the suite's xdist
options):

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts= -q

The ``cuda`` tests launch the CUDA kernels (K1 with both bodies, K2-K8)
and hold them against their plain PyTorch versions on the card; they
skip without one. The input
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


def _rodrigues(w):
    th = np.linalg.norm(w)
    if th == 0:
        return np.eye(3)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def ransac_inputs(seed, B, H, N, thr=0.25):
    """K6 inputs. Lane b's matched points are its source points under a
    random pose plus noise, and its hypotheses are that pose perturbed, so
    each hypothesis has inliers and outliers; ~10% of the points are not
    good and lane 1 has no good point. Planted on the threshold: lane 0's
    source is an integer grid, its hypothesis 0 the identity, and a
    quarter of its matched points sit exactly ``thr`` away (res2 == thr2
    exactly: not inliers), a quarter just inside. Returns (source,
    matched, good, R [B, H, 3, 3], t [B, H, 3], thr2)."""
    rng = np.random.RandomState(seed)
    src = rng.uniform(-30, 30, (B, N, 3)).astype(np.float32)
    src[0] = np.round(src[0])
    R = np.empty((B, H, 3, 3), np.float32)
    t = np.empty((B, H, 3), np.float32)
    matched = np.empty_like(src)
    for b in range(B):
        Rb, tb = _rodrigues(rng.normal(0, 0.3, 3)), rng.uniform(-5, 5, 3)
        matched[b] = src[b] @ Rb.T + tb + rng.normal(0, 0.2, (N, 3))
        for h in range(H):
            R[b, h] = _rodrigues(rng.normal(0, 0.01, 3)) @ Rb
            t[b, h] = tb + rng.normal(0, 0.1, 3)
    R[0, 0], t[0, 0] = np.eye(3), 0.0
    q = N // 4
    matched[0, :q] = src[0, :q] + np.float32([thr, 0, 0])
    matched[0, q : 2 * q] = src[0, q : 2 * q] + np.float32([thr * (1 - 2.0**-10), 0, 0])
    good = rng.rand(B, N) > 0.1
    if B > 1:
        good[1] = False
    thr2 = thr * thr
    return src, matched.astype(np.float32), good, R, t, thr2


def moments_inputs(seed, B, nq, nt, device="cpu"):
    """K5 inputs as tensors: nn_inputs' lanes (planted exact ties, lane 1
    inactive) as the target; the source is a noisy copy of target points,
    in the lane's local frame, ~10% invalid; a random pose per lane
    (rotation up to ~0.3 rad, 5 m) that maps it back near its targets.
    Returns (src4 [B, 4, Nq], payload [B, 4, Nt], R [B, 3, 3], t [B, 3],
    active [B])."""
    _, payload, active = nn_inputs(seed, B, nq, nt)
    rng = np.random.RandomState(seed + 1)
    R = np.stack([_rodrigues(rng.normal(0, 0.15, 3)) for _ in range(B)]).astype(np.float32)
    t = rng.uniform(-5, 5, (B, 3)).astype(np.float32)
    pick = rng.randint(0, nt, (B, nq))
    world = np.take_along_axis(np.swapaxes(payload[:, :3], 1, 2), pick[..., None], 1)
    world = np.where(np.abs(world) < 1e5, world, 0.0) + rng.normal(0, 0.2, (B, nq, 3))
    local = np.einsum("bji,bnj->bni", R, world - t[:, None])   # R^T (x - t)
    valid = rng.rand(B, nq) > 0.1
    src4 = np.concatenate([np.swapaxes(local, 1, 2), valid[:, None]], axis=1).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (src4, payload, R, t, active))


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
    d, idx = kernels.nearest_neighbors(torch.from_numpy(q), torch.from_numpy(payload[:3].T.copy()))
    assert torch.equal(d, kernels.nearest_neighbors_plain(torch.from_numpy(q), torch.from_numpy(payload[:3].T.copy()))[0])
    assert idx.dtype == torch.int32
    args = [torch.from_numpy(x) for x in ransac_inputs(9, 3, 5, 40)[:5]]
    counts = kernels.ransac_counts_batched(*args, 0.0625)
    assert counts.dtype == torch.int32 and counts.shape == (3, 5)
    assert torch.equal(counts, kernels.ransac_counts_batched_plain(*args, 0.0625))
    q, payload, active = (torch.from_numpy(x) for x in nn_inputs(5, 3, 64, 256))
    d, sel = kernels.nn_select_batched(q, payload, active, variant="argmin")
    assert torch.equal(sel, kernels.nn_select_batched_plain(q, payload, active, "argmin")[1])
    d7, idx = kernels.nn_index_batched(q, payload, active)
    assert torch.equal(d7, d) and idx.dtype == torch.int32
    d8, sel8 = kernels.nn_select_batched_mxu(q, payload, active)
    assert torch.equal(sel8, kernels.nn_select_batched_mxu_plain(q, payload, active)[1])
    src4, payload, R, t, active = moments_inputs(8, 3, 64, 256)
    m = kernels.icp_moments_batched(src4, payload, R, t, active, 5.0)
    assert m.shape == (3, kernels.M_SLOTS) and (m[1] == 0).all()
    assert torch.equal(m, kernels.icp_moments_batched_plain(src4, payload, R, t, active, 5.0))
    assert kernels.LAUNCHES == {
        "nn_select_batched": 0, "max_image": 0, "nn_select": 0, "nearest_neighbors": 0,
        "ransac_counts_batched": 0, "nn_select_batched_argmin": 0, "nn_index_batched": 0,
        "nn_select_batched_mxu": 0, "icp_moments_batched": 0,
    }


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
    with pytest.raises(ValueError):  # K3: a batched query
        kernels.nearest_neighbors(q, torch.zeros(16, 3))
    with pytest.raises(ValueError):  # K3: a [3, Nt] target
        kernels.nearest_neighbors(q[0], torch.zeros(3, 16))
    with pytest.raises(ValueError):  # K3: float64
        kernels.nearest_neighbors(q[0].double(), torch.zeros(16, 3, dtype=torch.float64))
    src = torch.zeros(2, 8, 3)
    good = torch.ones(2, 8, dtype=torch.bool)
    R, t = torch.zeros(2, 4, 3, 3), torch.zeros(2, 4, 3)
    with pytest.raises(ValueError):  # K6: good not bool
        kernels.ransac_counts_batched(src, src, good.float(), R, t, 1.0)
    with pytest.raises(ValueError):  # K6: matched of another shape
        kernels.ransac_counts_batched(src, src[:, :4], good, R, t, 1.0)
    with pytest.raises(ValueError):  # K6: t of another hypothesis count
        kernels.ransac_counts_batched(src, src, good, R, t[:, :3], 1.0)
    with pytest.raises(ValueError):  # K1: an unknown body
        kernels.nn_select_batched(q, torch.zeros(2, 4, 16), torch.ones(2, dtype=torch.bool), "first")
    with pytest.raises(ValueError):  # K7: a query of 2 coordinates
        kernels.nn_index_batched(q[..., :2], torch.zeros(2, 4, 16), torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError):  # K8: active of another lane count
        kernels.nn_select_batched_mxu(q, torch.zeros(2, 4, 16), torch.ones(3, dtype=torch.bool))
    src4, payload, R, t, active = moments_inputs(9, 3, 8, 16)
    with pytest.raises(ValueError):  # K5: the TPU kernel's 128-lane pose rows
        kernels.icp_moments_batched(src4, payload, torch.zeros(3, 128), t, active, 1.0)
    with pytest.raises(ValueError):  # K5: a source without its validity row
        kernels.icp_moments_batched(src4[:, :3], payload, R, t, active, 1.0)
    with pytest.raises(ValueError):  # K5: an unknown body
        kernels.icp_moments_batched(src4, payload, R, t, active, 1.0, variant="first")
    z = torch.zeros(1, 16)
    with pytest.raises(ValueError):
        kernels.max_image(z, torch.zeros(1, 16, dtype=torch.int64), torch.zeros(1, 16, dtype=torch.int32), torch.ones(1, 16, dtype=torch.bool), 20, 60)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def tie_heavy(payload, lane):
    """Make one lane's targets full of ties: every target is one of two
    points, so each query ties with half the targets, and a query at
    (4, 8, 13), at unit distance from both, with all of them."""
    out = payload.copy()
    out[lane, :3] = np.float32([[4.0], [8.0], [12.0]])
    out[lane, 2, 1::2] = 14.0
    out[lane, 3] = 1.0
    return out


# the split kernels' ragged cases: nq off a query tile, nt off a shared
# memory tile, a single target (csrc/nn_split.cuh)
K1_SHAPES = ((5, 256, 2048), (5, 1000, 3000), (3, 37, 1000), (4, 5, 1), (32, 1024, 8192))


@pytest.mark.cuda
def test_k1_cuda_kernel_matches_plain(cuda_device):
    """The tie average: d2 bit-equal, the selection within TIE_ATOL, at the
    replay path's shapes and ragged ones, with a lane full of ties; then a
    batch of inactive lanes only (inf, 0)."""
    kernels.reset_launch_counts()
    for B, nq, nt in K1_SHAPES:
        q, payload, active = nn_inputs(7 + nt, max(B, 3), nq, max(nt, 3))
        payload = tie_heavy(payload[..., :nt], 0)
        q[0, :4] = np.float32([4.0, 8.0, 13.0])
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
                for x in (q[:B], payload[:B], active[:B])]
        d, sel = kernels.nn_select_batched(*args)
        d_ref, sel_ref = kernels.nn_select_batched_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(d, d_ref)
        torch.testing.assert_close(sel, sel_ref, rtol=0, atol=TIE_ATOL)
        assert torch.isinf(d[1]).all() and (sel[1] == 0).all()
        assert (d[0, :4] == 1.0).all()
        if nt % 2 == 0:  # as many targets at z = 12 as at z = 14
            assert (sel[0, 2, :4] == 13.0).all()
    d, sel = kernels.nn_select_batched(args[0], args[1], torch.zeros_like(args[2]))
    assert torch.isinf(d).all() and (sel == 0).all()
    assert kernels.LAUNCHES["nn_select_batched"] == len(K1_SHAPES) + 1


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
    shapes = ((256, 4096, 4), (1024, 16384, 4), (1024, 16384, 8), (1000, 3001, 4), (7, 50, 4),
              (37, 1, 4), (130, 257, 8))
    for nq, nt, P in shapes:
        q, payload, _ = nn_solo_inputs(nq + P, nq, nt, P)
        args = [torch.from_numpy(x).to(cuda_device) for x in (q, payload)]
        d, sel = kernels.nn_select(*args)
        d_ref, sel_ref = kernels.nn_select_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(d, d_ref)
        assert torch.equal(sel, sel_ref)
    # every target identical: the lowest index (0) wins every query
    ties = torch.ones((4, 5000), device=cuda_device)
    ties[3] = torch.arange(5000, device=cuda_device)
    d, sel = kernels.nn_select(args[0], ties)
    assert torch.equal(d, kernels.nn_select_plain(args[0], ties)[0]) and (sel[3] == 0).all()
    assert kernels.LAUNCHES["nn_select"] == len(shapes) + 1


@pytest.mark.cuda
def test_k3_cuda_kernel_matches_plain(cuda_device):
    """d2 bit-equal and the index equal (lowest index on exact ties; PAD
    targets; no target gives (inf, 0)) at the verification shapes and at
    ragged sizes."""
    kernels.reset_launch_counts()
    shapes = ((256, 4096), (4096, 8192), (1000, 3001), (7, 50), (37, 1), (130, 257))
    for nq, nt in shapes:
        q, payload, _ = nn_solo_inputs(nq + 3, nq, nt, 4)
        target = np.ascontiguousarray(payload[:3].T)
        args = [torch.from_numpy(x).to(cuda_device) for x in (q, target)]
        d, idx = kernels.nearest_neighbors(*args)
        d_ref, idx_ref = kernels.nearest_neighbors_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(d, d_ref)
        assert torch.equal(idx, idx_ref)
    ties = torch.ones((5000, 3), device=cuda_device)  # every target identical
    d, idx = kernels.nearest_neighbors(args[0], ties)
    assert torch.equal(d, kernels.nearest_neighbors_plain(args[0], ties)[0]) and (idx == 0).all()
    assert kernels.LAUNCHES["nearest_neighbors"] == len(shapes) + 1
    d, idx = kernels.nearest_neighbors(args[0], args[1][:0])
    assert torch.isinf(d).all() and (idx == 0).all()


@pytest.mark.cuda
def test_k6_cuda_kernel_matches_plain(cuda_device):
    """Counts equal to the plain version's at the fleet's shape (16 lanes x
    256 hypotheses x 1,024 points), at a full keyframe (4,096 points) and
    at ragged sizes, with points planted exactly on the threshold and a
    lane without a good point."""
    kernels.reset_launch_counts()
    shapes = ((16, 256, 1024), (16, 256, 4096), (3, 37, 1000), (2, 1, 1))
    for B, H, N in shapes:
        src, matched, good, R, t, thr2 = ransac_inputs(B + H + N, B, H, N)
        args = [torch.from_numpy(x).to(cuda_device) for x in (src, matched, good, R, t)]
        counts = kernels.ransac_counts_batched(*args, thr2)
        ref = kernels.ransac_counts_batched_plain(*args, thr2)
        torch.cuda.synchronize()
        assert torch.equal(counts, ref)
        if B > 1:
            assert (counts[1] == 0).all()
        if N >= 4:
            # the identity hypothesis on lane 0's first half: the points
            # exactly on the threshold are out, those just inside are in
            q = N // 4
            half = kernels.ransac_counts_batched(
                *(a[:1, : 2 * q].contiguous() for a in args[:3]),
                args[3][:1, :1].contiguous(), args[4][:1, :1].contiguous(), thr2,
            )
            assert int(half[0, 0]) == int(good[0, q : 2 * q].sum()) > 0
    assert kernels.LAUNCHES["ransac_counts_batched"] == 2 * len(shapes) - 1


@pytest.mark.cuda
def test_k1_argmin_and_k7_cuda_kernels_match_plain(cuda_device):
    """d2 and the index bit-equal (the lowest index on the planted exact
    ties), the argmin selection equal to the indexed column, at the
    replay path's shapes and at ragged sizes."""
    kernels.reset_launch_counts()
    for B, nq, nt in K1_SHAPES:
        q, payload, active = nn_inputs(nq + B, max(B, 3), nq, max(nt, 3))
        payload = tie_heavy(payload[..., :nt], 0)
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
                for x in (q[:B], payload[:B], active[:B])]
        d, sel = kernels.nn_select_batched(*args, variant="argmin")
        d7, idx = kernels.nn_index_batched(*args)
        d_ref, sel_ref = kernels.nn_select_batched_plain(*args, variant="argmin")
        d7_ref, idx_ref = kernels.nn_index_batched_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(d, d_ref) and torch.equal(sel, sel_ref)
        assert torch.equal(d7, d7_ref) and torch.equal(idx, idx_ref) and torch.equal(d7, d)
        assert torch.isinf(d7[1]).all() and (idx[1] == 0).all() and (sel[1] == 0).all()
    off = torch.zeros_like(args[2])
    d7, idx = kernels.nn_index_batched(args[0], args[1], off)
    assert torch.isinf(d7).all() and (idx == 0).all()
    assert kernels.LAUNCHES["nn_select_batched_argmin"] == len(K1_SHAPES)
    assert kernels.LAUNCHES["nn_index_batched"] == len(K1_SHAPES) + 1
    assert kernels.LAUNCHES["nn_select_batched"] == 0


@pytest.mark.cuda
def test_k8_cuda_kernel_matches_plain(cuda_device):
    """The expanded form in the same order on both sides: d2 and the
    selection bit-equal, on recentred coordinates (as the caller passes
    them), at the replay path's shape and ragged ones (nt = 1, nq = 1, nq
    off a query group, nt off a slice), with a lane full of ties (the
    lowest index wins); then a batch of inactive lanes only (inf, 0)."""
    kernels.reset_launch_counts()
    shapes = ((32, 1024, 8192), (5, 1000, 3000), (4, 5, 1), (3, 1, 700), (3, 37, 1000),
              (5, 256, 2051))
    for B, nq, nt in shapes:
        q, payload, active = nn_inputs(nq + nt, max(B, 3), nq, max(nt, 3))
        payload = tie_heavy(payload[..., :nt], 0)
        q[0, :4] = np.float32([4.0, 8.0, 13.0])
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
                for x in (q[:B], payload[:B], active[:B])]
        d, sel = kernels.nn_select_batched_mxu(*args)
        d_ref, sel_ref = kernels.nn_select_batched_mxu_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(d, d_ref) and torch.equal(sel, sel_ref)
        assert torch.isinf(d[1]).all() and (sel[1] == 0).all()
        assert (sel[0, :3, :4].T == torch.tensor([4.0, 8.0, 12.0], device=cuda_device)).all()
    d, sel = kernels.nn_select_batched_mxu(args[0], args[1], torch.zeros_like(args[2]))
    assert torch.isinf(d).all() and (sel == 0).all()
    assert kernels.LAUNCHES["nn_select_batched_mxu"] == len(shapes) + 1


def tie_heavy_moments(args, n):
    """K5 inputs with lane 0 full of ties: tie_heavy's two target points,
    the identity pose, and its first n source points at (4, 8, 13), at
    unit distance from every target, the next n at (4, 8.25, 12.5), tied
    among the targets at z = 12."""
    src4, payload, R, t, active = (x.cpu().numpy().copy() for x in args)
    payload = tie_heavy(payload, 0)
    R[0], t[0] = np.eye(3, dtype=np.float32), 0.0
    src4[0, :3, :n] = np.float32([[4.0], [8.0], [13.0]])
    src4[0, :3, n : 2 * n] = np.float32([[4.0], [8.25], [12.5]])
    src4[0, 3, : 2 * n] = 1.0
    return [torch.from_numpy(np.ascontiguousarray(x)).to(args[0].device)
            for x in (src4, payload, R, t, active)]


@pytest.mark.cuda
def test_k5_cuda_kernel_matches_plain(cuda_device):
    """Both bodies at the replay path's two stage shapes and ragged ones
    (nt = 1, nq = 1, nq off a query group, nt off a slice; 3 x 200 x 8,195
    in 4 and 2 slices, the others in one), with a lane full of ties: the counts (w, n_src) equal to the plain version's,
    every sum within 2e-6 of its terms' absolute mass of their exact sum
    (the kernel's float32 order rounds each term at most
    kernels.k5_sum_roundings times, 24 at 32 x 1,024 x 8,192:
    chip_smoke.py's K5_MASS_TOL), the inactive lane zero; then a batch of
    inactive lanes only (zeros)."""
    kernels.reset_launch_counts()
    shapes = ((32, 1024, 8192), (32, 256, 2048), (5, 1000, 3000), (4, 5, 1), (3, 1, 700),
              (3, 37, 1000), (5, 256, 2051), (3, 200, 8195))
    for B, nq, nt in shapes:
        args = tie_heavy_moments(moments_inputs(B + nq, B, nq, nt, cuda_device), min(nq // 4, 64))
        for variant in ("mineq", "argmin"):
            m = kernels.icp_moments_batched(*args, 3.0, variant=variant)
            ref = kernels.icp_moments_batched_plain(*args, 3.0, variant=variant)
            torch.cuda.synchronize()
            for k in (kernels.M_W, kernels.M_NSRC):
                assert torch.equal(m[:, k], ref[:, k])
            terms = kernels.icp_moments_terms_plain(*args, 3.0, variant=variant).double()
            err = (m.double() - terms.sum(dim=1)).abs()
            assert (err <= 2e-6 * terms.abs().sum(dim=1)).all()
            assert (m[1] == 0).all() and (m[2, kernels.M_W] > nq // 4)
            assert m[0, kernels.M_W] >= 2 * min(nq // 4, 64)  # the tie-heavy lane's planted
    m = kernels.icp_moments_batched(*args[:4], torch.zeros_like(args[4]), 3.0)
    assert (m == 0).all()
    assert kernels.LAUNCHES["icp_moments_batched"] == 2 * len(shapes) + 1
