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


def offset_rows(x, device):
    """``x`` on the card as a contiguous view one element past an aligned
    allocation: 4 bytes off 16-byte alignment for 4-byte elements, so the
    kernels take their scalar loads."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=device)
    flat[1:] = t.reshape(-1).to(device)
    return flat[1:].view(t.shape)


# (B, N, rings, sectors): live-kitti, the demo, the replay bench's lane
# count, ragged N (the scalar loop), 64 x 64 = 4,096 bins, LiDAR-Iris's
# 80 x 360 = 28,800 (past the default 48 KB of shared memory a block)
K2_CUDA_SHAPES = ((1, 131072, 20, 60), (1, 32768, 20, 60), (4, 65536, 20, 60),
                  (3, 65537, 20, 60), (2, 3, 20, 60), (1, 1, 20, 60), (4, 4100, 64, 64),
                  (9, 131072, 80, 360), (3, 65537, 80, 360))


@pytest.mark.cuda
def test_k2_cuda_kernel_matches_plain(cuda_device):
    """Bit-equal to the plain version at the main paths' shapes and ragged
    ones, with an all-invalid frame, on rows 4 bytes off 16-byte alignment,
    and at other geometries (one chunk, short chunks, other blocks)."""
    kernels.reset_launch_counts()
    launches = 0
    for B, n, R, S in K2_CUDA_SHAPES:
        z, ring, sector, valid = image_inputs(8 + n, B, n, R, S)
        if B > 1:
            valid[-1] = False  # an all-invalid frame reads 0 everywhere
        args = [torch.from_numpy(x).to(cuda_device) for x in (z, ring, sector, valid)]
        img = kernels.max_image(*args, R, S)
        ref = kernels.max_image_plain(*args, R, S)
        torch.cuda.synchronize()
        assert torch.equal(img, ref)
        if B > 1:
            assert (img[-1] == 0).all()
        off = [offset_rows(x, cuda_device) for x in (z, ring, sector, valid)]
        assert off[0].data_ptr() % 16 == 4
        assert torch.equal(kernels.max_image(*off, R, S), ref)
        launches += 2
    # other geometries at a one-frame and a ragged shape: one chunk (plain
    # stores), short chunks (many atomics a bin), other block sizes
    for B, n in ((1, 131072), (3, 65537)):
        z, ring, sector, valid = image_inputs(9 + n, B, n)
        args = [torch.from_numpy(x).to(cuda_device) for x in (z, ring, sector, valid)]
        ref = kernels.max_image_plain(*args, 20, 60)
        splits = [(threads, pts, 4096) for threads in (128, 1024) for pts in (4, 512, 8192, n)]
        for split in splits:
            g = kernels.k2_geometry(B, n, split)
            img = kernels._launch_max_image(*args, 20, 60, geom=g)
            torch.cuda.synchronize()
            assert torch.equal(img, ref), g
        launches += len(splits)
    assert kernels.LAUNCHES["max_image"] == launches


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
def test_k4_cuda_kernel_at_the_odometry_shape(cuda_device):
    """K4 at the point-to-plane odometry's shape, 4,096 scan points against
    the 32,768-row map with its P = 8 payload (xyz, validity, normal, pad),
    the second half of the map PAD_VALUE rows (a map still filling): d2
    bit-equal to the plain version, the selection equal, the planted
    equidistant ties to the lower index."""
    kernels.reset_launch_counts()
    q, payload, n_grid = nn_solo_inputs(12, 4096, 32768, 8)
    payload[:3, 8192:24576] = 1e6   # half the rows pads, the planted ties kept
    payload[3, 8192:24576] = 0.0
    args = [torch.from_numpy(x).to(cuda_device) for x in (q, payload)]
    d, sel = kernels.nn_select(*args)
    d_ref, sel_ref = kernels.nn_select_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(d, d_ref)
    assert torch.equal(sel, sel_ref)
    on_grid = d[:n_grid] == 1.0
    assert int(on_grid.sum()) >= 4
    assert torch.equal(sel[0, :n_grid][on_grid], args[0][:n_grid, 0][on_grid] - 1.0)
    assert kernels.LAUNCHES["nn_select"] == 1


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


# (B, H, N): the fleet bench, a full keyframe, the fleet run, ragged (H off
# the hypothesis group, N off 4 points: the scalar loads), one pair
K6_CUDA_SHAPES = ((16, 256, 1024), (16, 256, 4096), (2, 256, 1024), (3, 37, 1000),
                  (2, 67, 1001), (1, 1, 1))


@pytest.mark.cuda
def test_k6_cuda_kernel_matches_plain(cuda_device):
    """Counts equal to the plain version's at the fleet's shapes (16 and 2
    lanes x 256 hypotheses x 1,024 points), at a full keyframe (4,096
    points) and at ragged sizes, with points planted exactly on the
    threshold and a lane without a good point; on rows 4 bytes off 16-byte
    alignment; at other geometries (other block sizes and hypothesis
    groups, one chunk and several)."""
    kernels.reset_launch_counts()
    launches = 0
    for B, H, N in K6_CUDA_SHAPES:
        src, matched, good, R, t, thr2 = ransac_inputs(B + H + N, B, H, N)
        args = [torch.from_numpy(x).to(cuda_device) for x in (src, matched, good, R, t)]
        counts = kernels.ransac_counts_batched(*args, thr2)
        ref = kernels.ransac_counts_batched_plain(*args, thr2)
        torch.cuda.synchronize()
        assert torch.equal(counts, ref)
        off = [offset_rows(x, cuda_device) for x in (src, matched, good)] + args[3:]
        assert torch.equal(kernels.ransac_counts_batched(*off, thr2), ref)
        launches += 2
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
            launches += 1
    for B, H, N in ((2, 256, 1024), (2, 67, 1001)):
        src, matched, good, R, t, thr2 = ransac_inputs(B + H + N, B, H, N)
        args = [torch.from_numpy(x).to(cuda_device) for x in (src, matched, good, R, t)]
        ref = kernels.ransac_counts_batched_plain(*args, thr2)
        # (threads, blocks aimed for, most hypotheses a block): more
        # chunks (atomics), other groups, one block a lane (plain stores)
        splits = [(threads, 264, hyps) for threads in (64, 128) for hyps in (5, 64)]
        splits.append((512, 1, 256))
        for split in splits:
            g = kernels.k6_geometry(B, H, N, split)
            counts = kernels._launch_ransac_counts(*args, thr2, geom=g)
            torch.cuda.synchronize()
            assert torch.equal(counts, ref), g
        launches += len(splits)
    assert kernels.LAUNCHES["ransac_counts_batched"] == launches


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


@pytest.mark.cuda
def test_lidar_sim_card_matches_cpu(cuda_device):
    """The simulator on the card against the CPU at the quality anchor's
    1,024 azimuths, the same noise injected: the masks equal (the direction
    table is built on the host for both) and the points within 1e-4 m (the
    world-frame rotation is a cuBLAS matmul on the card); the same for a
    moving sweep."""
    from scl_slam_tpu_torch.io import lidar_sim

    scene = lidar_sim.UrbanScene(seed=7, blocks=1, block_size=40.0)
    cpu = lidar_sim.LidarSim(scene, n_azimuth=1024, device="cpu")
    card = lidar_sim.LidarSim(scene, n_azimuth=1024, device=cuda_device)
    poses = scene.circuit(lane_offset=2.0)
    for k in (3, 77, 150):
        noise = np.random.RandomState(k).randn(cpu.points_per_scan).astype(np.float32)
        a, b = cpu.scan_at(poses[k], noise=noise), card.scan_at(poses[k], noise=noise)
        assert a.shape == b.shape and a.shape[0] > 50_000
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
        a = cpu.scan_at_skewed(poses[k], poses[k + 3], noise=noise)
        b = card.scan_at_skewed(poses[k], poses[k + 3], noise=noise)
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_pcm_filter_card_matches_cpu(cuda_device):
    """PCM on the card against the CPU: a queue of 256 loop slots (the
    default queue capacity) with 40 consistent loops, 12 outliers and the
    rest invalid; the consistency matrix within 1e-4 relative or 1e-5
    absolute, ``inf`` in the same places, the accept masks equal; the
    greedy clique equal on graphs with planted degree ties."""
    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.graph import pcm

    rng = np.random.RandomState(0)
    M, good, bad = 256, 40, 12
    R_ab = _rodrigues(np.array([0.0, 0.0, 0.4]))
    t_ab = np.array([5.0, -2.0, 0.3])
    ai = [(_rodrigues(np.array([0, 0, 0.05 * k])), np.array([1.5 * k, 0.2 * k, 0])) for k in range(M)]
    bj = [(R_ab @ R, R_ab @ t + t_ab) for R, t in ai]
    z = []
    for k, ((Ra, ta), (Rb, tb)) in enumerate(zip(ai, bj)):
        Rz, tz = Ra.T @ Rb, Ra.T @ (tb - ta)
        s_rot, s_t = (0.002, 0.02) if k < good else (0.5, 10.0)
        z.append((Rz @ _rodrigues(rng.normal(0, s_rot, 3)), Rz @ rng.normal(0, s_t, 3) + tz))
    valid = np.arange(M) < good + bad

    def poses(ps, dev):
        return se3.Pose(torch.tensor(np.stack([p[0] for p in ps]), dtype=torch.float32, device=dev),
                        torch.tensor(np.stack([p[1] for p in ps]), dtype=torch.float32, device=dev))

    out = {}
    for dev in ("cpu", cuda_device):
        args = [poses(ps, dev) for ps in (ai, bj, z)] + [torch.from_numpy(valid).to(dev)]
        out[str(dev)] = (pcm.consistency_matrix(*args).cpu().numpy(),
                         pcm.pcm_filter(*args).cpu().numpy())
    (e_c, a_c), (e_g, a_g) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_array_equal(np.isinf(e_g), np.isinf(e_c))
    fin = np.isfinite(e_c)
    np.testing.assert_allclose(e_g[fin], e_c[fin], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(a_g, a_c)
    assert a_c[:good].all() and not a_c[good:].any()
    for seed in range(4):
        labels = np.random.RandomState(seed).permutation(np.arange(96) % (seed + 2))
        adj = torch.from_numpy(labels[:, None] == labels[None, :])
        assert torch.equal(pcm.greedy_max_clique(adj.to(cuda_device)).cpu(), pcm.greedy_max_clique(adj))


@pytest.mark.cuda
def test_checkpoint_card_to_cpu_and_back(cuda_device, tmp_path):
    """A session saved on the card loads on the CPU and the reverse, every
    state array bit-equal to the one saved, and both continue 4 frames to
    the same keyframes with the trajectories within 1e-4 m (the card's
    solve sums in another order)."""
    from scl_slam_tpu_torch.config import (
        KeyframeConfig, LoopConfig, OptimizerConfig, ScanContextParams, SlamConfig)
    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.runtime import Mapper, checkpoint
    from scl_slam_tpu_torch.runtime.state import state_to_numpy

    cfg = SlamConfig(
        keyframe=KeyframeConfig(max_keyframes=16, points_per_keyframe=256, raw_points_capacity=512),
        loop=LoopConfig(near_keyframes=2, submap_capacity=512, queue_capacity=8),
        optimizer=OptimizerConfig(edge_capacity=64, gn_iters=2, cg_iters=8),
        scan_context=ScanContextParams(exclude_recent=2),
    )
    rng = np.random.RandomState(0)
    scans = [rng.uniform(-20, 20, (400, 3)).astype(np.float32) for _ in range(10)]

    def pose(k):
        return se3.Pose(np.eye(3, dtype=np.float32), np.float32([2.0 * k, 0.1 * k, 0.0]))

    for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
        m = Mapper(cfg, src)
        for k in range(6):
            m.add_frame(pose(k), scans[k], stamp=0.1 * k)
            m.spin_once(now=0.1 * k)
        path = str(tmp_path / f"{src}.npz")
        checkpoint.save(m, path)
        n = checkpoint.load(Mapper(cfg, dst), path)
        loaded = state_to_numpy(n.state)
        for k, v in state_to_numpy(m.state).items():
            np.testing.assert_array_equal(loaded[k], v, err_msg=k)
        assert n._frames_seen == m._frames_seen == 6
        for k in range(6, 10):
            for x in (m, n):
                assert x.add_frame(pose(k), scans[k], stamp=0.1 * k) is not None
                x.spin_once(now=0.1 * k)
        np.testing.assert_allclose(n.trajectory(), m.trajectory(), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_timers_on_the_card(cuda_device, tmp_path):
    """``utils/timing.py`` on the card: a synchronizing stage covers the
    work it launched, and the profiler's trace holds the card's kernels."""
    from scl_slam_tpu_torch.utils import timing

    a = torch.randn(4096, 4096, device=cuda_device)
    t = timing.Timers(cuda_device)
    with t.time("sync"):
        a @ a
    rep = t.report()
    assert rep["sync"]["count"] == 1
    assert rep["sync"]["max_ms"] > 0.1  # a 4,096-cube f32 matmul is no faster
    with timing.device_trace(str(tmp_path)) as prof:
        a @ a
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    assert (tmp_path / "trace.json").exists()
    assert any(e.device_type == DeviceType.CUDA for e in prof.key_averages())


@pytest.mark.cuda
def test_conversions_card_match_cpu(cuda_device):
    """The Euler and quaternion conversions on the card against the CPU."""
    from scl_slam_tpu_torch.geometry import se3, so3

    rng = np.random.RandomState(41)
    rpy = rng.uniform(-np.pi, np.pi, (1024, 3)).astype(np.float32)
    rpy[:2, 1] = [np.pi / 2, -np.pi / 2]
    q = rng.normal(size=(1024, 4)).astype(np.float32)
    t = rng.uniform(-50, 50, (1024, 3)).astype(np.float32)
    R_np = so3.from_euler(torch.from_numpy(rpy)).numpy()   # one input for both
    for dev in ("cpu", cuda_device):
        R = torch.from_numpy(R_np).to(dev)
        got = [so3.to_euler(R), so3.matrix_to_quat(R), so3.from_euler(torch.from_numpy(rpy).to(dev)),
               so3.quat_to_matrix(torch.from_numpy(q).to(dev)),
               se3.to_xyzrpy(se3.Pose(R, torch.from_numpy(t).to(dev)))]
        got = [g.cpu().numpy() for g in got]
        if dev == "cpu":
            ref = got
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)


@pytest.mark.cuda
def test_sharded_solve_nccl_world_one_matches_gloo_cpu(cuda_device, tmp_path):
    """``sharded_solve`` in a world of size 1 over NCCL on the card and over
    gloo on the CPU (one spawned rank each): the same poses within 1e-3 m
    and the chi2 history within 1e-3 relative (the card's scatter-sums run
    in another order; measured on an H100 in 5 runs 1.1e-4 to 4.3e-4 m and
    2.1e-4 to 3.3e-4 relative, as ``chip_smoke.py`` phase 42's 1,024-pose
    problem parts by 1.0e-4 to 2.4e-4 m)."""
    from scl_slam_tpu_torch.parallel import multihost

    outs = {dev: multihost.spawn(_solve_rank, 1, (dev,), device=dev, workdir=str(tmp_path))[0]
            for dev in ("cpu", "cuda")}
    np.testing.assert_allclose(outs["cuda"][0], outs["cpu"][0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(outs["cuda"][1], outs["cpu"][1], rtol=1e-3)


def _solve_rank(rank, world, dev):
    """A 256-pose circle with loops through ``sharded_solve`` on ``dev``."""
    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.graph import factors as F
    from scl_slam_tpu_torch.parallel import sharded

    n = 256
    a = 2 * np.pi * np.arange(n) / (n // 2)
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, 3] = np.stack([20 * np.cos(a), 20 * np.sin(a), 0 * a], -1)
    gt[:, 0, 0] = gt[:, 1, 1] = np.cos(a + np.pi / 2)
    gt[:, 1, 0] = np.sin(a + np.pi / 2)
    gt[:, 0, 1] = -gt[:, 1, 0]
    rng = np.random.RandomState(0)
    g = F.make_graph(2 * n, device=dev)
    ii, jj, Z = [], [], []
    X = [gt[0]]
    for k in range(n - 1):
        noise = np.eye(4)
        noise[:3, 3] = rng.normal(0, 0.02, 3)
        Z.append(np.linalg.inv(gt[k]) @ gt[k + 1] @ noise)
        ii.append(k), jj.append(k + 1)
        X.append(X[-1] @ Z[-1])
    for k in range(0, n // 2, 8):
        Z.append(np.linalg.inv(gt[k]) @ gt[k + n // 2])
        ii.append(k), jj.append(k + n // 2)
    Z = torch.tensor(np.stack(Z), dtype=torch.float32, device=dev)
    F.add_between_block(g, torch.tensor(ii, device=dev), torch.tensor(jj, device=dev),
                        se3.Pose(Z[:, :3, :3], Z[:, :3, 3]),
                        torch.full((len(ii), 6), 50.0, device=dev))
    T0 = torch.tensor(gt[0], dtype=torch.float32, device=dev)
    F.add_prior(g, 0, se3.Pose(T0[:3, :3], T0[:3, 3]), [1e3] * 6)
    X = torch.tensor(np.stack(X), dtype=torch.float32, device=dev)
    poses, chis, _ = sharded.sharded_solve(None, g, se3.Pose(X[:, :3, :3], X[:, :3, 3]),
                                           gn_iters=6, cg_iters=48, coarse_stride=16)
    return poses.t.cpu().numpy(), chis.cpu().numpy()


@pytest.mark.cuda
def test_cityscale_fleet_mesh_drain_on_the_card(cuda_device, tmp_path):
    """four_robot_cityscale.yaml's fleet at its widths (4 x 4,096 pose
    slots, 16 frames: 4-14 poses a robot) on the card, its drain on the
    mesh of one NCCL rank, drained from one state with the graph's edges
    in 8 orders (the card's scatter-sums vary the order too): no drain
    breaks down (``broken_drains`` 0), nor the single-device solve of the
    same graph, and each brings the chi2 below 5% of its start."""
    import os

    import torch_rank_tasks
    from scl_slam_tpu_torch.parallel import multihost

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (out,) = multihost.spawn(torch_rank_tasks.sparse_fleet_drain, 1,
                             (root, 16, 8, "cuda", 4096), device="cuda", workdir=str(tmp_path))
    for order in out:
        assert order["broken"] == 0 and order["breakdowns"] == [], order["breakdowns"]
        assert order["chi"][-1] < 0.05 * order["chi"][0]
        assert order["single_code"] == 0
        assert order["single_chi"][-1] < 0.05 * order["single_chi"][0]


@pytest.mark.cuda
def test_dryrun_one_nccl_rank_on_the_card(cuda_device, tmp_path):
    """``dryrun_multichip(1, "cuda", "nccl")``: parts A-D held against
    their whole-DB runs in the rank, the kernels of the path launched."""
    from scl_slam_tpu_torch.parallel import dryrun

    (out,) = dryrun.dryrun_multichip(1, "cuda", "nccl", workdir=str(tmp_path))
    for k in ("max_image", "nn_select", "nn_select_batched", "ransac_counts_batched"):
        assert out["launches"][k] >= 1, out["launches"]
