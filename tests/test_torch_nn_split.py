"""The launch geometry of the split-target 1-NN kernels (K1 both bodies,
K7, K8, K4, K3, K5 both bodies: ``scl_slam_tpu_torch/csrc/nn_split.cuh``)
and the CPU model of their merge and of K5's sums, in pure torch (no JAX
program).

- ``nn_split_geometry`` covers [0, nt) with ascending, non-empty slices
  and every query with a query tile, at the replay, live, inter-robot and
  fleet shapes and at ragged ones.
- The kernels merge the ranges of a block's warps, then the slices, in
  ascending order: the plain versions walked with the kernel's slice
  length, or with a warp's range (``chunk=``), are that merge on the CPU,
  and equal the unchunked plain versions: d2 and indices bit-equal, the
  tie average within 2 ulp of the payload magnitude (chip_smoke.py's
  TIE_ULPS: ties of three or more that span ranges are summed range by
  range).
- K5 sums its terms in a fixed order (``csrc/icp_moments.cu``): the plain
  terms summed in that order on the CPU stay within 2e-6 of their
  absolute mass of the exact sum (chip_smoke.py's K5_MASS_TOL), the
  counted rounding depth stays within 33, and spare queries add nothing.
"""
import numpy as np
import pytest
import torch

from scl_slam_tpu_torch.ops import kernels

torch.set_num_threads(2)

TIE_ULPS = 2

K1_SHAPES = [
    (32, 1024, 8192),   # replay, full resolution
    (32, 256, 2048),    # replay, coarse
    (16, 1024, 8192),   # fleet RANSAC 1-NN
    (3, 37, 1000),      # ragged: nq off a query tile, nt off a tile
    (2, 1, 1),          # one target
    (5, 300, 257),
]
K4_SHAPES = [
    (1024, 16384),      # live, full resolution (P = 4 and 8)
    (256, 4096),        # live, coarse
    (4096, 8192),       # K3, the default verification
    (4096, 16384),      # K3, the kitti_velodyne widths
    (37, 1000),
    (1, 1),
    (129, 300),
]


def _check(g, lanes, nq, nt):
    assert g.threads % 32 == 0 and 32 <= g.threads <= 512 and g.rq in (2, 4)
    per_tile = 32 * g.rq
    assert (g.q_groups - 1) * per_tile < nq <= g.q_groups * per_tile
    bounds = [(s * g.slice_len, min(nt, (s + 1) * g.slice_len)) for s in range(g.slices)]
    assert bounds[0][0] == 0 and bounds[-1][1] == nt
    assert all(a < b for a, b in bounds)                      # none empty
    assert all(b0[1] == b1[0] for b0, b1 in zip(bounds, bounds[1:]))  # ascending, contiguous
    assert g.slices <= 65535 and lanes * g.q_groups * g.slices >= 1


@pytest.mark.parametrize("B, nq, nt", K1_SHAPES)
def test_k1_geometry_covers_every_target_once(B, nq, nt):
    _check(kernels.k1_geometry(B, nq, nt), B, nq, nt)


@pytest.mark.parametrize("variant", ["mineq", "argmin"])
@pytest.mark.parametrize("B, nq, nt", K1_SHAPES + [(5, 1000, 3000), (5, 256, 2050), (3, 1, 700)])
def test_k5_geometry_covers_every_target_once(B, nq, nt, variant):
    _check(kernels.k5_geometry(B, nq, nt, variant), B, nq, nt)


@pytest.mark.parametrize("nq, nt", K4_SHAPES)
def test_k4_geometry_covers_every_target_once(nq, nt):
    _check(kernels.k4_geometry(nq, nt), 1, nq, nt)


def test_geometry_fills_the_card_at_the_main_shapes():
    """Many more warps than one thread a query gave (K1 at 32 x 1,024 x
    8,192 ran 384 working blocks of 2 warps, about 6 warps an SM; K4 264
    blocks of 4), and no warp below its fewest targets where the target
    allows a split."""
    for g, active_lanes, split in (
        (kernels.k1_geometry(32, 1024, 8192), 24, kernels.K1_SPLIT),
        (kernels.k4_geometry(1024, 16384), 1, kernels.K4_SPLIT),
        (kernels.k4_geometry(4096, 8192), 1, kernels.K4_SPLIT),
    ):
        warps = active_lanes * g.q_groups * g.slices * g.threads // 32
        assert warps >= 12 * kernels._SMS
        assert g.slices == 1 or g.slice_len >= split[3] * split[0]


def _batched_inputs(B, nq, nt, span, seed=0):
    """Lanes of noisy-copy queries; lane 0 plants three-way ties of
    distinct points ``span`` targets apart (so they fall in three slices):
    query k at c_k, targets c_k + e_x at k, c_k - e_x at k + span, c_k + e_y
    at k + 2 span; lane 1 duplicates targets across slices; the last lane
    is inactive."""
    rng = np.random.RandomState(seed)
    t = rng.uniform(-60, 60, (B, nt, 3)).astype(np.float32)
    q = (np.take_along_axis(t, rng.randint(0, nt, (B, nq))[..., None], 1)
         + rng.normal(0, 0.3, (B, nq, 3))).astype(np.float32)
    n_tie = min(nq, span)
    c = (rng.randint(-10, 10, (n_tie, 3)) * 4.0).astype(np.float32) + 0.25
    q[0, :n_tie] = c
    t[0, :] += 500.0
    t[0, :n_tie] = c + np.float32([1, 0, 0])
    t[0, span : span + n_tie] = c - np.float32([1, 0, 0])
    t[0, 2 * span : 2 * span + n_tie] = c + np.float32([0, 1, 0])
    t[1, span : 2 * span] = t[1, :span]
    payload = np.concatenate([np.swapaxes(t, 1, 2), np.ones((B, 1, nt), np.float32)], 1)
    active = np.ones(B, np.int32)
    active[-1] = 0
    return torch.from_numpy(q), torch.from_numpy(np.ascontiguousarray(payload)), torch.from_numpy(active)


def _span(g, level):
    """The targets of one slice, or of one warp's range of it."""
    return g.slice_len if level == "slice" else -(-g.slice_len // (g.threads // 32))


@pytest.mark.parametrize("level", ["slice", "warp"])
@pytest.mark.parametrize("shape", [(32, 1024, 8192), (32, 256, 2048), (3, 37, 1000)])
def test_batched_plain_walked_by_slices_is_the_unchunked_result(shape, level):
    """K1 (both bodies) and K7 at the kernel's slice length and warp range:
    the replay shapes' lengths on 4 lanes of 64 queries (the CPU cost), and
    a ragged shape whole."""
    B, nq, nt = shape
    span = _span(kernels.k1_geometry(B, nq, nt), level)
    B, nq = min(B, 4), min(nq, 64)
    nt = max(nt, 3 * span)
    q, payload, active = _batched_inputs(B, nq, nt, span)
    d, sel = kernels.nn_select_batched_plain(q, payload, active, chunk=nt)
    d_s, sel_s = kernels.nn_select_batched_plain(q, payload, active, chunk=span)
    assert torch.equal(d, d_s)
    assert (d[0, : min(nq, span)] == 1.0).all()              # the planted ties
    tol = TIE_ULPS * 2.0 ** (np.floor(np.log2(payload[:, :3].abs().max().item())) - 23)
    assert (sel - sel_s).abs().max().item() <= tol
    assert torch.isinf(d[-1]).all() and (sel[-1] == 0).all()
    for variant_out, chunked in (
        (kernels.nn_select_batched_plain(q, payload, active, "argmin", chunk=nt),
         kernels.nn_select_batched_plain(q, payload, active, "argmin", chunk=span)),
        (kernels.nn_index_batched_plain(q, payload, active, chunk=nt),
         kernels.nn_index_batched_plain(q, payload, active, chunk=span)),
    ):
        assert all(torch.equal(a, b) for a, b in zip(variant_out, chunked))


@pytest.mark.parametrize("level", ["slice", "warp"])
@pytest.mark.parametrize("shape", [(1024, 16384), (256, 4096), (4096, 8192), (37, 1000)])
def test_solo_plain_walked_by_slices_is_the_unchunked_result(shape, level):
    """K4 (P = 4 and 8) and K3 at the kernel's slice length and warp range,
    with exact duplicates and equidistant targets placed in different
    ranges (the lowest index must win across ranges too)."""
    nq, nt = shape
    span = _span(kernels.k4_geometry(nq, nt), level)
    nq = min(nq, 256)
    rng = np.random.RandomState(nq + nt)
    t = rng.uniform(-40, 40, (nt, 3)).astype(np.float32)
    q = (t[rng.randint(0, nt, nq)] + rng.normal(0, 0.3, (nq, 3))).astype(np.float32)
    n_dup = min(span, nt - span)
    t[span : span + n_dup] = t[:n_dup]                        # ties across slices
    t[nt - 1] = (100.0, 100.0, 100.0)                         # queries at unit distance ...
    t[nt // 2] = (100.0, 100.0, 102.0)                        # ... from two targets
    q[:4] = (100.0, 100.0, 101.0)
    for P in (4, 8):
        payload = np.concatenate([t.T, rng.normal(0, 1, (P - 3, nt)).astype(np.float32)], 0)
        qt, pt = torch.from_numpy(q), torch.from_numpy(np.ascontiguousarray(payload))
        whole = kernels.nn_select_plain(qt, pt, chunk=nt)
        sliced = kernels.nn_select_plain(qt, pt, chunk=span)
        assert torch.equal(whole[0], sliced[0]) and torch.equal(whole[1], sliced[1])
    tt = torch.from_numpy(t)
    whole = kernels.nearest_neighbors_plain(torch.from_numpy(q), tt, chunk=nt)
    sliced = kernels.nearest_neighbors_plain(torch.from_numpy(q), tt, chunk=span)
    assert torch.equal(whole[0], sliced[0]) and torch.equal(whole[1], sliced[1])
    assert (whole[0][:4] == 1.0).all() and (whole[1][:4] == nt // 2).all()


@pytest.mark.parametrize("level", ["slice", "warp"])
@pytest.mark.parametrize("shape", [(32, 1024, 8192), (5, 256, 2050), (3, 37, 1000)])
def test_k8_plain_walked_by_slices_is_the_unchunked_result(shape, level):
    """K8 (the expanded form, the lowest index at the min) at the kernel's
    slice length and warp range, on recentred coordinates with padded
    targets (invalid points at 1e6, as the callers pad): d2 and the
    selection bit-equal. Lane 0 plants exact ties of distinct targets in
    two ranges (integer queries c, targets c + e_x at k and c - e_x at
    span + k): the lower index wins across ranges."""
    B, nq, nt = shape
    span = _span(kernels.k1_geometry(B, nq, nt), level)
    B, nq = min(B, 4), min(nq, 64)
    nt = max(nt, 2 * span)
    rng = np.random.RandomState(nt + span)
    t = rng.uniform(-30, 30, (B, nt, 3)).astype(np.float32)
    q = (np.take_along_axis(t, rng.randint(0, nt, (B, nq))[..., None], 1)
         + rng.normal(0, 0.3, (B, nq, 3))).astype(np.float32)
    valid = rng.rand(B, nt) > 0.1
    n_tie = min(nq, span)
    c = rng.randint(-6, 6, (n_tie, 3)).astype(np.float32) * 4.0
    q[0, :n_tie] = c
    t[0] += 500.0
    t[0, :n_tie] = c + np.float32([1, 0, 0])
    t[0, span : span + n_tie] = c - np.float32([1, 0, 0])
    valid[0, :n_tie] = valid[0, span : span + n_tie] = True
    t = np.where(valid[..., None], t, 1e6).astype(np.float32)
    payload = np.concatenate([np.swapaxes(t, 1, 2), valid[:, None].astype(np.float32)], 1)
    active = np.ones(B, np.int32)
    active[-1] = 0
    args = (torch.from_numpy(q), torch.from_numpy(np.ascontiguousarray(payload)),
            torch.from_numpy(active))
    d, sel = kernels.nn_select_batched_mxu_plain(*args, chunk=nt)
    d_s, sel_s = kernels.nn_select_batched_mxu_plain(*args, chunk=span)
    assert torch.equal(d, d_s) and torch.equal(sel, sel_s)
    assert torch.isinf(d[-1]).all() and (sel[-1] == 0).all()
    assert (sel[:-1, 3] == 1).all()                           # no pad ever won
    assert (d[0, :n_tie] == 1.0).all()
    assert torch.equal(sel[0, 0, :n_tie], torch.from_numpy(c[:, 0] + 1))


def _kernel_order_sums(terms, g):
    """K5's sums of terms [B, Nq, 18] (float32) in the kernel's order at
    geometry g: per query group, each lane's rq queries in order (a spare
    query, past Nq, repeats query Nq - 1 and adds zeros), then the 32
    lanes by the shuffle tree lane 0 ends with, then the groups in
    ascending order."""
    B, nq, _ = terms.shape
    i = torch.arange(g.q_groups * 32 * g.rq).view(g.q_groups, g.rq, 32)  # query q0 + 32 r
    src = terms[:, i.clamp(max=nq - 1)]                                 # [B, G, rq, 32, 18]
    src = torch.where((i < nq)[None, ..., None], src, torch.zeros(()))
    acc = src[:, :, 0]
    for r in range(1, g.rq):
        acc = acc + src[:, :, r]
    for off in (16, 8, 4, 2, 1):
        acc = acc[:, :, :off] + acc[:, :, off : 2 * off]
    rows = acc[:, :, 0]                                                 # [B, G, 18]
    m = rows[:, 0]
    for grp in range(1, g.q_groups):
        m = m + rows[:, grp]
    return m


def _moments_inputs(B, nq, nt, seed):
    """K5 inputs: noisy copies of targets (5% invalid, padded at 1e6) in a
    random local frame per lane, with lane 1's targets in triplicate (ties
    of identical points), lane 2 at the identity pose on an integer grid
    at unit distance from three distinct targets (ties of distinct points),
    ~10% of the source points invalid, the last lane inactive."""
    rng = np.random.RandomState(seed)
    t = rng.uniform(-30, 30, (B, nt, 3)).astype(np.float32)
    valid = rng.rand(B, nt) > 0.05
    q = np.take_along_axis(t, rng.randint(0, nt, (B, nq))[..., None], 1)
    q = q + rng.normal(0, 0.3, (B, nq, 3))
    t[1, 1::3], t[1, 2::3] = t[1, 0::3][: len(t[1, 1::3])], t[1, 0::3][: len(t[1, 2::3])]
    valid[1] = True
    n_tie = min(nt // 3, nq)
    c = rng.randint(-6, 6, (n_tie, 3)).astype(np.float32) * 4.0
    q[2, :n_tie] = c
    t[2, :n_tie] = c + np.float32([1, 0, 0])
    t[2, n_tie : 2 * n_tie] = c - np.float32([1, 0, 0])
    t[2, 2 * n_tie : 3 * n_tie] = c + np.float32([0, 1, 0])
    valid[2, : 3 * n_tie] = True
    t = np.where(valid[..., None], t, 1e6).astype(np.float32)
    payload = np.concatenate([np.swapaxes(t, 1, 2), valid[:, None].astype(np.float32)], 1)
    R = np.empty((B, 3, 3), np.float32)
    for b in range(B):
        w = rng.normal(0, 0.15, 3)
        th = np.linalg.norm(w)
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
        R[b] = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
    tr = rng.uniform(-5, 5, (B, 3)).astype(np.float32)
    R[2], tr[2] = np.eye(3), 0.0
    local = np.einsum("bji,bnj->bni", R, q - tr[:, None]).astype(np.float32)
    local[2] = q[2]                                  # the identity keeps the grid exact
    src_valid = rng.rand(B, nq) > 0.1
    src4 = np.concatenate([np.swapaxes(local, 1, 2), src_valid[:, None]], 1).astype(np.float32)
    active = np.ones(B, np.int32)
    active[-1] = 0
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (src4, payload, R, tr, active))


@pytest.mark.parametrize("variant", ["mineq", "argmin"])
@pytest.mark.parametrize("shape", [(32, 1024, 8192), (32, 256, 2048), (5, 1000, 3000), (3, 37, 1000)])
def test_k5_sums_in_kernel_order_within_mass_tolerance(shape, variant):
    """The plain terms summed in K5's order at the kernel's geometry for the
    shape (on 4 lanes: the CPU cost; lane 3 inactive) are within 2e-6 of their absolute
    mass of the exact sum; the counted depth is at most 33 (2e-6 * 2**24 =
    33.5); at nq off a query group the spare queries add nothing, so the
    counts (M_W, M_NSRC) equal the plain sums exactly; the planted ties
    are found; the inactive lane is zero."""
    B, nq, nt = shape
    g = kernels.k5_geometry(B, nq, nt, variant)
    assert kernels.k5_sum_roundings(g, variant) <= 33
    args = _moments_inputs(4, nq, nt, seed=nq + nt)
    terms = kernels.icp_moments_terms_plain(*args, 3.0, variant=variant)
    m = _kernel_order_sums(terms, g)
    exact, mass = terms.double().sum(dim=1), terms.double().abs().sum(dim=1)
    err = (m.double() - exact).abs()
    assert (err <= 2e-6 * mass).all()
    plain = kernels.icp_moments_batched_plain(*args, 3.0, variant=variant)
    for k in (kernels.M_W, kernels.M_NSRC):
        assert torch.equal(m[:, k], plain[:, k])
    assert (m[-1] == 0).all()
    n_tie = min(nt // 3, nq)
    assert (terms[2, :n_tie, kernels.M_WD2] == 1.0).sum() >= n_tie // 2   # valid tied queries


def test_k5_spare_queries_add_nothing():
    """Without the mask a spare query (nq = 37 in a group of 64) would
    repeat query 36's terms 27 times: the model's counts would then differ
    from the plain version's."""
    args = _moments_inputs(4, 37, 1000, seed=5)
    terms = kernels.icp_moments_terms_plain(*args, 3.0)
    g = kernels.k5_geometry(4, 37, 1000)
    assert g.q_groups * 32 * g.rq > 37
    plain = kernels.icp_moments_batched_plain(*args, 3.0)
    assert torch.equal(_kernel_order_sums(terms, g)[:, kernels.M_NSRC], plain[:, kernels.M_NSRC])
    i = torch.arange(g.q_groups * 32 * g.rq).clamp(max=36)
    unmasked = terms[:, i].sum(dim=1)
    assert (unmasked[:3, kernels.M_NSRC] > plain[:3, kernels.M_NSRC]).any()
