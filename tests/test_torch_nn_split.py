"""The launch geometry of the split-target 1-NN kernels (K1 both bodies,
K7, K4, K3: ``scl_slam_tpu_torch/csrc/nn_split.cuh``) and the CPU model
of their merge, in pure torch (no JAX program).

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
