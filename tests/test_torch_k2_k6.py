"""The launch geometry of K2 (max image) and K6 (RANSAC inlier counts) and
CPU models of how their blocks meet (``scl_slam_tpu_torch/csrc/max_image.cu``,
``csrc/ransac_counts.cu``).

- ``k2_geometry`` cuts each frame into contiguous chunks, a multiple of 4
  points long and at least 2,048 points but the last, that cover every
  point once; ``k6_geometry`` cuts the hypotheses into groups and the
  points into chunks that cover each once. Both aim at the blocks their
  split names (``K2_SPLIT[2]``, ``K6_SPLIT[1]``) where the shape allows
  it, without overshooting by more than a block a frame or chunk.
- K2 builds one image a chunk and merges them by a max on the bits: that
  model, in numpy, equals ``max_image_plain`` and the JAX package's
  ``scatter_max_image`` (``init=0.0``) bit for bit, on random bins and on
  scans in a spinning LiDAR's azimuth order.
- K6 counts each (hypothesis group, chunk) block alone and adds the
  chunks: the sum by the same geometry equals ``ransac_counts_batched_plain``
  and the Pallas kernel in interpret mode (up to the points within 4 ulp of
  the threshold, as ``test_torch_kernels.py`` holds the plain version).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scl_slam_tpu.ops import pallas_kernels as pk
from scl_slam_tpu.ops.pointcloud import scatter_max_image as jax_scatter_max_image
from scl_slam_tpu_torch.io import kitti as kio
from scl_slam_tpu_torch.ops import kernels
from scl_slam_tpu_torch.ops import pointcloud as pc
from test_torch_cuda import image_inputs, ransac_inputs
from test_torch_kernels import _ransac_res2_numpy
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)

SMS = 132
# (B, N) of the main paths' K2 launches: replay bench, fleet bench,
# live-kitti, run_multi's add_frame, the live demo
K2_SHAPES = [(32, 65536), (16, 65536), (1, 131072), (1, 65536), (1, 32768)]
K2_RAGGED = [(3, 65537), (2, 3), (1, 1), (4, 0), (5, 4099)]
# (B, H, N) of K6: fleet bench, a full keyframe, fleet run, ragged
K6_SHAPES = [(16, 256, 1024), (16, 256, 4096), (2, 256, 1024), (3, 37, 1000)]
K6_RAGGED = [(1, 1, 1), (2, 67, 1001), (1, 300, 5000)]


def _k2_chunks(g, n):
    return [(c * g.chunk_len, min(n, (c + 1) * g.chunk_len)) for c in range(g.chunks)]


@pytest.mark.parametrize("B,n", K2_SHAPES + K2_RAGGED)
def test_k2_geometry_covers_every_point_once(B, n):
    g = kernels.k2_geometry(B, n)
    assert g.chunk_len % 4 == 0 and g.chunks >= 1 and g.threads % 32 == 0
    chunks = _k2_chunks(g, n)
    assert chunks[0][0] == 0 and chunks[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(k1 > k0 for k0, k1 in chunks) or n == 0
    threads, min_pts, want = kernels.K2_SPLIT
    assert all(k1 - k0 >= min_pts for k0, k1 in chunks[:-1])
    # the blocks aimed for, or as many as chunks of min_pts points give
    blocks = B * g.chunks
    assert blocks >= min(want, B * max(1, n // min_pts))
    assert blocks < want + B or g.chunks == 1


def _k6_ranges(g, H, N):
    hyp = [(j * g.hyps, min(H, (j + 1) * g.hyps)) for j in range(g.groups)]
    per = g.threads * kernels.K6_PTS
    pts = [(c * per, min(N, (c + 1) * per)) for c in range(g.chunks)]
    return hyp, pts


@pytest.mark.parametrize("B,H,N", K6_SHAPES + K6_RAGGED)
def test_k6_geometry_covers_every_pair_once(B, H, N):
    g = kernels.k6_geometry(B, H, N)
    assert g.threads % 32 == 0
    for ranges, end in zip(_k6_ranges(g, H, N), (H, N)):
        assert ranges[0][0] == 0 and ranges[-1][1] == end
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(hi > lo for lo, hi in ranges)
    # about the blocks aimed for (at least half, where the hypotheses
    # allow), no more than a group a lane and chunk past them unless the
    # most hypotheses a block forces more groups
    _, want, max_hyps = kernels.K6_SPLIT
    lanes = B * g.chunks
    blocks = lanes * g.groups
    assert 1 <= g.hyps <= max_hyps
    assert 2 * blocks >= min(want, lanes * H)
    assert blocks < want + lanes or g.groups == -(-H // max_hyps)


def k2_model(z, ring, sector, valid, R, S, g):
    """K2 as its blocks compute it: one image a chunk (a max on the bits of
    the positive values), then the chunks' images merged by a max on the
    bits, in whatever order they arrive (here the reverse)."""
    B, n = z.shape
    out = np.zeros((B, R * S), np.uint32)
    for b in range(B):
        for k0, k1 in reversed(_k2_chunks(g, n)):
            v, r, s = z[b, k0:k1], ring[b, k0:k1], sector[b, k0:k1]
            ok = valid[b, k0:k1] & (v > 0) & (r >= 0) & (r < R) & (s >= 0) & (s < S)
            img = np.zeros(R * S, np.uint32)
            np.maximum.at(img, (r * S + s)[ok], v[ok].view(np.uint32))
            out[b] = np.maximum(out[b], img)
    return out.view(np.float32).reshape(B, R, S)


def ordered_scans(B, n, seed=7):
    """Scans of a small synthetic town in a spinning LiDAR's order (by
    azimuth), padded to ``n`` points as the live path pads a scan: the
    port's polar bins and heights, as ``descriptors/scan_context.make``
    hands them to K2."""
    world = kio.SyntheticWorld(seed=seed, extent=80.0, n_clusters=40, pts_per_cluster=2000,
                               max_range=60.0)
    gt = kio.loop_trajectory(n_frames=8, radius=30.0)
    xyz = np.zeros((B, n, 3), np.float32)
    mask = np.zeros((B, n), bool)
    for b in range(B):
        scan = world.scan_at(gt[b], max_points=n - 100, seed=b)
        scan = scan[np.argsort(np.arctan2(scan[:, 1], scan[:, 0]), kind="stable")]
        xyz[b, : len(scan)] = scan
        mask[b, : len(scan)] = True
    xyz_t, mask_t = torch.from_numpy(xyz), torch.from_numpy(mask)
    ring, sector, valid = pc.polar_bins(xyz_t, mask_t, 20, 60, 80.0)
    z = xyz_t[..., 2] + 1.65
    return tuple(x.numpy() for x in (z, ring, sector, valid))


@pytest.mark.parametrize("kind,B,n,R,S", [
    ("ordered", 1, 131072, 20, 60),
    ("ordered", 2, 32768, 20, 60),
    ("random", 3, 65537, 20, 60),
    ("random", 4, 16400, 64, 64),
])
def test_k2_chunk_merge_model_equals_plain_and_jax(kind, B, n, R, S):
    if kind == "ordered":
        z, ring, sector, valid = ordered_scans(B, n)
    else:
        z, ring, sector, valid = image_inputs(n + R, B, n, R, S)
    g = kernels.k2_geometry(B, n)
    assert g.chunks > 1
    model = k2_model(z, ring, sector, valid, R, S, g)
    plain = kernels.max_image_plain(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (z, ring, sector, valid)), R, S
    ).numpy()
    np.testing.assert_array_equal(model.view(np.uint32), plain.view(np.uint32))
    assert (model > 0).sum() > R * S // 8  # the image is not mostly empty
    ref = np.stack([
        np.asarray(jax_scatter_max_image(
            jnp.asarray(z[b]), jnp.asarray(ring[b]), jnp.asarray(sector[b]),
            jnp.asarray(valid[b]), R, S, init=0.0,
        ))
        for b in range(B)
    ])
    np.testing.assert_array_equal(model.view(np.uint32), ref.view(np.uint32))


def k6_model(src, matched, good, R, t, thr2, g):
    """K6 as its blocks compute it: each (hypothesis group, chunk, lane)
    block counts its points' inliers for its hypotheses (the contract's
    res2, every step in f32); the chunks' counts are added."""
    B, H, N = R.shape[0], R.shape[1], src.shape[1]
    inlier = (_ransac_res2_numpy(src, matched, R, t) < np.float32(thr2)) & good[:, None, :]
    hyp, pts = _k6_ranges(g, H, N)
    counts = np.zeros((B, H), np.int64)
    for p0, p1 in pts:
        for h0, h1 in hyp:
            counts[:, h0:h1] += inlier[:, h0:h1, p0:p1].sum(-1)
    return counts


# the default geometry and ones with more chunks and hypothesis groups
# (threads, blocks aimed for, most hypotheses a block)
K6_SPLITS = [kernels.K6_SPLIT, (32, 2 * SMS, 64), (64, 2 * SMS, 3), (64, 8, 64)]


@pytest.fixture(scope="module")
def k6_pallas():
    """K6's inputs at a shape the Pallas kernel takes (H % 8 == 0, N % 128
    == 0) and its counts in interpret mode."""
    B, H, N = 3, 16, 384
    src, matched, good, R, t, thr2 = ransac_inputs(31, B, H, N)
    src4 = np.concatenate([np.swapaxes(src, 1, 2), good[:, None].astype(np.float32)], 1)
    mt4 = np.concatenate([np.swapaxes(matched, 1, 2), np.zeros((B, 1, N), np.float32)], 1)
    rows = np.zeros((B, H, 128), np.float32)
    rows[..., :9] = R.reshape(B, H, 9)
    rows[..., 9:12] = t
    pallas = np.asarray(pk.ransac_counts_batched_pallas(
        jnp.asarray(src4), jnp.asarray(mt4), jnp.asarray(rows), thr2, interpret=True
    ))
    return (src, matched, good, R, t, thr2), pallas


@pytest.mark.parametrize("split", K6_SPLITS)
def test_k6_chunk_sum_model_equals_plain_and_pallas(split, k6_pallas):
    (src, matched, good, R, t, thr2), pallas = k6_pallas
    B, H, N = R.shape[0], R.shape[1], src.shape[1]
    g = kernels.k6_geometry(B, H, N, split)
    model = k6_model(src, matched, good, R, t, thr2, g)
    plain = kernels.ransac_counts_batched_plain(
        *(torch.from_numpy(x) for x in (src, matched, good, R, t)), thr2
    ).numpy()
    np.testing.assert_array_equal(model, plain)
    res2 = _ransac_res2_numpy(src, matched, R, t)
    near = ((np.abs(res2 - np.float32(thr2)) <= 4 * np.spacing(np.float32(thr2)))
            & good[:, None, :]).sum(-1)
    near[0, 0] = 0  # the identity rows are exact on every side
    assert (np.abs(model - pallas) <= near).all(), (model - pallas, near)
    assert model[0, 0] == pallas[0, 0] and model[0].max() > 0


@pytest.mark.parametrize("B,H,N", [(2, 256, 1024), (3, 37, 1000), (2, 67, 1001), (2, 64, 4096)])
def test_k6_chunk_sum_model_equals_plain_at_path_shapes(B, H, N):
    src, matched, good, R, t, thr2 = ransac_inputs(B + H + N, B, H, N)
    g = kernels.k6_geometry(B, H, N)
    assert g.chunks == -(-N // (kernels.K6_SPLIT[0] * kernels.K6_PTS))
    model = k6_model(src, matched, good, R, t, thr2, g)
    plain = kernels.ransac_counts_batched_plain(
        *(torch.from_numpy(x) for x in (src, matched, good, R, t)), thr2
    ).numpy()
    np.testing.assert_array_equal(model, plain)
    assert (model[1] == 0).all() and model[0].max() > 0
