"""LiDAR-Iris descriptor (port of ``scl_slam_tpu/descriptors/lidar_iris.py``).

The image is ``rows`` 1 m distance bins x ``cols`` azimuth bins; each cell
holds an 8-bit code of the elevation arcs its points fall in, and the row
key is the row mean of the per-cell max-z map. Both come from one launch of
kernel K2 (``ops.kernels.max_image``) over 9 channels a frame: the 8
occupancy channels (value 1 where a point hits the arc) and the max-z map.

Matching follows the JAX module: binary features from a one-sided
log-Gabor bank (``encode_features``), the log-polar FFT template match for
the column shift (``fft_match``), and the masked Hamming distance over that
shift +-2 under match modes 0 (forward), 1 (180-flipped) and 2 (both),
counted on the features packed into words (``pack_features``).
Every function is batched over leading dimensions (the JAX module vmaps
single frames), and the transforms run on ``torch.fft``. The JAX module's
matrix-multiply DFT (``MATMUL_DFT``) served only a TPU compile service's
size limit and is not carried.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops import kernels
from ..ops.pointcloud import Cloud
from . import base


@dataclass(frozen=True)
class LidarIrisConfig:
    rows: int = 80           # distance bins
    cols: int = 360          # azimuth bins
    n_scan: int = 64         # beam count (16 or 64)
    max_radius: float = 80.0
    num_candidates: int = 10
    exclude_recent: int = 30
    distance_threshold: float = 0.32
    nscale: int = 4
    min_wave_length: float = 18.0
    mult: float = 1.6
    sigma_on_f: float = 0.75
    match_mode: int = 2      # 0: forward, 1: 180-flipped, 2: both (min)


class Iris(NamedTuple):
    """Encoded keyframes: image [..., rows, cols] (0..255 occupancy codes),
    row key [..., rows] (row means of the per-cell max z)."""

    image: torch.Tensor
    row_key: torch.Tensor


def iris_bins(xyz: torch.Tensor, mask: torch.Tensor, cfg: LidarIrisConfig):
    """Row, column and elevation-arc bins (int32) of points [..., N, 3], and
    which points take part: row = floor(xy distance) in 1 m bins at the
    reference geometry, column = floor(yaw_deg * cols / 360 + 0.5), arc =
    4-degree elevation arcs from -15 (16 beams) or -24.9 degrees (64)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = torch.sqrt(x * x + y * y)
    row = torch.clamp(
        torch.floor(r * (cfg.rows / cfg.max_radius)).to(torch.int32), 0, cfg.rows - 1
    )
    yaw_deg = torch.atan2(y, x) * (180.0 / math.pi) + 180.0
    col = torch.clamp(
        torch.floor(yaw_deg * (cfg.cols / 360.0) + 0.5).to(torch.int32), 0, cfg.cols - 1
    )
    pitch_deg = torch.atan2(z, torch.clamp(r, min=1e-6)) * (180.0 / math.pi)
    arc_origin = 15.0 if cfg.n_scan == 16 else 24.9
    arc = torch.clamp(torch.floor((pitch_deg + arc_origin) / 4.0).to(torch.int32), 0, 7)
    valid = mask & (r < cfg.max_radius) & (r > 0.1)
    return row, col, arc, valid


def make(cloud: Cloud, cfg: LidarIrisConfig) -> Iris:
    """Encode clouds [..., N, 3] -> Iris, by one K2 image of 9 channels a
    frame: [9B, N] points into [9B, rows, cols] bins."""
    lead, n = cloud.xyz.shape[:-2], cloud.xyz.shape[-2]
    xyz = cloud.xyz.reshape(-1, n, 3)
    row, col, arc, valid = iris_bins(xyz, cloud.mask.reshape(-1, n), cfg)
    B = xyz.shape[0]
    hits = arc[:, None, :] == torch.arange(8, dtype=torch.int32, device=xyz.device)[:, None]
    chan_valid = torch.cat([hits & valid[:, None, :], valid[:, None, :]], dim=1)
    values = torch.cat(
        [torch.ones((B, 8, n), dtype=xyz.dtype, device=xyz.device), xyz[:, None, :, 2]],
        dim=1,
    )
    img9 = kernels.max_image(
        values.reshape(9 * B, n).contiguous(),
        row[:, None, :].expand(B, 9, n).reshape(9 * B, n).contiguous(),
        col[:, None, :].expand(B, 9, n).reshape(9 * B, n).contiguous(),
        chan_valid.reshape(9 * B, n).contiguous(),
        cfg.rows, cfg.cols,
    ).reshape(B, 9, cfg.rows, cfg.cols)
    weights = torch.tensor(
        [float(1 << b) for b in range(8)], dtype=xyz.dtype, device=xyz.device
    )
    img = (img9[:, :8] * weights[:, None, None]).sum(dim=1)  # exact: distinct powers of 2
    row_key = img9[:, 8].mean(dim=-1)
    return Iris(img.reshape(*lead, cfg.rows, cfg.cols), row_key.reshape(*lead, cfg.rows))


# ---------------------------------------------------------------------------
# binary feature encoding (one-sided log-Gabor bank)
# ---------------------------------------------------------------------------


def log_gabor_bank(cfg: LidarIrisConfig, device=None) -> torch.Tensor:
    """One-sided frequency-domain log-Gabor transfer functions [nscale,
    cols], nonzero only for the frequency bins 1..cols/2 (the filtered
    signal is the complex analytic response)."""
    n = cfg.cols
    half = n // 2
    idx = torch.arange(n, device=device)
    radius = torch.where(idx == 0, 1.0, idx / float(n)).to(torch.float32)
    log_sigma = torch.log(torch.tensor(cfg.sigma_on_f, dtype=torch.float32, device=device))
    filters = []
    wavelength = float(cfg.min_wave_length)
    for _ in range(cfg.nscale):
        f0 = 1.0 / wavelength
        lg = torch.exp(-(torch.log(radius / f0) ** 2) / (2 * log_sigma ** 2))
        lg = torch.where((idx == 0) | (idx > half), 0.0, lg)
        filters.append(lg)
        wavelength *= cfg.mult
    return torch.stack(filters)


# the reference's noise-mask threshold 1e-4 with an unnormalized inverse
# DFT; torch.fft.ifft divides by n, so the mask compares |resp| to 1e-4/cols
_M_THRESH_REF = 1e-4


def encode_features(image: torch.Tensor, cfg: LidarIrisConfig):
    """Binary template T [..., nscale, rows, cols, 2] (the quadrature bits
    real > 0, imag > 0) and noise mask M [..., nscale, rows, cols] (True =
    unreliable) of images [..., rows, cols]."""
    bank = log_gabor_bank(cfg, image.device)                    # [S, C]
    spec = torch.fft.fft(image, dim=-1)                         # [..., R, C]
    resp = torch.fft.ifft(spec[..., None, :, :] * bank[:, None, :], dim=-1)
    T = torch.stack([resp.real > 0, resp.imag > 0], dim=-1)
    M = resp.abs() < (_M_THRESH_REF / cfg.cols)
    return T, M


# ---------------------------------------------------------------------------
# the 2-D log-polar FFT template match
# ---------------------------------------------------------------------------


def _bilinear(img: torch.Tensor, xq: torch.Tensor, yq: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of images [..., H, W] at float coordinates
    [..., H', W'] (broadcast against the images' leading dimensions), zero
    outside (cv::remap's BORDER_CONSTANT)."""
    H, W = img.shape[-2:]
    lead = torch.broadcast_shapes(img.shape[:-2], xq.shape[:-2], yq.shape[:-2])
    out_hw = xq.shape[-2:]
    flat = img.expand(*lead, H, W).reshape(*lead, H * W)
    xq = xq.expand(*lead, *out_hw)
    yq = yq.expand(*lead, *out_hw)
    x0 = torch.floor(xq)
    y0 = torch.floor(yq)
    fx = xq - x0
    fy = yq - y0

    def at(yi, xi):
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        k = (torch.clamp(yi, 0, H - 1).to(torch.int64) * W
             + torch.clamp(xi, 0, W - 1).to(torch.int64))
        v = torch.gather(flat, -1, k.reshape(*lead, -1)).reshape(*lead, *out_hw)
        return torch.where(inside, v, 0.0)

    return (
        at(y0, x0) * (1 - fx) * (1 - fy)
        + at(y0, x0 + 1) * fx * (1 - fy)
        + at(y0 + 1, x0) * (1 - fx) * fy
        + at(y0 + 1, x0 + 1) * fx * fy
    )


def _spectrum_magnitude(im: torch.Tensor) -> torch.Tensor:
    """|fftshifted 2-D DFT| / (M N) of images [..., M, N]."""
    M, N = im.shape[-2:]
    F = torch.fft.fftshift(torch.fft.fft2(im), dim=(-2, -1))
    return F.abs() / (M * N)


def _highpass(rows: int, cols: int, device=None) -> torch.Tensor:
    """(1 - cos_y cos_x)(2 - cos_y cos_x)."""
    ay = torch.cos(-math.pi / 2 + torch.arange(rows, device=device) * (math.pi / rows))
    bx = torch.cos(-math.pi / 2 + torch.arange(cols, device=device) * (math.pi / cols))
    t = ay[:, None] * bx[None, :]
    return (1.0 - t) * (2.0 - t)


def _logpolar_grid(rows: int, cols: int, device=None):
    """The log-polar sample grid of a [rows, cols] spectrum: radii along the
    columns, 180 degrees of angles along the rows. Returns (xq, yq [rows,
    cols], log_base 0-d)."""
    cx, cy = cols // 2, rows // 2
    d = torch.sqrt(torch.tensor(float((cols - cx) ** 2 + (rows - cy) ** 2), device=device))
    log_base = torch.pow(torch.tensor(10.0, device=device), torch.log10(d) / float(cols))
    theta = math.pi / 2.0 + torch.arange(rows, device=device) * (math.pi / float(rows))
    radius = torch.pow(log_base, torch.arange(cols, device=device).to(torch.float32))
    xq = radius[None, :] * torch.sin(theta)[:, None] + cx
    yq = radius[None, :] * torch.cos(theta)[:, None] + cy
    return xq, yq, log_base


def _logpolar(src: torch.Tensor):
    """Log-polar resample of spectra [..., rows, cols]. Returns (dst, log_base)."""
    xq, yq, log_base = _logpolar_grid(*src.shape[-2:], device=src.device)
    return _bilinear(src, xq, yq), log_base


def _phase_correlate(a: torch.Tensor, b: torch.Tensor):
    """cv::phaseCorrelate(a, b) of images [..., H, W]: the peak of the
    inverse cross-power spectrum (the first maximum), refined by the 5 x 5
    weighted centroid around it, as signed shifts in (-dim/2, dim/2].
    Returns (dx, dy, response), each [...]."""
    H, W = a.shape[-2:]
    Fa = torch.fft.fft2(a)
    Fb = torch.fft.fft2(b)
    cross = Fa * torch.conj(Fb)
    cross = cross / torch.clamp(cross.abs(), min=1e-12)
    corr = torch.fft.ifft2(cross).real                          # [..., H, W]
    lead = corr.shape[:-2]
    flat_corr = corr.reshape(*lead, H * W)
    flat = torch.argmax(flat_corr, dim=-1)                      # first maximum
    py, px = flat // W, flat % W
    o = torch.arange(-2, 3, device=a.device)
    yy = (py[..., None, None] + o[:, None]) % H                 # [..., 5, 1]
    xx = (px[..., None, None] + o[None, :]) % W                 # [..., 1, 5]
    k = (yy * W + xx).reshape(*lead, 25)
    w = torch.clamp(torch.gather(flat_corr, -1, k), min=0.0).reshape(*lead, 5, 5)
    tot = torch.clamp(w.sum(dim=(-2, -1)), min=1e-12)
    cy = py + (w * o[:, None]).sum(dim=(-2, -1)) / tot
    cx = px + (w * o[None, :]).sum(dim=(-2, -1)) / tot
    dx = torch.where(cx > W / 2, cx - W, cx)
    dy = torch.where(cy > H / 2, cy - H, cy)
    peak = torch.gather(flat_corr, -1, flat[..., None])[..., 0]
    return dx, dy, peak


def _warp_rot_scale(im: torch.Tensor, angle_deg: torch.Tensor, scale: torch.Tensor):
    """cv::warpAffine with getRotationMatrix2D(center, angle, 1/scale) of
    images [..., H, W] by angles and scales [...]: each output pixel samples
    the source at rot(-angle) * scale (dst - c) + c."""
    H, W = im.shape[-2:]
    cx, cy = W // 2, H // 2
    a = torch.deg2rad(angle_deg)[..., None, None]
    s = 1.0 / scale[..., None, None]
    inv_s = 1.0 / torch.clamp(s, min=1e-12)
    ica, isa = inv_s * torch.cos(-a), inv_s * torch.sin(-a)
    xs = (torch.arange(W, device=im.device) - cx)[None, :]
    ys = (torch.arange(H, device=im.device) - cy)[:, None]
    Xq = ica * xs - isa * ys + cx
    Yq = isa * xs + ica * ys + cy
    return _bilinear(im, Xq, Yq)


def fft_match(im0: torch.Tensor, im1: torch.Tensor) -> torch.Tensor:
    """How images im1 [..., R, C] map onto im0 (broadcast): the sub-pixel
    column shift tx [...] with im1 ~ roll(im0, tx), by the log-polar FFT
    template match (rotation and scale by a first phase correlation, then
    the shift by a second on the corrected image)."""
    im0 = im0 / 255.0
    im1 = im1 / 255.0
    im0, im1 = torch.broadcast_tensors(im0, im1)
    f0 = _spectrum_magnitude(im0)
    f1 = _spectrum_magnitude(im1)
    h = _highpass(*f0.shape[-2:], device=f0.device)
    f0lp, log_base = _logpolar(f0 * h)
    f1lp, _ = _logpolar(f1 * h)
    dx, dy, _ = _phase_correlate(f1lp, f0lp)
    rows_lp = f0lp.shape[-2]
    angle = 180.0 * dy / rows_lp
    scale = torch.pow(log_base, dx)
    # scale > 1.8 retries with the inverted sign (the retry recomputes the
    # same correlation, so only the sign flip matters)
    bad = scale > 1.8
    angle = torch.where(bad, -angle, angle)
    scale = torch.where(bad, 1.0 / scale, scale)
    angle = torch.where(angle < -90.0, angle + 180.0, angle)
    angle = torch.where(angle > 90.0, angle - 180.0, angle)
    im1_rs = _warp_rot_scale(im1, angle, scale)
    tx, _ty, _ = _phase_correlate(im1_rs, im0)
    return tx


# ---------------------------------------------------------------------------
# Hamming matching
# ---------------------------------------------------------------------------


def _roll_cols(x: torch.Tensor, shifts: torch.Tensor, col_dim: int) -> torch.Tensor:
    """jnp.roll of x along ``col_dim`` by per-item shifts: ``shifts`` [...,
    K] against x [..., *rest] gives [..., K, *rest] with out[c] = x[(c - s)
    mod C]."""
    C = x.shape[col_dim]
    nd = x.dim()
    col_dim %= nd
    lead = shifts.dim() - 1
    c = torch.arange(C, device=x.device)
    src = (c - shifts[..., None]) % C                          # [..., K, C]
    view = [1] * (nd - lead)
    view[col_dim - lead] = C
    idx = src.reshape(*shifts.shape, *view)
    xe = x.unsqueeze(lead)
    shape = torch.broadcast_shapes(idx.shape, xe.shape)
    return torch.gather(xe.expand(shape), lead + 1 + (col_dim - lead), idx.expand(shape))


def pack_features(T: torch.Tensor, M: torch.Tensor):
    """Features as words, for the Hamming distance: T [..., S, R, C, 2] and
    M [..., S, R, C] -> (t, m) [..., R, C] int64, bit 2s + q of t the
    quadrature bit q of scale s, bits 2s and 2s + 1 of m its mask (both
    bits of a masked scale). At most 31 scales."""
    S = T.shape[-4]
    if not 0 < S <= 31:
        raise ValueError(f"at most 31 scales pack into a word, got {S}")
    bit = (2 * torch.arange(S, device=T.device)).reshape(S, 1, 1)
    t = ((T[..., 0].long() << bit) | (T[..., 1].long() << (bit + 1))).sum(dim=-3)
    m = ((M.long() * 3) << bit).sum(dim=-3)
    return t, m


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each non-negative int64 word (the SWAR count)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56


def _hamming_packed(a, b, shifts: torch.Tensor, scales: int) -> torch.Tensor:
    """:func:`hamming_distance` on packed features a = (t, m), b = (t, m)
    [..., R, C]: the differing bits where neither mask is set, over twice
    the scales left unmasked (at least 2), the query shifted by each of
    ``shifts`` [..., K]. Returns [..., K]."""
    (ta, ma), (tb, mb) = a, b
    ta_s = _roll_cols(ta, shifts, -1)                           # [..., K, R, C]
    ma_s = _roll_cols(ma, shifts, -1)
    live = ((1 << (2 * scales)) - 1) ^ (ma_s | mb.unsqueeze(-3))
    diff = _popcount((ta_s ^ tb.unsqueeze(-3)) & live).sum(dim=(-2, -1))
    total = torch.clamp(_popcount(live).sum(dim=(-2, -1)), min=2)
    return diff / total


def hamming_distance(Ta, Ma, Tb, Mb, shifts: torch.Tensor) -> torch.Tensor:
    """Masked Hamming distance with the query (a) circularly shifted by each
    candidate shift. T [..., S, R, C, 2], M [..., S, R, C]; ``shifts``
    [..., K]. Returns [..., K]: the differing template bits where neither
    mask is set, over twice the unmasked (scale, row, column) cells (at
    least 2), counted on packed words."""
    return _hamming_packed(pack_features(Ta, Ma), pack_features(Tb, Mb), shifts, Ta.shape[-4])


def _match_one_orientation(a, img_a, b, img_b, cfg: LidarIrisConfig):
    """The fft_match shift estimate, then the Hamming distance of the packed
    features a and b over shift +-2. Returns (best distance, best shift of
    a onto b), each [...]; the first minimum on ties. ``fft_match(a, b)``
    gives tx with b = roll(a, tx), the roll of the query onto the
    candidate."""
    shift0 = torch.round(fft_match(img_a, img_b)).to(torch.int64)
    cands = (shift0[..., None] + torch.arange(-2, 3, device=img_a.device)) % cfg.cols
    d = _hamming_packed(a, b, cands, cfg.nscale)
    best = torch.argmin(d, dim=-1, keepdim=True)
    return torch.gather(d, -1, best)[..., 0], torch.gather(cands, -1, best)[..., 0]


def _match_features(a, img_a, b, img_b, cfg: LidarIrisConfig):
    """:func:`match_pair` on packed features (broadcast between a and b)."""
    half = cfg.cols // 2
    if cfg.match_mode in (0, 2):
        d0, s0 = _match_one_orientation(a, img_a, b, img_b, cfg)
    if cfg.match_mode in (1, 2):
        b2 = tuple(torch.roll(x, half, dims=-1) for x in b)
        img_b2 = torch.roll(img_b, half, dims=-1)
        d1, s1 = _match_one_orientation(a, img_a, b2, img_b2, cfg)
        s1 = (s1 + half) % cfg.cols
    if cfg.match_mode == 0:
        dist, shift = d0, s0
    elif cfg.match_mode == 1:
        dist, shift = d1, s1
    else:
        use1 = d1 < d0
        dist = torch.where(use1, d1, d0)
        shift = torch.where(use1, s1, s0)
    signed = torch.where(shift > half, shift - cfg.cols, shift)
    yaw = signed.to(torch.float32) * (2 * math.pi / cfg.cols)
    return dist, yaw


def match_pair(img_a: torch.Tensor, img_b: torch.Tensor, cfg: LidarIrisConfig):
    """Full Iris comparison of query images a [..., R, C] against candidates
    b (broadcast) under the configured match mode. Returns (distance,
    yaw in radians), each [...]."""
    a = pack_features(*encode_features(img_a, cfg))
    b = pack_features(*encode_features(img_b, cfg))
    return _match_features(a, img_a, b, img_b, cfg)


# ---------------------------------------------------------------------------
# DB and wire plumbing
# ---------------------------------------------------------------------------


def make_db(capacity: int, cfg: LidarIrisConfig, device) -> base.DescriptorDB:
    return base.make_db(capacity, (cfg.rows, cfg.cols), cfg.rows, device)


def insert(db: base.DescriptorDB, iris: Iris, robot: int, index: int, pos: int):
    return base.db_insert(db, iris.image, iris.row_key, robot, index, pos)


def to_wire(iris: Iris) -> torch.Tensor:
    """[rows*cols image, rows row key]: the max-z row key cannot be rebuilt
    from the byte image, so both go over the wire."""
    return torch.cat([iris.image.reshape(-1), iris.row_key])


def from_wire(values: torch.Tensor, cfg: LidarIrisConfig) -> Iris:
    n = cfg.rows * cfg.cols
    return Iris(values[:n].reshape(cfg.rows, cfg.cols), values[n:])


def query(
    db: base.DescriptorDB,
    iris: Iris,
    query_robot,
    query_index: torch.Tensor,
    cfg: LidarIrisConfig,
    mode: str = "intra",
) -> base.Match:
    """Two-stage detection for B query frames at once: the
    ``num_candidates`` nearest row keys (masked top-k), then the full
    comparison on each (B x candidates x orientations at once); accept the
    best below ``distance_threshold``. iris: [B, R, C] images, [B, R] row
    keys; query_index [B]; query_robot one robot or [B]."""
    mask = base.candidate_mask(db, query_robot, query_index, mode, cfg.exclude_recent)
    _, pos = base.topk_by_key(db.keys, iris.row_key, mask, cfg.num_candidates)
    cand_imgs = db.descriptors[pos]                             # [B, K, R, C]
    a = tuple(x[:, None] for x in pack_features(*encode_features(iris.image, cfg)))
    b = pack_features(*encode_features(cand_imgs, cfg))
    dist, yaw = _match_features(a, iris.image[:, None], b, cand_imgs, cfg)   # [B, K]
    cand_ok = torch.gather(mask, 1, pos)
    dist = torch.where(cand_ok, dist, float("inf"))
    best = torch.argmin(dist, dim=1)
    best_dist = torch.gather(dist, 1, best[:, None])[:, 0]
    best_pos = torch.gather(pos, 1, best[:, None])[:, 0]
    found = best_dist < cfg.distance_threshold
    none = torch.full_like(best_pos, -1)
    return base.Match(
        found=found,
        db_pos=torch.where(found, best_pos, none).to(torch.int32),
        robot=torch.where(found, db.robot[best_pos].long(), none).to(torch.int32),
        index=torch.where(found, db.index[best_pos].long(), none).to(torch.int32),
        distance=best_dist,
        yaw=torch.gather(yaw, 1, best[:, None])[:, 0],
    )
