"""Realistic spinning-LiDAR simulator: ring-structured 64-beam raycasts
(port of ``scl_slam_tpu/io/lidar_sim.py``).

The validation proxy for KITTI scans: 64 elevation beams over [-24.8 deg,
+2 deg] (HDL-64E geometry) at a configurable azimuth resolution, the sensor
1.73 m above a ground plane, in an urban world of box buildings along a
street circuit, with lane-offset revisits. Scans come back in the SENSOR
frame like a velodyne packet.

The world (:class:`UrbanScene`) and its circuits are numpy, as in the JAX
module, so the boxes equal the JAX package's bit for bit. Rendering is a
ray-slab test of every ray against every box plus the ground, walked in
chunks of :data:`RAY_CHUNK` rays so the [rays, boxes, 3] temporaries stay
small. The ray directions, the slab test and the entry clamps are the JAX
module's f32 arithmetic.

Range noise: the JAX module draws it from ``jax.random.normal(PRNGKey(seed))``,
a stream torch cannot reproduce. Here it comes from a ``torch.Generator`` on
the render's device seeded by ``seed`` (so the CPU and the card draw
different streams), or from an injected ``noise`` tensor: tests pass JAX's
own draws to reproduce its scans. The noise is added after the valid mask
is taken, so the mask never depends on it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry import se3

# HDL-64E-like geometry (KITTI)
N_BEAMS = 64
ELEV_LO, ELEV_HI = -24.8, 2.0          # degrees
SENSOR_HEIGHT = 1.73                    # meters above ground
MAX_RANGE = 80.0

# rays per slab-test chunk: [8192, 160 boxes (the most a scene holds), 3] f32
# is ~16 MB a temporary
RAY_CHUNK = 8192


class UrbanScene:
    """Procedural street-block world: ground plane + box buildings.

    A square circuit of streets (width ``street_w``) around ``blocks`` city
    blocks per side; each block face gets a row of buildings with random
    footprints, setbacks, and heights. Deterministic from ``seed`` (numpy
    ``RandomState``, the JAX module's draws in its order). ``boxes`` is a
    float32 numpy array [B, 6] of (xmin, ymin, zmin, xmax, ymax, zmax);
    :class:`LidarSim` puts it on its device.
    """

    def __init__(
        self,
        seed: int = 0,
        blocks: int = 2,
        block_size: float = 90.0,
        street_w: float = 14.0,
        max_boxes: int = 160,
    ):
        rng = np.random.RandomState(seed)
        boxes = []
        span = blocks * (block_size + street_w) + street_w
        for bx in range(blocks):
            for by in range(blocks):
                x0 = street_w + bx * (block_size + street_w)
                y0 = street_w + by * (block_size + street_w)
                # buildings around the block perimeter, random gaps
                edge = 0.0
                while edge < block_size - 8.0:
                    w = rng.uniform(8, 22)
                    d = rng.uniform(8, 18)
                    h = rng.uniform(4, 18)
                    gap = rng.uniform(0, 6)
                    if edge + w > block_size:
                        break
                    for (ex, ey, ew, eh) in (
                        (x0 + edge, y0, w, d),                    # south face
                        (x0 + edge, y0 + block_size - d, w, d),   # north face
                        (x0, y0 + edge, d, w),                    # west face
                        (x0 + block_size - d, y0 + edge, d, w),   # east face
                    ):
                        if len(boxes) < max_boxes and rng.rand() < 0.8:
                            boxes.append((ex, ey, 0.0, ex + ew, ey + eh, h))
                    edge += w + gap
        # street furniture: poles lining both sides of the south street only
        # (mirroring them onto the north street collapses the Scan Context
        # revisit margins; see the JAX module)
        for _ in range(min(30, max_boxes - len(boxes))):
            px = rng.uniform(0, span)
            py = rng.choice([street_w * 0.25, street_w * 0.75])
            boxes.append((px, py, 0.0, px + 0.3, py + 0.3, rng.uniform(3, 6)))
        boxes = boxes[:max_boxes]
        self.span = span
        self.boxes = np.asarray(boxes, np.float32)
        self.street_w = street_w
        self.blocks = blocks
        self.block_size = block_size

    def circuit(
        self,
        lane_offset: float = 0.0,
        step: float = 1.0,
        reverse: bool = False,
    ):
        """Rectangular street circuit around the first block, as a list of
        4x4 world-from-sensor poses every ``step`` meters, heading tangent.
        ``lane_offset`` shifts the path laterally toward the block (the
        lane-width revisit offset); ``reverse`` traverses it the opposite
        way (poses in reverse order, heading turned by pi)."""
        s = self.street_w / 2.0
        lo = s + lane_offset
        hi = self.street_w + self.block_size + s - lane_offset
        corners = np.array(
            [[lo, lo], [hi, lo], [hi, hi], [lo, hi]], np.float64
        )
        poses = []
        for c in range(4):
            a, b = corners[c], corners[(c + 1) % 4]
            d = b - a
            L = float(np.hypot(*d))
            yaw = float(np.arctan2(d[1], d[0]))
            n = int(L // step)
            for k in range(n):
                p = a + d * (k / max(n, 1))
                T = np.eye(4)
                cy, sy = np.cos(yaw), np.sin(yaw)
                T[:3, :3] = [[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]]
                T[:3, 3] = [p[0], p[1], SENSOR_HEIGHT]
                poses.append(T)
        if reverse:
            flip = np.diag([-1.0, -1.0, 1.0])  # Rz(pi): heading U-turn
            rev = []
            for T in reversed(poses):
                T2 = T.copy()
                T2[:3, :3] = T[:3, :3] @ flip
                rev.append(T2)
            poses = rev
        return poses


def _sensor_dirs(n_azimuth: int, device=None) -> torch.Tensor:
    """Unit ray directions in the sensor frame, [N_BEAMS * n_azimuth, 3],
    azimuth-major-last (column a holds azimuth ``az[a]`` for all beams).

    The angles are the JAX module's program as XLA compiles it: the
    azimuth's divide and two multiplies fold into one f32 constant and the
    subtraction of pi fuses with the multiply (one rounding, computed here
    exactly in f64: the product and the sum fit its mantissa), and the
    elevation's divide folds into its multiply. An azimuth an ulp off near
    +-pi/2 moves a grazing wall hit by 2.6e-4 m at 47 m."""
    f32 = torch.float32
    pi = torch.tensor(math.pi, dtype=f32)
    step = (torch.tensor(1.0 / n_azimuth, dtype=f32) * 2) * pi
    col = torch.arange(n_azimuth, dtype=f32) + 0.5
    az = (col.double() * step.double() - pi.double()).to(f32)
    beam = torch.arange(N_BEAMS, dtype=f32) + 0.5
    el = (beam * (torch.tensor(ELEV_HI - ELEV_LO, dtype=f32) / N_BEAMS) + ELEV_LO) * torch.tensor(
        math.pi / 180, dtype=f32
    )
    ce, se = torch.cos(el)[:, None], torch.sin(el)[:, None]
    ca, sa = torch.cos(az)[None, :], torch.sin(az)[None, :]
    shape = (N_BEAMS, n_azimuth)
    dirs = torch.stack(
        [(ce * ca).expand(shape), (ce * sa).expand(shape), (se * torch.ones_like(ca)).expand(shape)],
        dim=-1,
    ).reshape(-1, 3)
    return dirs.to(device)


def _draw_noise(n: int, seed: int, device) -> torch.Tensor:
    """[n] standard normal range noise from a generator on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(n, generator=g, device=device, dtype=torch.float32)


def _raycast(boxes, o, dirs, noise, range_sigma):
    """Nearest hit per ray: origins [N, 3], world dirs [N, 3], noise [N] ->
    (t_hit [N], valid [N]). Ray-slab against all boxes + ground plane, in
    chunks of :data:`RAY_CHUNK` rays."""
    t_box = torch.empty(dirs.shape[0], dtype=dirs.dtype, device=dirs.device)
    inf = torch.tensor(float("inf"), dtype=dirs.dtype, device=dirs.device)
    for s in range(0, dirs.shape[0], RAY_CHUNK):
        d, oc = dirs[s : s + RAY_CHUNK], o[s : s + RAY_CHUNK]
        inv = 1.0 / torch.where(d.abs() < 1e-9, 1e-9, d)                # [n, 3]
        lo = (boxes[None, :, 0:3] - oc[:, None, :]) * inv[:, None, :]    # [n, B, 3]
        hi = (boxes[None, :, 3:6] - oc[:, None, :]) * inv[:, None, :]
        t1 = torch.minimum(lo, hi).amax(dim=-1)                         # entry
        t2 = torch.maximum(lo, hi).amin(dim=-1)                         # exit
        hit = (t2 >= t1) & (t2 > 0.0)
        t_box[s : s + RAY_CHUNK] = torch.where(hit, torch.clamp(t1, min=1e-3), inf).amin(dim=-1)
    # ground plane z = 0
    dz = dirs[:, 2]
    t_ground = torch.where(dz < -1e-6, -o[:, 2] / torch.clamp(dz, max=-1e-6), inf)
    t_hit = torch.minimum(t_ground, t_box)
    valid = torch.isfinite(t_hit) & (t_hit < MAX_RANGE) & (t_hit > 0.5)
    return t_hit + range_sigma * noise, valid


def _render(
    boxes: torch.Tensor,     # [B, 6]
    R: torch.Tensor,         # [3, 3] world-from-sensor
    t: torch.Tensor,         # [3]
    seed: int = 0,
    n_azimuth: int = 1800,
    range_sigma: float = 0.02,
    noise: torch.Tensor | None = None,
    dirs_s: torch.Tensor | None = None,
):
    """Raycast one frame on ``boxes``' device. Returns (xyz [N_BEAMS *
    n_azimuth, 3] sensor frame, 1e6 where invalid; mask [N]). ``noise``
    [N] replaces the generator's draws (seeded by ``seed``); ``dirs_s`` is
    ``_sensor_dirs(n_azimuth)`` on that device, built here when not given."""
    dev = boxes.device
    if dirs_s is None:
        dirs_s = _sensor_dirs(n_azimuth, dev)              # sensor frame
    dirs = dirs_s @ R.T                                    # world frame
    o = t[None, :].expand(dirs.shape)
    if noise is None:
        noise = _draw_noise(dirs.shape[0], seed, dev)
    t_hit, valid = _raycast(boxes, o, dirs, noise, range_sigma)
    xyz = dirs_s * t_hit[:, None]                          # SENSOR frame
    xyz = torch.where(valid[:, None], xyz, 1e6)
    return xyz, valid


def _render_skewed(
    boxes: torch.Tensor,
    R0: torch.Tensor, t0: torch.Tensor,   # world-from-sensor at sweep START
    R1: torch.Tensor, t1: torch.Tensor,   # world-from-sensor at sweep END
    seed: int = 0,
    n_azimuth: int = 1800,
    range_sigma: float = 0.02,
    noise: torch.Tensor | None = None,
    dirs_s: torch.Tensor | None = None,
):
    """Raycast one frame while the sensor MOVES through the sweep: along
    the constant-twist path from (R0, t0) at azimuth -pi to (R1, t1) at +pi,
    each azimuth column cast from its interpolated pose; coordinates are in
    the sensor frame at capture time, motion smear included. ``noise`` and
    ``dirs_s`` as in :func:`_render`."""
    A = n_azimuth
    dev = boxes.device
    if dirs_s is None:
        dirs_s = _sensor_dirs(A, dev)                      # [64*A, 3]
    tau = (torch.arange(A, device=dev) + 0.5) / A          # sweep fraction/column
    start = se3.Pose(R0, t0)
    xi = se3.log(se3.between(start, se3.Pose(R1, t1)))
    pose_c = se3.compose(
        se3.Pose(R0.expand(A, 3, 3), t0.expand(A, 3)), se3.exp(tau[:, None] * xi[None, :])
    )                                                      # batched [A]
    Rc = pose_c.R[None].expand(N_BEAMS, A, 3, 3).reshape(-1, 3, 3)
    tc = pose_c.t[None].expand(N_BEAMS, A, 3).reshape(-1, 3)
    dirs = torch.einsum("nij,nj->ni", Rc, dirs_s)          # world frame, per ray
    if noise is None:
        noise = _draw_noise(dirs.shape[0], seed, dev)
    t_hit, valid = _raycast(boxes, tc, dirs, noise, range_sigma)
    xyz = dirs_s * t_hit[:, None]                          # capture-time frame
    xyz = torch.where(valid[:, None], xyz, 1e6)
    return xyz, valid


class LidarSim:
    """Scene + renderer with a numpy-facing API. Renders on ``device``: the
    GPU unless the caller asks for the CPU."""

    def __init__(self, scene: UrbanScene, n_azimuth: int = 1800, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "LidarSim renders on the GPU by default and torch.cuda.is_available() "
                "is false; pass device='cpu' to render on the CPU"
            )
        self.scene = scene
        self.n_azimuth = n_azimuth
        self.boxes = torch.from_numpy(scene.boxes).to(self.device)
        # the direction table depends only on n_azimuth: built once, on the
        # host, so the card's and the CPU's scans stay bit-equal
        self.dirs_s = _sensor_dirs(n_azimuth, self.device)

    @property
    def points_per_scan(self) -> int:
        return N_BEAMS * self.n_azimuth

    def _pose(self, T):
        T = torch.as_tensor(np.asarray(T, np.float32), device=self.device)
        return T[:3, :3], T[:3, 3]

    def _noise(self, noise):
        if noise is None:
            return None
        return torch.tensor(np.asarray(noise), dtype=torch.float32, device=self.device)

    def scan_at(self, T: np.ndarray, seed: int = 0, noise=None) -> np.ndarray:
        """Sensor-frame scan [M, 3] at world-from-sensor pose T (valid
        returns only — like a velodyne packet). ``noise`` [points_per_scan]
        replaces the seeded range-noise draws."""
        xyz, mask = _render(self.boxes, *self._pose(T), seed, self.n_azimuth,
                            noise=self._noise(noise), dirs_s=self.dirs_s)
        return xyz[mask].cpu().numpy()

    def scan_at_skewed(
        self, T0: np.ndarray, T1: np.ndarray, seed: int = 0, noise=None
    ) -> np.ndarray:
        """Motion-smeared scan [M, 3]: the sensor sweeps from pose ``T0``
        (azimuth -pi) to ``T1`` (+pi) during capture; coordinates are in
        the capture-time sensor frame. With ``T0 == T1`` it equals
        :meth:`scan_at` (the interpolated poses are the identity motion up
        to f32 rounding)."""
        xyz, mask = _render_skewed(self.boxes, *self._pose(T0), *self._pose(T1), seed,
                                   self.n_azimuth, noise=self._noise(noise), dirs_s=self.dirs_s)
        return xyz[mask].cpu().numpy()
