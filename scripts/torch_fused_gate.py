"""The IMU-fused front end's gap to its ICP pose, frame by frame, in the
JAX package and in the PyTorch port, on the CPU.

Both packages' ``ImuFusedOdometry`` (deskew "gyro", window 6, 32 samples)
run on the simulator's skewed sweeps of ``UrbanScene(seed=4)`` at 360
azimuths (map 8,192, scan 2,048), two drives of 18 frames 0.1 s apart:
``fast``, 2 m a frame (20 m/s, ``chip_smoke.py`` phase 37's circuit), and
``from_rest``, 5 m/s^2 from standstill (phase 38's). The IMU samples are
``chip_smoke.consistent_imu``'s (exact under the preintegrator's scheme).
Each line of output is one JSON object: the drive, the package, and the
gap of each frame (the 0.5 m divergence gate keeps the ICP pose above it).

    JAX_PLATFORMS=cpu python scripts/torch_fused_gate.py

It shows where the window's cold start (the unfilled nodes at rest) pulls
the smoothed pose off in the reference as well as in the port.
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from scl_slam_tpu.runtime import odometry as JO  # noqa: E402
from scl_slam_tpu_torch.io import lidar_sim  # noqa: E402
from scl_slam_tpu_torch.runtime import odometry as O  # noqa: E402

FRAMES = 18


def drives():
    scene = lidar_sim.UrbanScene(seed=4)
    fine = scene.circuit(step=0.05)
    s = 0.5 * chip_smoke.FROM_REST_ACCEL * (0.1 * np.arange(FRAMES)) ** 2
    return {
        "fast": scene.circuit(step=2.0)[:FRAMES],
        "from_rest": [fine[int(round(x / 0.05))] for x in s],
    }, lidar_sim.LidarSim(scene, n_azimuth=360, device="cpu")


def gaps(fused, poses, scans):
    imu = chip_smoke.consistent_imu(poses)
    out = []
    for k, scan in enumerate(scans):
        if k == 0:
            a = g = np.zeros((1, 3), np.float32)
            dt = np.zeros(1, np.float32)
        else:
            a, g, dt = imu[k - 1]
        _, _, info = fused.step(scan, a, g, dt)
        out.append(round(float(info.get("smooth_gap", 0.0)), 4))
    return out


def main():
    ways, sim = drives()
    cfg = dict(map_capacity=8192, scan_capacity=2048, deskew="gyro")
    for drive, poses in ways.items():
        scans = [sim.scan_at_skewed(poses[max(k - 1, 0)], poses[k], seed=100 + k)
                 for k in range(FRAMES)]
        for package, fused in (
            ("jax", JO.ImuFusedOdometry(JO.OdometryConfig(**cfg), window=6, max_samples=32)),
            ("torch", O.ImuFusedOdometry(O.OdometryConfig(**cfg), window=6, max_samples=32,
                                         device="cpu")),
        ):
            print(json.dumps({"drive": drive, "package": package,
                              "gaps": gaps(fused, poses, scans)}), flush=True)


if __name__ == "__main__":
    main()
