"""Long-lived SLAM service of the PyTorch port (port of
``scl_slam_tpu/serve.py``): scans in over a socket, poses out.

One process owns a :class:`Mapper` on the card (``--device cpu`` for the
CPU), and with ``--odometry icp`` the scan-to-map ICP front end
(``runtime/odometry.Odometry``) on the same device. It accepts framed
requests over TCP and answers with poses and trajectories. The wire format is the length-prefixed, pickle-free npz
framing of ``runtime/transport.py``, the JAX package's, so a client of
either package talks to a server of either.

Protocol (request, response) pairs:

- ``("frame", {"xyz": [N,3] f32, "pose": [4,4] | None, "stamp": float})`` ->
  ``{"keyframe": bool, "pose": [4,4], "loop": dict | None}``
  (a frame without a pose takes the front end's; without a front end it is
  answered with an error)
- ``("trajectory", {"robot": int | None})`` -> ``{"poses": [M,4,4], "stamps": [M]}``
- ``("save", {"directory": str})`` -> ``{"ok": True}`` (TUM and KITTI
  trajectories, ``global_map.ply``, keyposes PCD, ``loop_constraints.json``)
- ``("stats", {})`` -> counters (and, in the port, the process's kernel
  launches under ``launches``, and the drains whose solve broke down under
  ``broken_drains`` and ``solve_breakdowns``)
- ``("shutdown", {})`` -> stops the server

    python -m scl_slam_tpu_torch.serve --port 7450 [--odometry icp] [--config cfg.yaml] [--device cpu]

Client: :class:`SlamClient` below.
"""
from __future__ import annotations

import argparse
import socket
import threading

import numpy as np

from .runtime.transport import _DECODE_ERRORS, _recv_frame, _send_frame


class SlamServer:
    """Serve one robot's :class:`Mapper` on ``device`` (the card unless
    ``device="cpu"``), with ``odometry="icp"`` an :class:`Odometry` at its
    default configuration on the same device for frames sent without a
    pose. Requests are handled one at a time. The solve throttle reads the
    frames' stamps (the JAX server reads the wall clock), so what the server
    answers does not depend on its speed."""

    def __init__(self, cfg=None, odometry: str = "none", device: str = "cuda"):
        from .config import SlamConfig
        from .runtime import Mapper

        if odometry not in ("none", "icp"):
            raise ValueError(f"odometry must be 'none' or 'icp', got {odometry!r}")
        self.cfg = cfg or SlamConfig()
        self.mapper = Mapper(self.cfg, device=device)
        self.odo = None
        if odometry == "icp":
            from .runtime.odometry import Odometry

            self.odo = Odometry(device=device)
        self._lock = threading.Lock()
        self._frames = 0
        self._loops = 0
        self._stop = threading.Event()
        self.port: int | None = None

    def handle(self, kind: str, payload: dict):
        if kind == "frame":
            xyz = np.asarray(payload["xyz"], np.float32)
            with self._lock:
                self._frames += 1
                if payload.get("pose") is not None:
                    pose = self.mapper._pose_in(payload["pose"])
                elif self.odo is not None:
                    pose, _ = self.odo.step(xyz)
                else:
                    return {"error": "no pose given and odometry disabled"}
                stamp = float(payload.get("stamp", 0.0))
                wire = self.mapper.add_frame(pose, xyz, stamp=stamp)
                loop = None
                if wire is not None:
                    loop = self.mapper.spin_once(now=stamp).get("loop")
                    if loop:
                        self._loops += 1
                K = self.cfg.keyframe.max_keyframes
                st = self.mapper.state
                idx = int(st.counts[self.mapper.robot]) - 1
                slot = self.mapper.robot * K + max(idx, 0)
                T_out = self.mapper._pose_out(st.opt_R[slot], st.opt_t[slot])
                return {"keyframe": wire is not None, "pose": T_out, "loop": loop}
        if kind == "trajectory":
            with self._lock:
                poses, stamps = self.mapper.trajectory_with_stamps(robot=payload.get("robot"))
                return {"poses": poses, "stamps": stamps}
        if kind == "save":
            with self._lock:
                self.mapper.save_trajectories(payload["directory"])
                self.mapper.export_artifacts(payload["directory"])
            return {"ok": True}
        if kind == "stats":
            from .ops import kernels

            with self._lock:
                return {
                    "frames": self._frames,
                    "keyframes": int(self.mapper.state.counts[self.mapper.robot]),
                    "loops": self._loops,
                    # the port's own: this process's kernel launches, and
                    # the drains whose solve broke down with their stages
                    # ("; "-joined: the frame codec carries strings)
                    "launches": dict(kernels.LAUNCHES),
                    "broken_drains": self.mapper.broken_drains,
                    "solve_breakdowns": "; ".join(self.mapper.solve_breakdowns),
                }
        if kind == "shutdown":
            self._stop.set()
            return {"ok": True}
        return {"error": f"unknown request {kind!r}"}

    def serve(self, port: int, host: str = "0.0.0.0", ready=None):
        """Accept clients until a ``shutdown`` request. ``port=0`` binds a
        free port (read back from :attr:`port`); ``ready``, a callable, is
        called once the socket listens."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        self.port = srv.getsockname()[1]
        srv.listen(8)
        srv.settimeout(0.5)
        if ready is not None:
            ready()
        while not self._stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            threading.Thread(target=self._client, args=(conn,), daemon=True).start()
        srv.close()

    def _client(self, conn: socket.socket):
        try:
            while not self._stop.is_set():
                kind, payload = _recv_frame(conn)
                _send_frame(conn, ("resp", self.handle(kind, payload)))
        except (ConnectionError, EOFError, OSError, *_DECODE_ERRORS):
            pass  # a disconnect or a malformed frame: drop the connection
        finally:
            conn.close()


class SlamClient:
    """Blocking client for :class:`SlamServer` (either package's)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7450, timeout: float = 120.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def _call(self, kind: str, payload: dict):
        _send_frame(self.sock, (kind, payload))
        _, resp = _recv_frame(self.sock)
        return resp

    def frame(self, xyz: np.ndarray, pose: np.ndarray | None = None, stamp: float = 0.0):
        return self._call("frame", {"xyz": xyz, "pose": pose, "stamp": stamp})

    def trajectory(self, robot: int | None = None):
        return self._call("trajectory", {"robot": robot})

    def save(self, directory: str):
        return self._call("save", {"directory": directory})

    def stats(self):
        return self._call("stats", {})

    def shutdown(self):
        return self._call("shutdown", {})

    def close(self):
        self.sock.close()


def main(argv=None):
    p = argparse.ArgumentParser(description="scl_slam_tpu_torch serving daemon")
    p.add_argument("--port", type=int, default=7450, help="listen port (0: any free port)")
    p.add_argument("--config", help="YAML config path")
    p.add_argument("--odometry", choices=["none", "icp"], default="none",
                   help="icp: run the scan-to-map ICP front end for frames "
                   "sent without a pose")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the mapper runs (default: the GPU)")
    p.add_argument("--map-every", type=float, default=0.0,
                   help="also export the map to --map-dir every this many seconds")
    p.add_argument("--map-dir", help="directory of the periodic map exports")
    args = p.parse_args(argv)
    cfg = None
    if args.config:
        from .config import load_config

        cfg = load_config(args.config)
    server = SlamServer(cfg, odometry=args.odometry, device=args.device)
    stop_publisher = None
    if args.map_every > 0:
        if not args.map_dir:
            p.error("--map-every needs --map-dir")
        stop_publisher = server.mapper.start_map_publisher(args.map_dir, args.map_every)
    try:
        server.serve(args.port, ready=lambda: print(
            f"scl_slam_tpu_torch serving on :{server.port}", flush=True))
    finally:
        if stop_publisher is not None:
            stop_publisher()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
