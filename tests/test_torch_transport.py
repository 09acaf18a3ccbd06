"""The port's transport (``scl_slam_tpu_torch/runtime/transport.py``) and
the mapper's thread safety over it: the npz codec against the JAX
package's (a frame of either decodes in the other), ``LocalBus``,
``TcpBus`` between two port mappers on threads of one process, the frame
length cap, a malformed reply counted as a missed verification, and the
in-place state under a bus thread (a serve waits for a write in progress
and never for the state lock).
"""
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

from scl_slam_tpu.runtime import transport as jtransport
from scl_slam_tpu_torch import config as tconfig
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.io import kitti
from scl_slam_tpu_torch.runtime import mapper as M
from scl_slam_tpu_torch.runtime import transport as T

torch.set_num_threads(2)


def _msg(index=0):
    pre = np.eye(4)
    cur = np.eye(4)
    cur[:3, 3] = [1.5, -2.0, 0.25]
    return T.DescriptorMsg(robot=1, index=index, pre_pose=pre, cur_pose=cur,
                           values=np.arange(1200, dtype=np.float32) / 7, stamp=1.5)


def _request():
    rng = np.random.RandomState(0)
    return T.VerifyRequest(
        robot_cur=1, index_cur=4, robot_pre=0, index_pre=2,
        cloud_xyz=rng.normal(size=(64, 3)).astype(np.float32),
        cloud_mask=rng.rand(64) > 0.2, cur_pose_est=np.eye(4),
    )


def _equal(a, b):
    for k, v in vars(a).items():
        w = getattr(b, k)
        if isinstance(v, np.ndarray):
            assert v.dtype == w.dtype and np.array_equal(v, w), k
        else:
            assert v == w, k


def test_codec_round_trip_and_jax_interchange():
    cases = [("desc", _msg()), ("verify", _request()),
             ("verify_resp", T.VerifyResponse(True, np.eye(4), 0.75)),
             ("verify_resp", T.VerifyResponse(False, None, 0.1))]
    for kind, msg in cases:
        frame = T._encode_frame((kind, msg))
        k2, back = T._decode_frame(frame)
        assert k2 == kind and type(back) is type(msg)
        _equal(msg, back)
        # the JAX package decodes the port's frame, and the other way round
        jk, jmsg = jtransport._decode_frame(frame)
        assert jk == kind and type(jmsg).__name__ == type(msg).__name__
        _equal(msg, jmsg)
        pk, pmsg = T._decode_frame(jtransport._encode_frame((kind, jmsg)))
        _equal(msg, pmsg)
    assert T._DECODE_ERRORS == jtransport._DECODE_ERRORS


def test_local_bus_routes_and_skips_sender():
    bus = T.LocalBus()
    got = {0: [], 1: [], 2: []}
    for r in range(3):
        bus.register(r, lambda m, r=r: got[r].append(m),
                     lambda req, r=r: T.VerifyResponse(r == 1, None, float(r)))
    bus.broadcast_descriptor(0, _msg())
    assert [len(got[r]) for r in range(3)] == [0, 1, 1]
    resp = bus.verify(1, _request())
    assert resp.success and resp.inlier_ratio == 1.0


def test_frame_length_cap_refuses_before_reading():
    for n in (T.MAX_FRAME_BYTES + 1, 1 << 63):
        a, b = socket.socketpair()
        with a, b:
            a.sendall(struct.pack("!Q", n) + b"x" * 16)
            with pytest.raises(ConnectionError, match="MAX_FRAME_BYTES"):
                T._recv_frame(b)
    a, b = socket.socketpair()
    with a, b:
        T._send_frame(a, ("desc", _msg()))
        kind, msg = T._recv_frame(b)
        assert kind == "desc" and msg.index == 0


def test_tcp_listener_drops_oversized_frame_and_keeps_serving():
    bus = T.TcpBus(0, 0, {})
    got = []
    bus.register(0, got.append, lambda req: T.VerifyResponse(False, None, 0.0))
    try:
        with socket.create_connection(("127.0.0.1", bus.port), timeout=5) as s:
            s.sendall(struct.pack("!Q", 1 << 62))
            assert s.recv(1) == b""  # the handler closed the connection
        with socket.create_connection(("127.0.0.1", bus.port), timeout=5) as s:
            T._send_frame(s, ("desc", _msg(3)))
        t0 = time.time()
        while not got and time.time() - t0 < 5:
            time.sleep(0.02)
        assert [m.index for m in got] == [3]
    finally:
        bus.close()


# ---------------------------------------------------------------------------
# mappers over the buses
# ---------------------------------------------------------------------------


def _cfg(rid):
    return tconfig.SlamConfig(
        number_of_robots=2, robot_id=rid, robot_name=chr(ord("a") + rid),
        keyframe=tconfig.KeyframeConfig(
            max_keyframes=32, points_per_keyframe=512, raw_points_capacity=4096,
            distance_threshold=2.0,
        ),
        loop=tconfig.LoopConfig(
            near_keyframes=2, submap_capacity=2048, ransac_max_iter=64,
            ransac_inlier_ratio=0.3, ransac_outlier_threshold=1.0,
        ),
        optimizer=tconfig.OptimizerConfig(edge_capacity=128, gn_iters=4, cg_iters=24),
        scan_context=tconfig.ScanContextParams(exclude_recent=10, num_candidates=6),
    )


@pytest.fixture(scope="module")
def world():
    w = kitti.SyntheticWorld(seed=5, extent=100.0, n_clusters=70, pts_per_cluster=800)
    gt = kitti.loop_trajectory(n_frames=80, radius=35.0, revisit=False).astype(np.float32)
    return w, gt, {k: w.scan_at(gt[k], max_points=4096, seed=k) for k in range(14, 34)}


def _feed(m, world, frames):
    _, gt, scans = world
    inter = 0
    for k in frames:
        wire = m.add_frame(se3.Pose(gt[k][:3, :3], gt[k][:3, 3]), scans[k], stamp=0.1 * k)
        if wire is not None:
            m.broadcast_latest(wire)
            inter += bool(m.spin_once(now=0.1 * k).get("inter_loop"))
    return inter


def _wait(cond, timeout=20.0):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < timeout, "timed out"
        time.sleep(0.02)


def _tcp_pair():
    buses = [T.TcpBus(r, 0, {}) for r in range(2)]
    peers = {r: ("127.0.0.1", b.port) for r, b in enumerate(buses)}
    for b in buses:
        b.peers = peers
    mappers = [M.Mapper(_cfg(r), "cpu") for r in range(2)]
    for m, b in zip(mappers, buses):
        m.attach_bus(b)
    return mappers, buses


def test_tcp_bus_between_two_port_mappers(world):
    """Robot a feeds first (its descriptors reach b on b's bus thread),
    then b, whose inter-robot verifications cross the socket to a's serve
    thread; the factors land in both graphs."""
    mappers, buses = _tcp_pair()
    try:
        fa, fb = list(range(14, 26)), list(range(20, 34))
        assert _feed(mappers[0], world, fa) == 0
        _wait(lambda: int(mappers[1].state.counts[0]) == len(fa))
        n_inter = _feed(mappers[1], world, fb)
        _wait(lambda: int(mappers[0].state.counts[1]) == len(fb))
        assert n_inter >= 3
        for m in mappers:
            m.optimize()
            assert [int(c) for c in m.state.counts] == [len(fa), len(fb)]
            assert sum(c["kind"] == "inter" for c in m.loop_constraints()) == n_inter
        # each mapper solves its own copy of the joint graph from its own
        # warm start (a solved once, b after every loop), 4 GN steps each
        ta, tb = mappers[0].trajectory(robot=1), mappers[1].trajectory(robot=1)
        np.testing.assert_allclose(ta[:, :3, 3], tb[:, :3, 3], atol=0.1)
        np.testing.assert_allclose(ta[:, :3, :3], tb[:, :3, :3], atol=1e-2)
    finally:
        for b in buses:
            b.close()


def test_concurrent_feeds_over_tcp_keep_the_state_whole(world):
    """Both robots feed at once on two threads: each one's ingests of the
    other's descriptors (bus thread), its own keyframes and loops (main
    thread) and its serves (bus thread) interleave. Nothing is lost: each
    chain is whole in both mappers and the odometry factors all landed."""
    mappers, buses = _tcp_pair()
    frames = [list(range(14, 26)), list(range(20, 32))]
    errors = []

    def run(r):
        try:
            _feed(mappers[r], world, frames[r])
        except Exception as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        for m in mappers:
            _wait(lambda m=m: [int(c) for c in m.state.counts] == [12, 12])
        for m in mappers:
            m.optimize()
            st = m.state
            idx = st.desc_db.index.numpy()
            assert list(idx[:12]) == list(range(12)) and list(idx[32:44]) == list(range(12))
            n_loops = len(m.loop_constraints())
            assert int(st.graph.num_edges) == 11 + 11 + n_loops
            assert np.isfinite(m.trajectory(robot=0)).all() and np.isfinite(m.trajectory(robot=1)).all()
    finally:
        sys.setswitchinterval(interval)
        for b in buses:
            b.close()


def test_serve_waits_for_a_write_in_progress_and_never_for_the_state_lock(world, monkeypatch):
    """A serve on a bus thread reads the state only under ``_write_lock``:
    while a peer ingest is writing it waits for the write to end. It never
    takes ``_state_lock``, so it completes while another thread holds that
    lock (a robot blocked in its own RPC)."""
    m = M.Mapper(_cfg(0), "cpu")
    m.attach_bus(T.LocalBus())
    _feed(m, world, range(14, 20))
    st = m.state
    P = m.cfg.keyframe.points_per_keyframe
    req = T.VerifyRequest(
        robot_cur=1, index_cur=0, robot_pre=0, index_pre=4,
        cloud_xyz=(st.kf_xyz[5].reshape(P, 3) @ st.opt_R[5].T + st.opt_t[5]).numpy(),
        cloud_mask=st.kf_mask[5].numpy(), cur_pose_est=m._pose_out(st.opt_R[5], st.opt_t[5]),
    )
    baseline = m.serve_verification(req)
    assert baseline.success

    events = []
    in_write = threading.Event()
    real = M._ingest_peer

    def slow_ingest(*a, **k):
        in_write.set()
        time.sleep(0.5)
        events.append("write done")
        return real(*a, **k)

    monkeypatch.setattr(M, "_ingest_peer", slow_ingest)
    msg = _msg(0)
    ingest = threading.Thread(target=m._on_peer_descriptor, args=(msg,))
    ingest.start()
    assert in_write.wait(5)
    out = []
    serve = threading.Thread(target=lambda: (out.append(m.serve_verification(req)), events.append("served")))
    serve.start()
    serve.join(30)
    ingest.join(30)
    assert events == ["write done", "served"]
    assert out[0].success and int(m.state.counts[1]) == 1

    # a thread holding the state lock does not block a serve
    with m._state_lock:
        serve = threading.Thread(target=lambda: out.append(m.serve_verification(req)))
        serve.start()
        serve.join(30)
        assert not serve.is_alive() and out[-1].success
    # the server's copies of the verified factors wait for a locked entry
    # point, which queues them; the next solve adds them to the graph
    assert len(m._pending_server_loops) == 3 and int(m.state.loop_queue.count) == 0
    m.optimize()
    assert m._pending_server_loops == [] and sum(c["kind"] == "inter" for c in m.loop_constraints()) == 3


class _BrokenBus:
    """A bus whose verification reply cannot be decoded."""

    def __init__(self, exc):
        self.exc = exc

    def register(self, *a):
        pass

    def broadcast_descriptor(self, *a):
        pass

    def verify(self, robot, req):
        raise self.exc


@pytest.mark.parametrize("exc", [ValueError("bad npz"), KeyError("x"), ConnectionError("reset")])
def test_failed_verification_rpc_is_a_missed_loop(world, monkeypatch, exc):
    """A reply that does not decode (or a dropped peer) is a missed
    verification: no exception, no factor, and the query re-armed."""
    m = M.Mapper(_cfg(0), "cpu")
    m.attach_bus(_BrokenBus(exc))
    _feed(m, world, [20])
    st = m.state
    img = st.desc_db.descriptors[0].reshape(-1).numpy()
    eye = se3.Pose(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    assert m.ingest_peer_descriptor(1, 0, eye, eye, img)
    assert m.detect_inter_loop() is None
    assert m._inter_dirty and int(m.state.loop_queue.count) == 0


def test_peer_ingest_in_order_only_and_full_block_raises():
    """Out-of-order peer descriptors are dropped (the in-order chain); a
    peer ingest into a full block compacts the block first (eviction),
    and the chain's indices go on counting."""
    cfg = _cfg(0)
    m = M.Mapper(cfg, "cpu")
    wire = np.zeros(20 * 60, np.float32)
    eye = se3.Pose(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    assert not m.ingest_peer_descriptor(1, 5, eye, eye, wire)
    assert m.ingest_peer_descriptor(1, 0, eye, eye, wire)
    assert int(m.state.counts[1]) == 1 and m.next_index(1) == 1 and m.next_index(0) == 0
    for i in range(1, cfg.keyframe.max_keyframes):
        assert m.ingest_peer_descriptor(1, i, eye, eye, wire)
    K = cfg.keyframe.max_keyframes
    assert m.ingest_peer_descriptor(1, K, eye, eye, wire)
    assert int(m.state.counts[1]) <= K and m.next_index(1) == K + 1
    assert len(m._evicted[1]) == K + 1 - int(m.state.counts[1])
    assert len(m.full_trajectory(1)[0]) == K + 1


def test_inter_detect_freshness_gate(world, monkeypatch):
    """The inter query runs only when its inputs changed (a new own
    keyframe or peer descriptor) or after a failed verification, which
    re-arms it (RANSAC draws anew); an idle spin dispatches nothing."""
    calls = [0]
    real = M._detect_inter

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(M, "_detect_inter", counting)
    bus = T.LocalBus()
    ms = [M.Mapper(_cfg(r), "cpu") for r in range(2)]
    for m in ms:
        m.attach_bus(bus)
    m = ms[0]
    _feed(m, world, [20])           # spin_once: empty peer DB
    assert calls[0] == 1
    for _ in range(3):
        assert m.detect_inter_loop() is None
    assert calls[0] == 1
    # a peer descriptor that robot b itself never stored: retrieved here,
    # but b's verification fails (not resident), which re-arms the query
    eye = se3.Pose(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    img = m.state.desc_db.descriptors[0].reshape(-1).numpy().copy()
    assert m.ingest_peer_descriptor(1, 0, eye, eye, img)
    assert m.detect_inter_loop() is None and calls[0] == 2
    assert m._inter_dirty
    m.detect_inter_loop()
    assert calls[0] == 3
    m._inter_dirty = False          # silence the retries
    m.detect_inter_loop()
    assert calls[0] == 3
    _feed(m, world, [22])           # a new own keyframe re-arms it
    assert calls[0] == 4
