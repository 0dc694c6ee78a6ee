"""The port's TURN (``net/turn.py``, ``net/turn_tcp.py``) against the JAX
package's: ports of ``tests/test_turn.py`` and ``tests/test_turn_tcp.py``
against the port's ``MiniTurnServer``, each in-process scenario run
through both packages with the same ``os.urandom`` stream and held to the
same wire bytes; a port client against the JAX server and a JAX client
against the port server; TURN over TCP and over TLS (ten TLS sessions in
a row), and the port's one departure: every read and write of the
connection's socket happens on its receiver thread."""
import os
import random
import socket
import threading
import time

import pytest

from mediastreamer2_tpu.net import ice as jice
from mediastreamer2_tpu.net import turn as jturn
from mediastreamer2_tpu_torch.net import ice as tice
from mediastreamer2_tpu_torch.net import turn as tturn
from mediastreamer2_tpu_torch.net.turn_tcp import TurnTcpConnection, _frame_len
from test_turn_tcp import _self_signed_ctx

PKGS = {"jax": (jturn, jice), "torch": (tturn, tice)}
PEER = ("203.0.113.9", 7000)


@pytest.fixture
def fixed(monkeypatch):
    def reseed(seed):
        random.seed(seed)
        rng = random.Random(seed)
        monkeypatch.setattr(os, "urandom", lambda n: rng.randbytes(n))
    return reseed


def both(fixed, scenario, seed=1):
    out = {}
    for name, (turn, ice) in PKGS.items():
        fixed(seed)
        out[name] = scenario(turn, ice)
    assert out["torch"] == out["jax"]
    return out["torch"]


def _wire(client_mod, server, log=None, auth=True):
    """A client of ``client_mod`` wired in-process to ``server``; every
    datagram in either direction is logged."""
    to_server = []
    log = [] if log is None else log
    kw = dict(username="alice", password="pw", realm="ms2") if auth else {}
    client = client_mod.TurnClient(send_fn=lambda d: (log.append(("c", d)),
                                                      to_server.append(d)), **kw)

    def reply(d):
        log.append(("s", d))
        client.handle(d)

    def pump():
        while to_server:
            server.handle(to_server.pop(0), reply=reply)
    return client, pump, reply, log


def test_allocate_with_auth_retry(fixed):
    def scenario(turn, ice):
        srv = turn.MiniTurnServer(require_auth=True, username="alice", password="pw")
        client, pump, _, log = _wire(turn, srv)
        allocated = []
        client.on_allocated = allocated.append
        client.allocate()
        pump()
        pump()
        return client.state, client.relayed_addr, client.mapped_addr, allocated, \
            client.lifetime, log
    state, relay, mapped, allocated, lifetime, _ = both(fixed, scenario)
    assert state == "allocated" and relay == ("198.51.100.1", 50000)
    assert mapped == ("192.0.2.1", 40000) and allocated == [relay] and lifetime == 600


def test_permission_send_channel_and_data(fixed):
    """Permissions, Send indications, channel binding both ways, and an
    unsolicited Data indication."""
    def scenario(turn, ice):
        srv = turn.MiniTurnServer()
        client, pump, reply, log = _wire(turn, srv)
        got = []
        client.on_data = lambda d, p: got.append((d, p))
        client.allocate(); pump()
        client.create_permission(PEER); pump()
        client.send_to_peer(PEER, b"hello relay"); pump()
        ch = client.channel_bind(PEER); pump()
        client.send_to_peer(PEER, b"chan-data"); pump()
        srv.inject_from_peer(PEER, b"from-peer", reply=reply)
        srv.inject_from_peer(("203.0.113.5", 9000), b"unsolicited", reply=reply)
        return srv.permissions, srv.peer_rx, srv.channels, ch, got, log
    perms, peer_rx, channels, ch, got, _ = both(fixed, scenario)
    assert PEER in perms and channels[ch] == PEER
    assert peer_rx == [(PEER, b"hello relay"), (PEER, b"chan-data")]
    assert got == [(b"from-peer", PEER), (b"unsolicited", ("203.0.113.5", 9000))]


def test_relay_candidate_for_ice(fixed):
    def scenario(turn, ice):
        srv = turn.MiniTurnServer()
        client, pump, _, _ = _wire(turn, srv)
        cands = []
        client.on_allocated = lambda addr: cands.append(ice.Candidate.make(addr[0], addr[1],
                                                                           "relay"))
        client.allocate(); pump()
        return [(c.typ, c.priority, c.host, c.port) for c in cands]
    cands = both(fixed, scenario)
    assert cands and cands[0][0] == "relay" and cands[0][1] >> 24 == 0


def test_ice_through_turn_relay(fixed):
    """A TURN relay candidate feeds the ICE check list and connectivity
    checks run through the relay (Send out, Data in) until nomination."""
    def scenario(turn, ice):
        srv = turn.MiniTurnServer()
        a_sess = ice.IceSession(controlling=True)
        b_sess = ice.IceSession(controlling=False)
        a_sess.set_remote_credentials(b_sess.local_ufrag, b_sess.local_pwd)
        b_sess.set_remote_credentials(a_sess.local_ufrag, a_sess.local_pwd)
        b_addr = ("203.0.113.9", 7000)
        to_server = []
        tc = turn.TurnClient(send_fn=to_server.append, username="alice", password="pw",
                             realm="ms2")

        def pump():
            while to_server:
                srv.handle(to_server.pop(0), reply=tc.handle)

        def a_send(addr, data):
            tc.send_to_peer(addr, data)
            pump()
        a_cl = a_sess.add_check_list(a_send, ("10.0.0.1", 4444))
        b_cl = b_sess.add_check_list(
            lambda addr, data: srv.inject_from_peer(b_addr, data, reply=tc.handle), b_addr)
        relayed = []
        tc.on_allocated = relayed.append
        tc.allocate(); pump()
        relay = relayed[0]
        tc.on_data = lambda data, peer: a_cl.handle_stun(data, peer)
        tc.create_permission(b_addr); pump()
        a_cl.local_candidates = [ice.Candidate.make(*relay, "relay")]
        a_cl.add_remote_candidate(ice.Candidate.make(*b_addr))
        b_cl.add_remote_candidate(ice.Candidate.make(*relay, "relay"))
        now = 100.0
        for _ in range(200):
            now += 0.06
            a_cl.process(now=now)
            b_cl.process(now=now)
            while srv.peer_rx:
                peer, data = srv.peer_rx.pop(0)
                if peer == b_addr:
                    b_cl.handle_stun(data, relay)
            if a_cl.state == ice.IS_COMPLETED and b_cl.state == ice.IS_COMPLETED:
                break
        return (a_cl.state, b_cl.state, relay,
                (a_cl.selected.local.host, a_cl.selected.local.port), b_cl.selected.remote.typ)
    a_state, b_state, relay, local, remote_typ = both(fixed, scenario)
    assert a_state == b_state == tice.IS_COMPLETED
    assert local == relay and remote_typ in ("relay", "prflx")


def test_permission_and_allocation_refresh_lifecycle(fixed):
    def scenario(turn, ice):
        srv = turn.MiniTurnServer()
        client, pump, _, _ = _wire(turn, srv)
        client.allocate(); pump()
        t0 = client._allocated_at
        peer_b = ("203.0.113.10", 7001)
        client.create_permission(PEER); pump()
        client.create_permission(peer_b); pump()
        sent = []
        real = client.send_fn
        client.send_fn = lambda d: (sent.append(d), real(d))
        steps = []
        for now, drop in ((10.0, None), (0.85 * client.PERMISSION_LIFETIME_S, None),
                          (2 * 0.85 * client.PERMISSION_LIFETIME_S, peer_b), (1020.0, None),
                          (1030.0, None)):
            if drop:
                client.drop_peer(drop)
            sent.clear()
            client.maintain(now=t0 + now)
            steps.append([d[:2] for d in sent])
            if now != 1030.0:
                pump()
        return steps, client.state
    steps, state = both(fixed, scenario)
    assert steps[0] == [] and len(steps[1]) == 2
    assert steps[2].count(b"\x00\x08") == 1            # the dropped peer is not refreshed
    assert steps[3].count(b"\x00\x04") == 1 and steps[4].count(b"\x00\x04") == 1
    assert state == "allocated"


@pytest.mark.parametrize("client_pkg, server_pkg", [("torch", "jax"), ("jax", "torch")])
def test_client_and_server_of_the_two_packages(client_pkg, server_pkg):
    """A port client against the JAX server and a JAX client against the port
    server: authenticated allocation, permission, channel data both ways."""
    turn_c, turn_s = PKGS[client_pkg][0], PKGS[server_pkg][0]
    srv = turn_s.MiniTurnServer(require_auth=True, username="alice", password="pw")
    client, pump, reply, _ = _wire(turn_c, srv)
    client.allocate(); pump(); pump()
    assert client.state == "allocated" and client.relayed_addr == ("198.51.100.1", 50000)
    client.create_permission(PEER); pump()
    ch = client.channel_bind(PEER); pump()
    client.send_to_peer(PEER, b"odd")
    pump()
    got = []
    client.on_data = lambda d, p: got.append((d, p))
    srv.inject_from_peer(PEER, b"back", reply=reply)
    assert PEER in srv.permissions and srv.channels[ch] == PEER
    assert srv.peer_rx == [(PEER, b"odd")] and got == [(b"back", PEER)]


# -- TURN over TCP / TLS (tests/test_turn_tcp.py) ----------------------------------
class TcpTurnServer:
    """The port's MiniTurnServer behind a real TCP (or TLS) listener with
    stream framing."""

    def __init__(self, ssl_ctx=None):
        self.inner = tturn.MiniTurnServer(require_auth=True, username="alice", password="pw")
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.bind(("127.0.0.1", 0))
        self.listener.listen(1)
        self.port = self.listener.getsockname()[1]
        self.ssl_ctx = ssl_ctx
        self.conn = None
        self._lock = threading.Lock()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        try:
            conn, _ = self.listener.accept()
            if self.ssl_ctx is not None:
                conn = self.ssl_ctx.wrap_socket(conn, server_side=True)
        except OSError:
            return
        conn.settimeout(0.1)
        self.conn = conn
        buf = b""
        while True:
            try:
                with self._lock:
                    chunk = conn.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            while True:
                n = _frame_len(buf)
                if n is None or n < 0:
                    break
                frame, buf = buf[:n], buf[n:]
                self.inner.handle(frame, reply=self._reply)

    def _reply(self, data: bytes):
        if data and 0x40 <= data[0] <= 0x7F:
            data += b"\x00" * ((-len(data)) % 4)
        with self._lock:                   # one TLS socket, two threads: one at a time
            self.conn.sendall(data)

    def inject_from_peer(self, peer, data):
        self.inner.inject_from_peer(peer, data, reply=self._reply)

    def close(self):
        for s in (self.listener, self.conn):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self.thread.join(timeout=2.0)


class _Traced:
    """A socket whose reads and writes note the thread that makes them."""

    def __init__(self, sock, threads):
        self._sock, self._threads = sock, threads

    def __getattr__(self, name):
        return getattr(self._sock, name)

    def sendall(self, data):
        self._threads.add(threading.get_ident())
        return self._sock.sendall(data)

    def recv(self, n):
        self._threads.add(threading.get_ident())
        return self._sock.recv(n)


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


def _run_turn_session(ssl_ctx=None, io_threads=None):
    srv = TcpTurnServer(ssl_ctx)
    conn = TurnTcpConnection("127.0.0.1", srv.port, use_tls=ssl_ctx is not None)
    if io_threads is not None:            # the thread of every socket read and write
        conn.sock = _Traced(conn.sock, io_threads)
    client = tturn.TurnClient(send_fn=conn.send, username="alice", password="pw", realm="ms2")
    conn.on_frame = client.handle
    conn.start()
    try:
        client.allocate()
        assert _wait(lambda: client.state == "allocated"), client.state
        assert client.relayed_addr == ("198.51.100.1", 50000)
        ch = client.channel_bind(PEER)
        assert _wait(lambda: srv.inner.channels.get(ch) == PEER)
        client.send_to_peer(PEER, b"odd-len")             # 7 bytes: needs TCP padding
        assert _wait(lambda: srv.inner.peer_rx and srv.inner.peer_rx[-1] == (PEER, b"odd-len"))
        got = []
        client.on_data = lambda d, p: got.append((d, p))
        srv.inject_from_peer(PEER, b"from-peer")
        assert _wait(lambda: got == [(b"from-peer", PEER)])
        assert conn.protocol_errors == 0
        return conn._thread.ident
    finally:
        conn.close()
        srv.close()


def test_turn_over_tcp():
    io_threads = set()
    rx_thread = _run_turn_session(io_threads=io_threads)
    # departure from the JAX module: send() queues, the receiver thread writes
    assert io_threads == {rx_thread}


def test_turn_over_tls_ten_times():
    """TLS allocation and relay, ten sessions in a row, each passing; every
    read and write of the TLS socket on the receiver thread."""
    ctx = _self_signed_ctx()
    for _ in range(10):
        io_threads = set()
        rx_thread = _run_turn_session(ctx, io_threads)
        assert io_threads == {rx_thread}


def test_stream_reassembly_from_trickle():
    """Frames split at arbitrary byte boundaries reassemble correctly."""
    frames = []
    conn = TurnTcpConnection.__new__(TurnTcpConnection)
    conn._buf = b""
    conn.on_frame = frames.append
    conn.frames_rx = 0
    conn.protocol_errors = 0
    stun_msg = b"\x00\x01\x00\x08" + b"\x21\x12\xa4\x42" + b"\x00" * 12 \
        + b"\x00\x09\x00\x04" + b"\x00\x00\x00\x00"
    chan = b"\x40\x00\x00\x05" + b"hello" + b"\x00\x00\x00"
    stream = stun_msg + chan
    for i in range(len(stream)):
        conn._feed(stream[i:i + 1])
    assert frames == [stun_msg, chan] and conn.protocol_errors == 0
    conn._feed(b"\xff\x00\x00\x00")                      # not STUN, not ChannelData
    assert conn.protocol_errors == 1 and conn._buf == b""
