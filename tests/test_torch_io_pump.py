"""The port's native receive pump (``native.NativeIoPump``, ``io_pump.cpp``)
and ``UdpTransport.attach_pump`` on the CPU: the JAX package's
``test_native_stream.py`` and the three pump cases of
``test_native_and_devices.py``, the same datagrams through both packages'
pumps (equal bytes, in order), and the four places where the port's
binding departs from the JAX one: a refused add raises, an unknown socket
raises, a read copies only the bytes it returns, and datagrams longer than
2,048 bytes are counted as truncated.

Nothing here is paced by the wall clock: a test waits, with a deadline,
until the pump's thread has taken what was sent."""
import ctypes
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mediastreamer2_tpu.native import NativeIoPump as JaxPump  # noqa: E402
from mediastreamer2_tpu_torch import Factory, native  # noqa: E402
from mediastreamer2_tpu_torch.models.audio_stream import AudioStreamBatch  # noqa: E402
from mediastreamer2_tpu_torch.native import NativeIoPump  # noqa: E402
from mediastreamer2_tpu_torch.net.jitter import JBParams, JitterBuffer  # noqa: E402
from mediastreamer2_tpu_torch.net.rtp import RtpSession, UdpTransport  # noqa: E402
from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff  # noqa: E402
from mediastreamer2_tpu_torch.utils.signals import make_speechlike  # noqa: E402

S = 80
DEADLINE_S = 2.0


def _drain(transport, want):
    """``transport.recv_all()`` until ``want`` datagrams came or the
    deadline passed."""
    got = []
    end = time.monotonic() + DEADLINE_S
    while len(got) < want and time.monotonic() < end:
        got += transport.recv_all()
        time.sleep(0.001)
    return got


@pytest.fixture
def pump():
    p = NativeIoPump()
    yield p
    p.close()


def test_native_pump_builds():
    assert native.native_available()
    lib = native.build_pump()
    assert lib.parent == native.BUILD_DIR and lib.name.startswith("libms2io_")
    assert native.build_pump() == lib                 # cached by hash: not rebuilt


def test_native_pump_datagram_flow(pump):
    a, b = UdpTransport(), UdpTransport()
    try:
        a.set_remote("127.0.0.1", b.local_port)
        b.attach_pump(pump)
        t0 = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
        for i in range(20):
            a.send(bytes([i]) * 100)
        got = _drain(b, 20)
        assert got == [bytes([i]) * 100 for i in range(20)]
        # the pump's stamp is CLOCK_MONOTONIC nanoseconds
        now = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
        assert t0 <= b.last_recv_ns <= now
        assert pump.dropped(b.sock) == 0 and pump.truncated(b.sock) == 0
    finally:
        a.close()
        b.close()


def test_same_datagrams_through_both_packages_pumps():
    """One sender, two receivers, one on the JAX package's pump and one on
    the port's: the same seeded datagrams (1 to 2,048 bytes) come out of
    both, equal and in order."""
    rng = np.random.default_rng(7)
    sizes = rng.integers(1, 2049, 200)
    sizes[:2] = (1, 2048)
    data = [rng.bytes(int(n)) for n in sizes]
    jpump, tpump = JaxPump(), NativeIoPump()
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(2)]
    try:
        for s in rx:
            s.bind(("127.0.0.1", 0))
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
        jpump.add_socket(rx[0])
        tpump.add_socket(rx[1])
        got = [[], []]
        for k in range(0, len(data), 20):          # a few at a time: no socket overflows
            for d in data[k:k + 20]:
                for s in rx:
                    tx.sendto(d, s.getsockname())
            end = time.monotonic() + DEADLINE_S
            while (len(got[0]) < k + 20 or len(got[1]) < k + 20) and time.monotonic() < end:
                got[0] += [d for _, d in jpump.read(rx[0])]
                got[1] += [d for _, d in tpump.read(rx[1])]
                time.sleep(0.001)
        assert got[1] == got[0] == data
    finally:
        jpump.close()
        tpump.close()
        tx.close()
        for s in rx:
            s.close()


def test_native_pump_rtp_session_integration(pump):
    t1, t2 = UdpTransport(), UdpTransport()
    try:
        t1.set_remote("127.0.0.1", t2.local_port)
        t2.attach_pump(pump)
        tx = RtpSession(t1, payload_type=0)
        rx = RtpSession(t2, payload_type=0)
        rx.jitter_buffer = JitterBuffer(JBParams(nom_depth_ticks=1))
        for _ in range(10):
            tx.send_payload(b"\x00" * 80, ts_increment=80)
        end = time.monotonic() + DEADLINE_S
        while rx.stats.recv_packets < 10 and time.monotonic() < end:
            rx.poll()
            time.sleep(0.001)
        assert rx.stats.recv_packets == 10
    finally:
        t1.close()
        t2.close()


def test_call_over_udp_with_native_pump(pump):
    """The JAX ``test_native_stream.py`` call, unpaced: a one-leg mu-law
    call over real UDP whose receiving socket the pump drains; each tick's
    packet is waited for (with a deadline) before the receiver ticks."""
    ticks = 120
    sig = make_speechlike(S * ticks, 8000, seed=33)
    t_tx, t_rx = UdpTransport(), UdpTransport()
    t_tx.set_remote("127.0.0.1", t_rx.local_port)
    t_rx.set_remote("127.0.0.1", t_tx.local_port)
    t_rx.attach_pump(pump)
    f = Factory()
    tx = AudioStreamBatch(f, 1, mic_signal=sig, device="cpu")
    rx = AudioStreamBatch(f, 1, record_ticks=ticks + 40, device="cpu")
    try:
        tx.set_transport(0, t_tx)
        rx.set_transport(0, t_rx)
        for s in (tx, rx):
            s.ticker.realtime = False
            s.ticker.warm_up()
        sess = rx.sessions[0]
        for _ in range(ticks + 10):
            tx.ticker.do_tick()
            want = sess.stats.recv_packets + 1
            end = time.monotonic() + DEADLINE_S
            while sess.stats.recv_packets < want and time.monotonic() < end:
                sess.poll()
                time.sleep(0.0005)
            rx.ticker.do_tick()
        for _ in range(30):
            rx.ticker.do_tick()
        rec = rx.get_recording()
        sim, _ = audio_diff(sig, rec[0])
        assert sim > 0.9, f"native-pump call sim {sim}"
        assert sess.stats.recv_packets > 100
        assert t_rx.last_recv_ns is not None
        assert pump.dropped(t_rx.sock) == 0
    finally:
        t_tx.close()
        t_rx.close()


# -- where the port departs from the JAX binding ------------------------------
def test_a_refused_add_raises(pump, tmp_path):
    """The JAX ``add_socket`` drops ``epoll_ctl``'s result: a descriptor
    epoll refuses (a regular file: EPERM) is then never read, in silence.
    The port raises, and keeps no queue for it."""
    with open(tmp_path / "not_a_socket", "wb") as bad:
        with pytest.raises(OSError, match="epoll refused"):
            pump.add_socket(bad)
        with pytest.raises(KeyError):
            pump.read(bad)
        j = JaxPump()                     # the JAX binding: no error
        try:
            assert j.add_socket(bad) is None
        finally:
            j.close()


def test_an_unknown_socket_raises(pump):
    """``ms2_pump_read`` returns -1 for a socket the pump does not know;
    the JAX binding turns it into ``[]``, the port raises (and so do the
    counters)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        with pytest.raises(KeyError, match="never added"):
            pump.read(s)
        with pytest.raises(KeyError):
            pump.dropped(s)
        with pytest.raises(KeyError):
            pump.truncated(s)
        j = JaxPump()
        try:
            assert j.read(s) == []
        finally:
            j.close()
        pump.add_socket(s)
        pump.remove_socket(s)         # a removed socket is unknown again
        with pytest.raises(KeyError):
            pump.read(s)
    finally:
        s.close()


def test_a_read_copies_only_what_it_returns(pump, monkeypatch):
    """The JAX ``read`` copies its whole 1 MB buffer (``.raw``) on every
    call. The port's copies the bytes the C side wrote and nothing on an
    empty read; what it returns is the same."""
    copied = []
    string_at = ctypes.string_at

    def counting(addr, size=-1):
        copied.append(size)
        return string_at(addr, size)
    monkeypatch.setattr(ctypes, "string_at", counting)
    a, b = UdpTransport(), UdpTransport()
    try:
        a.set_remote("127.0.0.1", b.local_port)
        b.attach_pump(pump)
        assert b.recv_all() == [] and copied == []
        sizes = (1, 100, 1500)
        for n in sizes:
            a.send(bytes([n % 256]) * n)
        got = _drain(b, len(sizes))
        assert got == [bytes([n % 256]) * n for n in sizes]
        assert sum(copied) == sum(12 + n for n in sizes)      # 8 + 4 bytes of frame each
    finally:
        a.close()
        b.close()


def test_truncated_datagrams_are_counted(pump):
    """A datagram longer than 2,048 bytes is cut to 2,048 in both
    packages; the port counts it (``truncated``) beside ``dropped``."""
    a, b = UdpTransport(), UdpTransport()
    try:
        a.set_remote("127.0.0.1", b.local_port)
        b.attach_pump(pump)
        for n in (2048, 2049, 3000, 10):
            a.send(bytes(range(256)) * (n // 256) + bytes(n % 256))
        got = _drain(b, 4)
        assert [len(d) for d in got] == [2048, 2048, 2048, 10]
        assert pump.truncated(b.sock) == 2 and pump.dropped(b.sock) == 0
    finally:
        a.close()
        b.close()
