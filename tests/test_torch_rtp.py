"""The port's RTP host layer (``net/rtp.py``, ``net/jitter.py``) against the
JAX package's copies: the same packet sequences through both give the
same wire bytes, playout, counters and DTMF. Plain Python on both sides,
so the results must be equal."""
import random
import time

import pytest

from mediastreamer2_tpu.net import jitter as jjit  # noqa: E402
from mediastreamer2_tpu.net import rtp as jrtp  # noqa: E402
from mediastreamer2_tpu.net import netsim as jnetsim  # noqa: E402
from mediastreamer2_tpu_torch.net import jitter as tjit  # noqa: E402
from mediastreamer2_tpu_torch.net import netsim as tnetsim  # noqa: E402
from mediastreamer2_tpu_torch.net import rtp as trtp  # noqa: E402

PACKAGES = {"jax": (jrtp, jjit), "torch": (trtp, tjit)}
JB_COUNTERS = ("late", "lost", "underruns", "resyncs", "discarded", "stretched",
               "_depth_target")


def _scenario(name):
    """(arrival tick, seq, ts) triples of the jitter-buffer tester's
    synthetic cases (tests/test_jitter_scenarios.py) plus a lossy,
    reordered stream."""
    if name == "ts_rollover":
        n, start = 400, (1 << 32) - 80 * 200
        return [(i, 7000 + i, start + 80 * i) for i in range(n)]
    if name == "seq_rollover":
        return [(i, 65_450 + i, 80 * i) for i in range(300)]
    rng = random.Random(7)
    if name == "chaotic_start":
        burst = [(rng.randrange(0, 3), 100 + i, 80 * i) for i in range(30)]
        return burst + [(3 + i, 130 + i, 80 * (30 + i)) for i in range(300)]
    out = []                                       # lossy_reordered
    for i in range(500):
        if rng.random() < 0.05:
            continue
        out.append((i + rng.choice((0, 0, 0, 1, 2, 7)), (40_000 + i) & 0xFFFF, 160 * i))
    return out


def _drive(jit_mod, rtp_mod, packets, algo, ticks_extra=40):
    jb = jit_mod.JitterBuffer(jit_mod.JBParams(min_depth_ticks=2, nom_depth_ticks=4,
                                               max_depth_ticks=50, algorithm=algo,
                                               refresh_ticks=100))
    by_tick = {}
    for tick, seq, ts in packets:
        by_tick.setdefault(tick, []).append((seq, ts))
    playout = []
    for tick in range(max(by_tick) + ticks_extra):
        for seq, ts in by_tick.get(tick, ()):
            jb.put(rtp_mod.RtpPacket(0, seq & 0xFFFF, ts & 0xFFFFFFFF, 1,
                                     (seq & 0xFFFF).to_bytes(2, "big") * 40), now=tick * 0.01)
        playout.append(jb.get_tick())
    return jb, playout


@pytest.mark.parametrize("algo", ["basic", "rls"])
@pytest.mark.parametrize("scenario", ["ts_rollover", "seq_rollover", "chaotic_start",
                                      "lossy_reordered"])
def test_jitter_buffer_matches_jax(scenario, algo):
    packets = _scenario(scenario)
    (jjb, jplay), (tjb, tplay) = (_drive(jit, rtp, packets, algo)
                                  for rtp, jit in PACKAGES.values())
    assert tplay == jplay
    for k in JB_COUNTERS:
        assert getattr(tjb, k) == getattr(jjb, k), k
    played = sum(p is not None for p in tplay)
    if scenario.endswith("rollover"):          # the tester's own bars
        assert tjb.lost == 0 and tjb.late == 0
        assert played >= len(packets) - 10
    elif scenario == "chaotic_start":
        assert played >= 300 - 5 and tjb.lost <= 30


def test_rtp_packet_wire_format_matches_jax():
    for kw in ({}, {"marker": True, "csrcs": (7, 9)},
               {"extensions": {1: b"\x85", 3: b"\x10\x20\x30"}, "csrcs": (5,)}):
        jp = jrtp.RtpPacket(96, 65535, 0xFFFFFFF0, 0xDEADBEEF, b"\x01\x02\x03", **kw)
        tp = trtp.RtpPacket(96, 65535, 0xFFFFFFF0, 0xDEADBEEF, b"\x01\x02\x03", **kw)
        assert tp.pack() == jp.pack()
        assert trtp.RtpPacket.unpack(jp.pack()) == tp
    with pytest.raises(ValueError):
        trtp.RtpPacket.unpack(b"\x80\x00")


def _call(rtp_mod, jit_mod, ticks=120):
    """Two sessions over a LoopbackPair with 10% seeded loss: audio, a
    DTMF digit, DTX gaps, an RFC 6464 level extension; the receiver polls
    and plays out once a tick."""
    random.seed(1234)                        # SSRC, first seq and ts
    ns = jnetsim if rtp_mod is jrtp else tnetsim    # each package's own simulator
    pair = rtp_mod.LoopbackPair(netsim=ns.NetworkSimulator(ns.NetSimParams(loss_rate=10.0,
                                                                           seed=5)))
    tx = rtp_mod.RtpSession(pair.endpoint(0), payload_type=0, clock_rate=8000)
    rx = rtp_mod.RtpSession(pair.endpoint(1), payload_type=0, clock_rate=8000,
                            jitter_buffer=jit_mod.JitterBuffer(jit_mod.JBParams()))
    tx.enable_audio_level_ext(1)
    digits, packets, playout = [], [], []
    rx.on_dtmf = lambda d, v: digits.append((d, v))
    rx.on_packet = lambda p: packets.append((p.seq, p.timestamp, p.ssrc, p.payload,
                                             p.extensions))
    tx.send_dtmf("7", duration_ms=60)
    for t in range(ticks):
        if tx.dtmf_active():
            tx.dtmf_tick(80)
            tx.skip_payload(80)
        elif t % 17 == 5:
            tx.skip_payload(80)              # DTX
        else:
            tx.set_audio_level(t % 128, voice=t % 2 == 0)
            tx.send_payload(bytes([t % 256]) * 80, ts_increment=80)
        rx.poll()
        playout.append(rx.jitter_buffer.get_tick())
    jb = rx.jitter_buffer
    return (packets, playout, digits, vars(tx.stats), vars(rx.stats),
            [getattr(jb, k) for k in JB_COUNTERS], (tx.ssrc, tx.seq, tx.ts))


def test_rtp_session_over_loopback_matches_jax():
    want = _call(jrtp, jjit)
    got = _call(trtp, tjit)
    for a, b, what in zip(got, want, ("packets", "playout", "dtmf", "tx stats",
                                      "rx stats", "jitter counters", "tx clock")):
        assert a == b, what
    packets, playout, digits, tx_stats, rx_stats, counters, _ = got
    assert digits == [("7", 10)]
    assert 0 < rx_stats["recv_packets"] < tx_stats["sent_packets"]   # loss happened
    assert packets[0][4] is not None and 1 in packets[0][4]   # level extension
    assert counters[1] > 0                                    # jb saw the gaps


def test_udp_transport_roundtrip():
    a = trtp.UdpTransport(0)
    b = trtp.UdpTransport(0, remote=("127.0.0.1", a.sock.getsockname()[1]))
    try:
        a.set_remote("127.0.0.1", b.sock.getsockname()[1])
        sa, sb = trtp.RtpSession(a, ssrc=1), trtp.RtpSession(b, ssrc=2)
        got = []
        sa.on_packet = lambda p: got.append((p.ssrc, p.payload))
        for i in range(3):
            sb.send_payload(bytes([i]) * 4, ts_increment=80)
        for _ in range(200):
            sa.poll()
            if len(got) == 3:
                break
            time.sleep(0.001)
        assert got == [(2, bytes([i]) * 4) for i in range(3)]
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("symmetric", [False, True])
def test_udp_transport_learns_the_source_only_when_symmetric(symmetric):
    """Both packages read the same datagrams; a symmetric transport
    re-points its sends at the source of what it received, the other
    keeps the remote it was given."""
    for name, (rtp, _) in PACKAGES.items():
        a, b = rtp.UdpTransport(0), rtp.UdpTransport(0)
        try:
            a.set_remote("127.0.0.1", 9)                 # the discard port
            if symmetric:
                a.set_symmetric()
            b.set_remote("127.0.0.1", a.local_port)
            for i in range(3):
                b.send(bytes([i]) * 8)
            got = []
            for _ in range(200):
                got += a.recv_all()
                if len(got) == 3:
                    break
                time.sleep(0.001)
            assert got == [bytes([i]) * 8 for i in range(3)], name
            assert a.remote == (("127.0.0.1", b.local_port) if symmetric
                                else ("127.0.0.1", 9)), name
        finally:
            a.close()
            b.close()


def test_waiting_features_raise():
    """Nothing of ``net/rtp.py`` waits any more (the bandwidth estimators
    and RTCP: tests/test_torch_rtcp_qos.py; ``replay_capture``:
    tests/test_torch_containers.py; the pump: tests/test_torch_io_pump.py).
    ``attach_pump`` puts the socket on the native pump, and ``close`` takes
    it off again: the pump then raises for it."""
    from mediastreamer2_tpu_torch.native import NativeIoPump
    pump = NativeIoPump()
    t = trtp.UdpTransport()
    try:
        t.attach_pump(pump)
        assert t.recv_all() == []
        sock = t.sock
        t.close()
        with pytest.raises(KeyError, match="never added"):
            pump.read(sock)
    finally:
        t.close()
        pump.close()


def test_bandwidth_meter_and_volumes_match_jax():
    def meter_and_levels(rtp_mod):
        m = rtp_mod.BandwidthMeter(window_s=1.0)
        for i in range(10):
            m.add(100, now=0.1 * i)
        v = rtp_mod.AudioStreamVolumes()
        v.update_from_packet(rtp_mod.RtpPacket(0, 1, 0, 0x10, b"x", csrcs=(0x20,),
                                               extensions={1: bytes([0x80 | 33]),
                                                           3: bytes([40])}))
        return m.bps(now=0.95), sorted(v.items())
    assert meter_and_levels(trtp) == meter_and_levels(jrtp)
