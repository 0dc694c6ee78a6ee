"""The port's real-time text (``net/rtt.py``, RFC 4103 with RED) against
the JAX package's on the CPU: the three text cases of ``test_sessions.py``
(a clean round trip, RED recovering a single loss, a long paste over SRTP)
run through both packages; the RED payloads of the same typing on the same
clock byte-equal; and seeded loss patterns (single losses and bursts past
the two redundant generations) read the same text, U+FFFD included, in
both sinks."""
import numpy as np
import pytest

from mediastreamer2_tpu.net import rtp as j_rtp
from mediastreamer2_tpu.net import rtt as j_rtt
from mediastreamer2_tpu.net import srtp as j_srtp
from mediastreamer2_tpu_torch.net import rtp as t_rtp
from mediastreamer2_tpu_torch.net import rtt as t_rtt
from mediastreamer2_tpu_torch.net import srtp as t_srtp

PKGS = {"jax": (j_rtt, j_rtp, j_srtp), "torch": (t_rtt, t_rtp, t_srtp)}


@pytest.mark.parametrize("pkg", PKGS)
def test_text_roundtrip_clean(pkg):
    rtt, rtp, _ = PKGS[pkg]
    pair = rtp.LoopbackPair()
    a = rtt.TextStream(rtp.RtpSession(pair.endpoint(0)))
    b = rtt.TextStream(rtp.RtpSession(pair.endpoint(1)))
    msg = "Hello, RTT! éàü 你好"
    for i, ch in enumerate(msg):
        a.put_char(ch)
        a.iterate(now_ms=i * 310)
        b.iterate(now_ms=i * 310)
    a.iterate(now_ms=(len(msg) + 1) * 310)
    b.iterate(now_ms=(len(msg) + 1) * 310)
    assert b.get_received_text() == msg


@pytest.mark.parametrize("pkg", PKGS)
def test_text_red_recovers_single_loss(pkg):
    rtt = PKGS[pkg][0]
    src = rtt.RttSource(use_red=True)
    sink = rtt.RttSink()
    seq = 0
    sent = []
    for i, ch in enumerate("abcdef"):
        src.put_char(ch)
        out = src.flush(now_ms=(i + 1) * 301)
        if out:
            sent.append((seq, *out))
            seq += 1
    for s, pt, payload in sent:          # drop packet index 2, deliver the rest
        if s == 2:
            continue
        sink.on_packet(s, pt, payload)
    assert sink.received == "abcdef"      # RED recovered the lost primary
    assert sink.lost_events == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_text_stream_over_srtp_and_long_paste(pkg):
    """Text tester cases 'slow typing with SRTP' + 'copy paste text longer
    than buffer size': RFC 4103 rides an SRTP transport; long pastes
    deliver completely."""
    rtt, rtp, srtp = PKGS[pkg]
    key, salt = bytes(range(16)), bytes(range(14))
    pair = rtp.LoopbackPair()
    ta = srtp.SrtpTransport(pair.endpoint(0), tx=srtp.SrtpContext(key, salt),
                            rx=srtp.SrtpContext(key, salt))
    tb = srtp.SrtpTransport(pair.endpoint(1), tx=srtp.SrtpContext(key, salt),
                            rx=srtp.SrtpContext(key, salt))
    a = rtt.TextStream(rtp.RtpSession(ta, payload_type=98))
    b = rtt.TextStream(rtp.RtpSession(tb, payload_type=98))
    long_text = "".join(chr(0x41 + (i % 26)) for i in range(600))
    for ch in long_text:
        a.put_char(ch)
    now = 0
    for _ in range(200):                 # buffered flush over time
        now += 310
        a.iterate(now_ms=now)
        b.iterate(now_ms=now)
        if b.get_received_text() == long_text:
            break
    assert b.get_received_text() == long_text
    assert ta.auth_failures == 0 and tb.auth_failures == 0


def _typed(rtt, text, per_flush, use_red=True):
    """``text`` typed ``per_flush`` characters a 310 ms flush, then flushed
    until the source stops: [(payload type, payload)]."""
    src = rtt.RttSource(use_red=use_red)
    out, now, i = [], 0, 0
    while True:
        now += 310
        src.put_text(text[i:i + per_flush])
        i += per_flush
        got = src.flush(now_ms=now)
        if got is None and i >= len(text):
            return out
        if got is not None:
            out.append(got)


@pytest.mark.parametrize("use_red", [True, False], ids=["red", "t140"])
def test_payloads_byte_equal_to_jax(use_red):
    text = "".join(chr(c) for c in np.random.default_rng(3).integers(0x20, 0x7F, 300)) + "é你"
    for per_flush in (1, 3, 17):
        j = _typed(j_rtt, text, per_flush, use_red)
        t = _typed(t_rtt, text, per_flush, use_red)
        assert t == j and len(t) >= len(text) // per_flush


@pytest.mark.parametrize("drop", ["every_7th", "burst_of_3", "random"])
def test_sinks_read_the_same_text_under_loss(drop):
    """The same RED packets, the same ones lost: equal text in both sinks.
    Every 7th packet lost: all text recovered. A burst of 3: one U+FFFD
    where the two generations ran out, in place of the oldest lost
    packet's text."""
    text = "".join(chr(0x61 + i % 26) for i in range(120))
    sent = _typed(t_rtt, text, 3)
    n = len(sent)
    if drop == "every_7th":
        lost = {k for k in range(n) if k % 7 == 6}
    elif drop == "burst_of_3":
        lost = {10, 11, 12}
    else:
        lost = set(np.flatnonzero(np.random.default_rng(4).random(n) < 0.2).tolist())
    got = {}
    for name, rtt in (("jax", j_rtt), ("torch", t_rtt)):
        sink = rtt.RttSink()
        for seq, (pt, payload) in enumerate(sent):
            if seq not in lost:
                sink.on_packet(seq, pt, payload)
        got[name] = (sink.received, sink.lost_events)
    assert got["torch"] == got["jax"]
    if drop == "every_7th":
        assert got["torch"] == (text, 0)
    elif drop == "burst_of_3":
        want = text[:30] + t_rtt.LOSS_CHAR + text[33:]        # packet 10 held chars 30-32
        assert got["torch"] == (want, 1)
