"""The port's RTCP (``net/rtcp.py``), bandwidth estimators (``net/bwe.py``),
QoS controllers (``models/qos.py``) and the audio stream's RTCP, ``iterate``
and encryption-mandatory paths on the CPU, against the JAX package where
bytes or decisions can be compared (exactly: tolerance 0), and against the
bars of ``tests/test_rtcp_rtt.py``, ``test_bwe.py``, ``test_adaptive.py``
and ``test_srtp_mandatory.py`` elsewhere. Also: importing the whole port
loads no jax, no JAX package and no ``cryptography``."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mediastreamer2_tpu.models import qos as jqos  # noqa: E402
from mediastreamer2_tpu.net import bwe as jbwe  # noqa: E402
from mediastreamer2_tpu.net import rtcp as jrtcp  # noqa: E402
from mediastreamer2_tpu_torch import Factory  # noqa: E402
from mediastreamer2_tpu_torch.models import qos  # noqa: E402
from mediastreamer2_tpu_torch.models.audio_stream import AudioStreamBatch  # noqa: E402
from mediastreamer2_tpu_torch.net import bwe, rtcp  # noqa: E402
from mediastreamer2_tpu_torch.net.jitter import JBParams, JitterBuffer  # noqa: E402
from mediastreamer2_tpu_torch.net.netsim import NetSimParams, NetworkSimulator  # noqa: E402
from mediastreamer2_tpu_torch.net.rtp import LoopbackPair, RtpSession  # noqa: E402
from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff  # noqa: E402
from mediastreamer2_tpu_torch.utils.signals import make_speechlike  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 80


# -- wire bytes equal the JAX package's -----------------------------------------
def _messages(mod):
    rb = [mod.ReportBlock(0x1111, 25, 1000, 0x10020, 33, 0xAABBCCDD, 0x12345),
          mod.ReportBlock(0x2222, 0, 0, 7, 0, 0, 0)]
    return {
        "sr": mod.SenderReport(0xABCDEF01, 3900000000, 0x80000000, 16000, 100, 8000, rb),
        "rr": mod.ReceiverReport(0x1234, rb[:1]),
        "sdes": mod.Sdes(0x1234, cname="leg@host", tool="ms2"),
        "xr": mod.pack_xr(0x1234, [
            mod.XrVoipMetrics(0x1111, loss_rate=12, round_trip_delay_ms=80, mos_lq=41).pack(),
            mod.XrReceiverReferenceTime(0x0123456789ABCDEF).pack(),
            mod.XrDlrr([(0x1111, 0x22223333, 0x4444)]).pack(),
            mod.XrStatSummary(0x1111, 10, 200, lost=3, max_jitter=9).pack()]),
        **{f"fb_{kind}": mod.Feedback(kind, 0xA, 0xB, value, data) for kind, value, data in (
            ("tmmbr", 256000, b""), ("remb", 1_500_000, b""), ("nack", 4242, b""),
            ("pli", 0, b""), ("fir", 3, b""), ("sli", mod.sli_value(100, 5, 33), b""),
            ("rpsi", 96, b"\x81\x23"))},
    }


@pytest.mark.parametrize("name", sorted(_messages(rtcp)))
def test_packed_bytes_equal_jax(name):
    got, want = _messages(rtcp)[name], _messages(jrtcp)[name]
    got = got if isinstance(got, bytes) else got.pack()
    want = want if isinstance(want, bytes) else want.pack()
    assert got == want and len(got) % 4 == 0
    # and both parsers read them alike
    assert repr(rtcp.parse_compound(got)) == repr(jrtcp.parse_compound(got))


# -- tests/test_rtcp_rtt.py -----------------------------------------------------
def test_interarrival_jitter_tracks_variance():
    pair = LoopbackPair()
    tx = RtpSession(pair.endpoint(0), payload_type=0, clock_rate=8000)
    rx = RtpSession(pair.endpoint(1), payload_type=0, clock_rate=8000)
    for i in range(30):
        tx.send_payload(b"x" * 80, ts_increment=80 if i % 2 == 0 else 240)
        rx.poll()
    assert rx.jitter_units > 0 and rx.jitter_ms > 0


def test_rtcp_rtt_measurement():
    pair = LoopbackPair()
    a = RtpSession(pair.endpoint(0), payload_type=0)
    b = RtpSession(pair.endpoint(1), payload_type=0)
    a.jitter_buffer = JitterBuffer(JBParams(nom_depth_ticks=1))
    b.jitter_buffer = JitterBuffer(JBParams(nom_depth_ticks=1))
    ra, rb = a.attach_rtcp(interval_s=0.0), b.attach_rtcp(interval_s=0.0)
    for _ in range(3):
        a.send_payload(b"m" * 80, 80)
    b.poll()
    ra.maybe_emit(a.transport)           # a's SR; b reads it
    b.poll()
    time.sleep(0.03)
    rb._next_emit = 0
    rb.maybe_emit(b.transport)           # b's SR with a report block on a
    a.poll()
    assert ra.last_rtt_ms is not None and 0.0 <= ra.last_rtt_ms < 200.0
    assert ra.remote_reports and ra.remote_reports[-1].ssrc == a.ssrc


def test_rtcp_bye_on_teardown():
    a = AudioStreamBatch(Factory(), 1, device="cpu")
    b = AudioStreamBatch(Factory(), 1, device="cpu")
    pair = LoopbackPair()
    a.set_transport(0, pair.endpoint(0))
    b.set_transport(0, pair.endpoint(1))
    a.enable_rtcp(interval_s=100.0)
    b.enable_rtcp(interval_s=100.0)
    a.ticker.realtime = b.ticker.realtime = False
    for _ in range(5):
        a.ticker.do_tick()
        b.ticker.do_tick()
    a.stop()
    b.ticker.do_tick()                   # drains the BYE
    assert getattr(b.sessions[0].rtcp, "bye_received", False)


def test_sli_rpsi_feedback_roundtrip():
    sli = rtcp.Feedback("sli", 0xA, 0xB, rtcp.sli_value(first=100, number=5, picture_id=33))
    msgs = rtcp.parse_compound(sli.pack())
    assert len(msgs) == 1 and msgs[0].kind == "sli"
    w = msgs[0].value
    assert (w >> 19, (w >> 6) & 0x1FFF, w & 0x3F) == (100, 5, 33)
    rpsi = rtcp.Feedback("rpsi", 0xA, 0xB, 96, b"\x81\x23")
    msgs = rtcp.parse_compound(rpsi.pack())
    assert len(msgs) == 1 and msgs[0].kind == "rpsi"
    assert msgs[0].value == 96 and msgs[0].data == b"\x81\x23"


# -- tests/test_bwe.py ----------------------------------------------------------
def test_video_estimator_unit():
    bw = 1_000_000.0
    ests = []
    for mod in (bwe, jbwe):
        vbe = mod.VideoBandwidthEstimator()
        t = 0.0
        for frame in range(10):
            for k in range(8):
                vbe.on_packet(t, 1200, frame * 3000, marker=(k == 7))
                t += 1200 * 8 / bw
            t += 0.033
        assert vbe.frames_measured == 10
        ests.append(vbe.available_bw_bps())
    assert 0.85 * bw < ests[0] < 1.15 * bw and ests[0] == ests[1]


def test_video_estimator_ignores_small_frames():
    vbe = bwe.VideoBandwidthEstimator(bwe.BweParams(packet_count_min=5))
    for frame in range(10):
        for k in range(2):
            vbe.on_packet(frame * 0.03 + k * 0.001, 1200, frame * 3000, marker=(k == 1))
    assert vbe.available_bw_bps() == 0.0


def test_audio_estimator_unit():
    bw = 24_000.0
    ests = []
    for mod in (bwe, jbwe):
        abe = mod.AudioBandwidthEstimator()
        t, seq = 0.0, 100
        for i in range(100):
            abe.on_packet(t, 92, seq)
            if i % 10 == 9:
                t += 0.0001
                assert abe.on_packet(t, 92, seq)          # the duplicate
                t += 92 * 8 / bw
            else:
                t += 0.02
            seq += 1
        assert abe.duplicates_seen == 10
        ests.append(abe.available_bw_bps())
    assert 0.85 * bw < ests[0] < 1.15 * bw and ests[0] == ests[1]


def test_controller_uses_estimate():
    sent = []
    bc = qos.BandwidthController(sent.append)
    bc.update_estimate(100_000, kind="video")
    for _ in range(6):
        bc.on_interval(10_000, 1.0, jitter_rising=True, loss_rate=0.06)
    assert bc.congested and sent[-1] == 70_000
    bc.on_interval(10_000, 1.0, jitter_rising=False, loss_rate=0.0)
    assert not bc.congested and sent[-1] == 90_000


def test_qos_state_machines_match_jax():
    """The analyzers, the audio bitrate driver and the quality indicator
    take the JAX package's decisions on one seeded run of interval stats."""
    rng = np.random.default_rng(3)
    stats = [(float(rng.choice([0.0, 0.005, 0.04, 0.15])), float(rng.uniform(20, 900)),
              float(rng.uniform(0, 30))) for _ in range(60)]
    runs = []
    for mod in (qos, jqos):
        out = []
        for analyzer in (mod.SimpleQosAnalyzer(), mod.StatefulQosAnalyzer()):
            rates, ptimes = [], []
            ctl = mod.BitrateController(analyzer, mod.AudioBitrateDriver(
                rates.append, ptimes.append, nominal_bps=64000))
            qi = mod.QualityIndicator()
            acts = [ctl.update(mod.QosStats(loss_rate=l, rtt_ms=r, jitter_ms=j))
                    for l, r, j in stats]
            for l, r, j in stats:
                qi.update(mod.QosStats(loss_rate=l, rtt_ms=r))
            out.append((acts, rates, ptimes, qi.rating, qi.lq_rating))
        lim, starter = mod.IFrameRequestLimiter(2.0), mod.VideoStarter(2.0)
        starter.activate(now=0.0)
        out.append(([lim.request_allowed(now=t) for t in (0.0, 1.0, 2.5, 3.0, 5.0)],
                    [starter.need_iframe(now=t) for t in (1.0, 2.5, 3.0, 5.0)]))
        runs.append(out)
    assert runs[0] == runs[1]
    assert {a for a in runs[0][0][0]} >= {qos.ACTION_DECREASE_BITRATE,
                                          qos.ACTION_DECREASE_PACKET_RATE}


# -- tests/test_adaptive.py on a device codec --------------------------------------
def _pair_streams(ticks, netsim=None, seed=3, interval=0.0, record_ticks=None):
    sig = make_speechlike(S * ticks, 8000, seed=seed)
    tx = AudioStreamBatch(Factory(), 1, mic_signal=sig, device="cpu")
    rx = AudioStreamBatch(Factory(), 1, record_ticks=record_ticks or ticks, device="cpu")
    pair = LoopbackPair(netsim=netsim)
    tx.set_transport(0, pair.endpoint(0))
    rx.set_transport(0, pair.endpoint(1))
    tx.enable_rtcp(interval_s=interval)
    rx.enable_rtcp(interval_s=interval)
    tx.ticker.realtime = rx.ticker.realtime = False
    return tx, rx, pair


def test_rtcp_feedback_drives_bitrate_down():
    """Port of test_adaptive.py::test_rtcp_feedback_drives_bitrate_down on
    G.711 (a device codec): 18% loss both ways; the receiver's reports
    reach the sender's bitrate controller through iterate(), and the
    quality indicator drops."""
    ticks = 200
    tx, rx, _ = _pair_streams(ticks, NetworkSimulator(NetSimParams(loss_rate=18.0, seed=5)))
    rates, ptimes = [], []
    ctl = qos.BitrateController(qos.SimpleQosAnalyzer(),
                                qos.AudioBitrateDriver(rates.append, ptimes.append,
                                                       nominal_bps=64000))
    tx.attach_bitrate_controller(0, ctl)
    qi = qos.QualityIndicator()
    tx.attach_quality_indicator(0, qi)
    for t in range(ticks):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
        if t % 10 == 9:
            tx.iterate()
            rx.iterate()
    assert rates or ptimes, "controller never acted on RTCP feedback"
    if rates:
        assert rates[-1] < 64000
    assert qi.rating < 4.5
    assert rx.sessions[0].stats.recv_packets > 50


def test_tmmbr_caps_through_on_tmmbr():
    """A TMMBR from the receiver reaches the sender's on_tmmbr and
    bitrate_caps through iterate() (media_stream_process_rtcp)."""
    tx, rx, pair = _pair_streams(40, interval=100.0)
    caps = []
    tx.on_tmmbr = lambda leg, bps: caps.append((leg, bps))
    for _ in range(20):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
    pair.endpoint(1).send(rtcp.Feedback("tmmbr", rx.sessions[0].ssrc, tx.sessions[0].ssrc,
                                        24000).pack())
    tx.ticker.do_tick()
    tx.iterate()
    assert caps and caps[-1][0] == 0 and caps[-1][1] in range(20000, 29000)
    assert tx.bitrate_caps[0] == caps[-1][1]


def test_stream_bandwidth_controller_wiring():
    """attach_bandwidth_controller: the leg's audio estimator (duplicate
    clusters from the sender) feeds the controller in iterate()."""
    tx, rx, _ = _pair_streams(60, interval=100.0)
    tx.sessions[0].enable_audio_bandwidth_estimator()
    tx.sessions[0].set_abe_duplicates(True)
    sent = []
    bc = qos.BandwidthController(sent.append)
    rx.attach_bandwidth_controller(0, bc)
    assert rx.sessions[0].abe is not None
    for _ in range(60):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
    rx.iterate()
    est = bc.download_audio_bandwidth_available_estimated
    assert est > 0 and rx.sessions[0].abe.duplicates_seen > 0
    for _ in range(6):
        bc.on_interval(800, 1.0, jitter_rising=True, loss_rate=0.06)
    assert sent and abs(sent[-1] - max(0.7 * est, 16000)) < 1


def test_srtp_legs_report_rtt_and_quality():
    """enable_srtp + enable_rtcp + a quality indicator on one leg, as the
    chip run's phase 8b: SRTCP reports flow both ways, the RTT is known and
    the rating stays high without loss; get_srtp_info / secured say so.
    The two sides iterate five ticks apart, so each report answers the
    other side's latest SR (an RTT needs the LSR of the sender's last SR)."""
    from mediastreamer2_tpu_torch.net.srtp import sdes_generate, sdes_parse
    tx, rx, _ = _pair_streams(120, record_ticks=130)
    _, k1, s1 = sdes_parse("1 " + sdes_generate()[0])
    _, k2, s2 = sdes_parse("1 " + sdes_generate()[0])
    tx.enable_srtp(0, k1, s1, k2, s2)
    rx.enable_srtp(0, k2, s2, k1, s1)
    assert tx.secured(0) and tx.get_srtp_info(0) == ("AES_CM_128_HMAC_SHA1_80", "sdes")
    qi = qos.QualityIndicator()
    tx.attach_quality_indicator(0, qi)
    for t in range(125):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
        if t % 10 == 4:
            rx.iterate()
        if t % 10 == 9:
            tx.iterate()
    assert tx.sessions[0].rtcp.last_rtt_ms is not None
    assert rx.sessions[0].rtcp.last_rtt_ms is not None
    assert qi.rating >= 4.5
    assert tx.sessions[0].transport.auth_failures == 0
    assert rx.sessions[0].transport.auth_failures == 0
    sim, _ = audio_diff(make_speechlike(S * 120, 8000, seed=3), rx.get_recording()[0])
    assert sim > 0.9


# -- tests/test_srtp_mandatory.py -----------------------------------------------
KEY, SALT = bytes(range(16)), bytes(range(16, 30))
KEY2, SALT2 = bytes(range(100, 116)), bytes(range(50, 64))


def _mandatory_call(ticks, seed, tx_mandatory, rx_mandatory, keys=None, rekey_at=None):
    """tests/test_srtp_mandatory.py's lockstep call: ``ticks`` of speech,
    ``ticks + 30`` ticks run, ``ticks + 40`` recorded."""
    tx, rx, _ = _pair_streams(ticks, seed=seed, interval=100.0, record_ticks=ticks + 40)
    if tx_mandatory:
        tx.set_encryption_mandatory(0)
    if rx_mandatory:
        rx.set_encryption_mandatory(0)
    if keys:
        for s in (tx, rx):
            s.enable_srtp(0, *keys, *keys)
    for t in range(ticks + 30):
        if t == rekey_at:
            for s in (tx, rx):
                s.enable_srtp(0, KEY2, SALT2, KEY2, SALT2)
        tx.ticker.do_tick()
        rx.ticker.do_tick()
    sig = make_speechlike(S * ticks, 8000, seed=seed)
    return tx, rx, audio_diff(sig, rx.get_recording()[0])[0]


def test_mandatory_blocks_cleartext_send():
    tx, rx, _ = _mandatory_call(50, 1, True, False)
    assert tx.get_encryption_mandatory(0)
    assert rx.sessions[0].stats.recv_packets == 0
    assert tx.sessions[0].mandatory_dropped >= 40 and tx.sessions[0].stats.sent_packets == 0


def test_mandatory_drops_inbound_plaintext():
    tx, rx, sim = _mandatory_call(50, 2, False, True)
    assert tx.sessions[0].stats.sent_packets >= 40
    assert rx.sessions[0].stats.recv_packets == 0 and rx.sessions[0].mandatory_dropped >= 40
    assert sim < 0.5


def test_mandatory_stream_with_srtp():
    tx, rx, sim = _mandatory_call(100, 3, True, True, keys=(KEY, SALT))
    assert sim > 0.9, f"mandatory srtp sim {sim}"
    assert tx.sessions[0].mandatory_dropped == 0


def test_mandatory_key_change():
    tx, rx, sim = _mandatory_call(120, 4, True, True, keys=(KEY, SALT), rekey_at=60)
    assert sim > 0.85, f"mandatory rekey sim {sim}"
    assert tx.sessions[0].mandatory_dropped == 0
    rec = rx.get_recording()[0]
    assert float(np.abs(rec[:len(rec) // 2]).max()) > 0.01
    assert float(np.abs(rec[len(rec) // 2:]).max()) > 0.01


# -- the port's imports ----------------------------------------------------------
def test_importing_the_port_loads_no_jax_and_no_cryptography():
    """Every module of the port (the gateway's among them: the codecs,
    Baudot, flow control, the bridge, the transcoder and the ring stream),
    imported in a fresh interpreter, leaves jax, the JAX package and
    cryptography out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mediastreamer2_tpu_torch as m\n"
        "for info in pkgutil.walk_packages(m.__path__, m.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'mediastreamer2_tpu', 'cryptography'))\n"
        "bad += ['missing ' + n for n in ('ops.adpcm', 'ops.g726', 'ops.baudot',\n"
        "        'ops.flowcontrol', 'utils.itc', 'models.transcode', 'models.ring_stream')\n"
        "        if 'mediastreamer2_tpu_torch.' + n not in sys.modules]\n"
        "print(len([n for n in sys.modules if n.startswith('mediastreamer2_tpu_torch')]), bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-S", "-c", f"import sys; sys.path[:0] = "
                          f"{sys.path!r}\n" + code],
                         cwd=REPO, capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.split(" ", 1)
    assert int(count) > 30 and bad.strip() == "[]", res.stdout
