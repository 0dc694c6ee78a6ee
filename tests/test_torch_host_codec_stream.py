"""The port's host-codec legs of ``AudioStreamBatch`` (``models/audio_stream.py``:
the library codecs at the RTP boundary around the graph) against the JAX
package's on the CPU. Each fixture runs in both packages in this one
process (the Opus encoder's default complexity follows ``os.cpu_count()``
and ``MS2TPU_OPUS_COMPLEXITY``, so only one process holds both to the same
settings), tick by tick with ``do_tick`` and no wall clock, and compares:

* every payload the sending stream handed its RTP session, with its
  timestamp increment: equal bytes;
* the receiving stream's recording: within 1e-6 of JAX's (the Opus FEC
  lookahead plays a frame late in both, so the recordings line up tick for
  tick without any alignment);
* the JAX test's own bar.

Mirrored: the Opus and GSM ptime aggregation (``tests/test_audio_stream.py``),
the SRTP Opus call, the stereo Opus call, in-band FEC beating PLC under
loss and the QoS loop feeding Opus's expected loss
(``tests/test_crypto_codecs.py``), the Speex stream (``tests/test_speex.py``),
the TMMBR bitrate cap, and the refusal of a codec whose library is missing
(G.729 and BV16 here: their libraries are not installed; the others by a
library handle set to None)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mediastreamer2_tpu.models import audio_stream as j_as  # noqa: E402
from mediastreamer2_tpu.net import netsim as j_netsim  # noqa: E402
from mediastreamer2_tpu.net import rtp as j_rtp  # noqa: E402
from mediastreamer2_tpu.net import rtcp as j_rtcp  # noqa: E402
from mediastreamer2_tpu_torch import Factory  # noqa: E402
from mediastreamer2_tpu_torch.models import audio_stream as t_as  # noqa: E402
from mediastreamer2_tpu_torch.net import netsim as t_netsim  # noqa: E402
from mediastreamer2_tpu_torch.net import rtcp as t_rtcp  # noqa: E402
from mediastreamer2_tpu_torch.net import rtp as t_rtp  # noqa: E402
from mediastreamer2_tpu_torch.ops import aac as t_aac  # noqa: E402
from mediastreamer2_tpu_torch.ops import host_codecs as t_hc  # noqa: E402
from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff  # noqa: E402
from mediastreamer2_tpu_torch.utils.signals import make_speechlike  # noqa: E402

KEY, SALT = bytes(range(16)), bytes(range(100, 114))


def _need(probe):
    if not getattr(t_hc, probe)():
        pytest.skip(f"{probe.split('_')[0]} library missing")


class _Pkg:
    def __init__(self, name, factory):
        self.name = name
        self.mod, self.rtp, self.netsim = (
            (j_as, j_rtp, j_netsim) if name == "jax" else (t_as, t_rtp, t_netsim))
        self.factory = factory
        self.kw = {} if name == "jax" else {"device": "cpu"}

    def stream(self, **kw):
        s = self.mod.AudioStreamBatch(self.factory, 1, **kw, **self.kw)
        s.ticker.realtime = False
        return s


@pytest.fixture(scope="module")
def pkgs(factory):
    return [_Pkg("jax", factory), _Pkg("torch", Factory())]


def _tap(stream):
    """Record every payload the leg-0 session sends, with its ts increment."""
    sent = []
    sess = stream.sessions[0]
    send = sess.send_payload

    def tapped(payload, **kw):
        sent.append((bytes(payload), kw.get("ts_increment")))
        return send(payload, **kw)
    sess.send_payload = tapped
    return sent


def _call(pkg, codec, rate, sig, ticks, extra, channels=1, ptime=None, srtp=False,
          netsim=None, setup=None):
    """tx -> rx over a LoopbackPair, ``ticks + extra`` alternating
    do_ticks; returns (payloads sent, rx recording of leg 0, tx, rx)."""
    tx = pkg.stream(codec=codec, rate=rate, channels=channels, mic_signal=sig)
    rx = pkg.stream(codec=codec, rate=rate, channels=channels, record_ticks=ticks + extra + 20)
    sim = pkg.netsim.NetworkSimulator(pkg.netsim.NetSimParams(**netsim)) if netsim else None
    pair = pkg.rtp.LoopbackPair(netsim=sim)
    tx.set_transport(0, pair.endpoint(0))
    rx.set_transport(0, pair.endpoint(1))
    if srtp:
        tx.enable_srtp(0, KEY, SALT, KEY, SALT)
        rx.enable_srtp(0, KEY, SALT, KEY, SALT)
    if ptime:
        tx.set_ptime(0, ptime)
        assert tx.get_ptime(0) == ptime
    if setup:
        setup(tx)
    sent = _tap(tx)
    tx.ticker.warm_up()
    rx.ticker.warm_up()
    for _ in range(ticks + extra):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
    return sent, rx.get_recording()[0], tx, rx


def _both(pkgs, *args, **kw):
    (js, jr, *_), (ts, tr, tx, rx) = (_call(p, *args, **kw) for p in pkgs)
    assert ts == js and len(ts) > 0
    np.testing.assert_allclose(tr, jr, atol=1e-6)
    return ts, tr, tx, rx


def test_opus_ptime_aggregation(pkgs):
    """test_audio_stream.py::test_opus_ptime_aggregation: ptime 60 packs
    60 ms a packet (6x fewer), the receiver adapts from the packet's own
    duration, and the stream loses nothing on top of the codec's own
    offline 60 ms round trip (within 0.05)."""
    _need("opus_available")
    rate, ticks = 48000, 120
    sig = make_speechlike(480 * ticks, rate, seed=31)
    sent, rec, tx, _ = _both(pkgs, "opus", rate, sig, ticks, 40, ptime=60)
    assert len(sent) <= (ticks + 40) // 6 + 2 and {ts for _, ts in sent} == {2880}
    sim, _ = audio_diff(sig, rec)
    F = rate * 60 // 1000
    enc, dec = t_hc.OpusEncoder(rate=rate), t_hc.OpusDecoder(rate=rate)
    ref = np.concatenate([dec.decode(enc.encode(sig[k * F:(k + 1) * F]), 2 * F)
                          for k in range(len(sig) // F)])
    base, _ = audio_diff(sig[:len(ref)], ref)
    assert sim > base - 0.05, f"stream {sim} vs offline {base}"
    tx.set_ptime(0, 50)                    # not an Opus frame size: clamped down
    assert tx.get_ptime(0) == 40


def test_gsm_ptime_aggregation(pkgs):
    """test_audio_stream.py::test_gsm_ptime_aggregation: 40 ms = two 33-byte
    frames a packet."""
    _need("gsm_available")
    ticks = 120
    sig = make_speechlike(80 * ticks, 8000, seed=32)
    sent, rec, _, _ = _both(pkgs, "gsm", 8000, sig, ticks, 40, ptime=40)
    assert len(sent) <= (ticks + 40) // 4 + 2 and {len(p) for p, _ in sent} == {66}
    sim, _ = audio_diff(sig, rec)
    assert sim > 0.85, f"gsm ptime-40 sim {sim}"


def test_srtp_opus_call(pkgs, monkeypatch):
    """test_crypto_codecs.py::test_srtp_opus_call (complexity 9): the call
    keeps the speech (> 0.85) through SRTP; the plaintext payloads equal."""
    _need("opus_available")
    monkeypatch.setenv("MS2TPU_OPUS_COMPLEXITY", "9")
    rate, ticks = 48000, 100
    sig = make_speechlike(480 * ticks, rate, seed=21)
    sent, rec, tx, _ = _both(pkgs, "opus", rate, sig, ticks, 40, srtp=True)
    sim, _ = audio_diff(sig, rec)
    assert sim > 0.85, f"srtp+opus call sim {sim}"
    assert tx.sessions[0].stats.sent_packets > 80 and tx.secured(0)


def test_stereo_opus_call(pkgs):
    """test_crypto_codecs.py::test_stereo_opus_call: interleaved [B, 2*S]
    blocks through PLC, volume and the recorder; left and right stay
    apart (each tone > 10x the other in its channel)."""
    _need("opus_available")
    rate, ticks = 48000, 80
    t = np.arange(480 * ticks) / rate
    inter = np.stack([0.4 * np.sin(2 * np.pi * 440 * t), 0.4 * np.sin(2 * np.pi * 1320 * t)],
                     axis=1).reshape(-1).astype(np.float32)
    _, rec, tx, _ = _both(pkgs, "opus", rate, inter, ticks, 30, channels=2)
    assert tx.S == 960 and tx.graph.ext_inputs["rtp_rx"][0] == (1, 960)
    rec = rec.reshape(-1, 2)

    def tone(x, f):
        spec = np.abs(np.fft.rfft(x))
        freqs = np.fft.rfftfreq(len(x), 1 / rate)
        return spec[(freqs > f - 30) & (freqs < f + 30)].max()
    assert tone(rec[:, 0], 440) > 10 * tone(rec[:, 0], 1320)
    assert tone(rec[:, 1], 1320) > 10 * tone(rec[:, 1], 440)
    with pytest.raises(ValueError, match="opus or aac"):
        t_as.AudioStreamBatch(Factory(), 1, codec="gsm", channels=2, device="cpu")


def test_opus_inband_fec_beats_plc_under_loss(pkgs, monkeypatch):
    """test_crypto_codecs.py::test_opus_inband_fec_beats_plc_under_loss:
    with 15% loss, a lost frame rebuilt from the next packet's FEC (the
    one-packet lookahead) beats the library's PLC alone (by > 0.01), in
    both packages alike."""
    _need("opus_available")
    monkeypatch.setenv("MS2TPU_OPUS_COMPLEXITY", "9")
    rate, ticks = 48000, 200
    sig = make_speechlike(480 * ticks, rate, seed=33)
    sims = {}
    for fec in (True, False):
        def setup(tx, fec=fec):
            for enc in tx._host_enc:
                if fec:
                    enc.set_packet_loss(15)
                else:
                    enc._ctl(4012, 0)            # OPUS_SET_INBAND_FEC off
        _, rec, _, rx = _both(pkgs, "opus", rate, sig, ticks, 30,
                              netsim={"loss_rate": 15.0, "seed": 12}, setup=setup)
        assert rx.sessions[0].jitter_buffer.lost > 10
        sims[fec], _ = audio_diff(sig, rec)
    assert sims[True] > 0.7, sims
    assert sims[True] > sims[False] + 0.01, sims


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_qos_loop_feeds_opus_loss_expectation(pkgs, pkg):
    """test_crypto_codecs.py::test_qos_loop_feeds_opus_loss_expectation: a
    remote report of 12.5% loss sets the encoder's expected loss to 12 on
    ``iterate()``."""
    _need("opus_available")
    p = pkgs[0] if pkg == "jax" else pkgs[1]
    rtcp = j_rtcp if pkg == "jax" else t_rtcp
    tx = p.stream(codec="opus", rate=48000)
    tx.set_transport(0, p.rtp.LoopbackPair().endpoint(0))
    tx.enable_rtcp(interval_s=100.0)
    calls = []
    tx._host_enc[0].set_packet_loss = calls.append
    tx.sessions[0].rtcp.remote_reports.append(rtcp.ReportBlock(
        ssrc=1, fraction_lost=32, cumulative_lost=10, highest_seq=0, jitter=0, lsr=0, dlsr=0))
    tx.iterate()
    assert calls == [12]


def test_bitrate_cap_retargets_the_host_encoder(pkgs):
    """An inbound TMMBR caps the Opus encoder's bitrate (at least 8 kbit/s),
    as in the JAX stream; the payloads that follow stay equal."""
    _need("opus_available")
    caps = []
    for p in pkgs:
        tx = p.stream(codec="opus", rate=48000)
        tx.on_tmmbr = lambda leg, bps: caps.append((p.name, leg, bps))
        tx._apply_bitrate_cap(0, 12000)
        tx._apply_bitrate_cap(0, 5000)
        assert tx.bitrate_caps == {0: 5000} and tx._host_enc[0].bitrate == 8000
    assert caps == [("jax", 0, 12000), ("jax", 0, 5000), ("torch", 0, 12000), ("torch", 0, 5000)]
    sig = make_speechlike(480 * 60, 48000, seed=5)
    sent, _, _, _ = _both(pkgs, "opus", 48000, sig, 60, 10,
                          setup=lambda tx: tx._apply_bitrate_cap(0, 12000))
    assert np.mean([len(b) for b, _ in sent]) < 20          # ~12 kbit/s at 10 ms


def test_speex_stream_over_rtp(pkgs):
    """test_speex.py::test_speex_stream_over_rtp: ptime 60 packs three 20 ms
    frames into one packet, and the stream matches the codec's own round
    trip (within 0.07)."""
    _need("speex_available")
    assert t_as.PAYLOAD_TYPES["speex"] == 110
    ticks = 120
    sig = make_speechlike(80 * (ticks + 40), 8000, seed=6)
    sent, rec, _, _ = _both(pkgs, "speex", 8000, sig, ticks, 40, ptime=60)
    assert len(sent) <= (ticks + 40) // 6 + 2
    c = t_hc.SpeexCodec(rate=8000)
    F = c.frame_samples * 3
    ref = np.concatenate([c.decode(c.encode(sig[k * F:(k + 1) * F])) for k in range(len(sig) // F)])
    base, _ = audio_diff(sig[:len(ref)], ref)
    sim, _ = audio_diff(sig, rec)
    assert sim > base - 0.07, (sim, base)


# the library handle each codec's classes test, and the name they raise
LIBRARIES = {"opus": (t_hc, "_opus", "libopus"), "gsm": (t_hc, "_gsm", "libgsm"),
             "speex": (t_hc, "_speex", "libspeex"), "g729": (t_hc, "_bcg729", "libbcg729"),
             "bv16": (t_hc, "_bv16", "libbv16"), "aac": (t_aac, "_av", "libavcodec")}
RATES = {"opus": 48000, "speex": 8000, "aac": 16000}


@pytest.mark.parametrize("codec", sorted(LIBRARIES))
def test_missing_library_raises_before_a_graph(monkeypatch, codec):
    """Where a codec's library is missing, the stream raises RuntimeError
    naming it before any graph is built, with no fallback; where it is
    present, the stream is built with a PCM boundary (G.729 and BV16 are
    missing here, the others are made missing)."""
    mod, handle, lib = LIBRARIES[codec]
    rate = RATES.get(codec, 8000)
    present = getattr(mod, handle) is not None and (codec != "bv16" or t_hc.bv16_available())
    if present:
        s = t_as.AudioStreamBatch(Factory(), 2, codec=codec, rate=rate, device="cpu")
        assert s.host_codec and s.graph.ext_inputs["rtp_rx"][1] == torch.float32
        monkeypatch.setattr(mod, handle, None)
    built = []
    monkeypatch.setattr(t_as, "GraphBuilder", lambda *a, **k: built.append(a))
    with pytest.raises(RuntimeError, match=lib):
        t_as.AudioStreamBatch(Factory(), 2, codec=codec, rate=rate, device="cpu")
    assert built == []
    with pytest.raises(ValueError, match="batch edge"):
        t_as.AudioStreamBatch.enable_batch_edge(
            type("S", (), {"host_codec": True})(), None, None, None)
