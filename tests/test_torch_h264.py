"""The port's avcodec codecs (``mediastreamer2_tpu_torch/ops/h264.py``:
H.264, H.265 and the legacy family through ctypes with the probed ABI)
against the JAX package's on the CPU: the same frames and settings give
byte-equal access units and equal decoded frames; and the JAX
``tests/test_h264_stream.py`` and ``tests/test_h265.py`` cases on the port
(calls over RTP, FIR recovery under loss, NACK retransmission, a capture
read back through the packetizer). Skipped where libavcodec or a codec in
it is missing."""
import numpy as np
import pytest

from mediastreamer2_tpu.ops import h264 as jh

from mediastreamer2_tpu_torch import Factory, Format
from mediastreamer2_tpu_torch.models.video_stream import H264Packetizer, VideoStreamBatch
from mediastreamer2_tpu_torch.net.netsim import NetSimParams, NetworkSimulator
from mediastreamer2_tpu_torch.net.rtp import LoopbackPair, RtpPacket
from mediastreamer2_tpu_torch.ops import h264 as th

pytestmark = pytest.mark.skipif(not th.h264_available(), reason="libx264/avcodec unavailable")


def _frames(w, h, n, step, seed):
    base = (np.random.default_rng(seed).random((h, w)) * 255).astype(np.uint8)
    return [(np.roll(base, k * step, axis=1).tobytes() + bytes([128] * (w * h // 4)) * 2)
            for k in range(n)]


@pytest.mark.parametrize("kind", ["h264", "h265"])
def test_access_units_byte_equal_jax(kind):
    if kind == "h265" and not th.h265_available():
        pytest.skip("libx265/hevc unavailable")
    Enc, Dec = ("H264Encoder", "H264Decoder") if kind == "h264" else ("H265Encoder",
                                                                      "H265Decoder")
    encs = getattr(th, Enc)(128, 96, 400_000, 25), getattr(jh, Enc)(128, 96, 400_000, 25)
    decs = getattr(th, Dec)(), getattr(jh, Dec)()
    for k, frame in enumerate(_frames(128, 96, 10, 3, seed=0)):
        got, want = (e.encode(frame, keyframe=(k in (0, 6))) for e in encs)
        assert got == want
        assert decs[0].decode(got) == decs[1].decode(want)


def test_h264_codec_roundtrip_quality():
    w, h = 128, 96
    enc, dec = th.H264Encoder(w, h, bitrate_bps=400_000, fps=25), th.H264Decoder()
    got = None
    frames = _frames(w, h, 10, 3, seed=0)
    for k, frame in enumerate(frames):
        for out in dec.decode(enc.encode(frame, keyframe=(k == 0))):
            got = (k, out)
    k, out = got
    y_ref = np.frombuffer(frames[k][: w * h], np.uint8).astype(np.float32)
    y_out = np.frombuffer(out[: w * h], np.uint8).astype(np.float32)
    assert 10 * np.log10(255 ** 2 / np.mean((y_ref - y_out) ** 2)) > 28


@pytest.mark.parametrize("name,size", [("h263", (176, 144)), ("mpeg4", (128, 96)),
                                       ("mjpeg", (128, 96)), ("theora", (128, 96)),
                                       ("snow", (320, 240))])
def test_legacy_ffmpeg_codecs_byte_equal_jax(name, size):
    if not th.legacy_codec_available(name):
        pytest.skip(f"{name} unavailable")
    w, h = size
    pair = []
    for m in (th, jh):
        Enc, Dec = m.make_legacy_codec(name)
        enc = Enc(w, h, bitrate_bps=800_000, fps=10, gop=5)
        if name == "theora":                 # out-of-band stream headers
            dec = Dec(extradata=m.encoder_extradata(enc))
        elif name == "snow":                 # dims out of band
            dec = Dec(dims=(w, h))
        else:
            dec = Dec()
        pair.append((enc, dec))
    frames = _frames(w, h, 6, 2, seed=3)
    got = None
    for k, frame in enumerate(frames):
        data, want = (e.encode(frame, keyframe=(k == 0)) for e, _ in pair)
        assert data == want
        outs = pair[0][1].decode(data)
        assert outs == pair[1][1].decode(want)
        for out in outs:
            got = (k, out)
    assert got is not None, f"{name}: nothing decoded"
    k, out = got
    assert len(out) == w * h * 3 // 2
    y_ref = np.frombuffer(frames[k][: w * h], np.uint8).astype(np.float32)
    y_out = np.frombuffer(out[: w * h], np.uint8).astype(np.float32)
    assert 10 * np.log10(255 ** 2 / max(np.mean((y_ref - y_out) ** 2), 1e-9)) > 22


def _call(codec, fmt, ticks, netsim=None, nack=False, fir_interval=None):
    f = Factory()
    tx = VideoStreamBatch(f, 1, fmt=fmt, fps=fmt.fps, codec=codec, device="cpu")
    rx = VideoStreamBatch(f, 1, fmt=fmt, fps=fmt.fps, codec=codec, device="cpu")
    pair = LoopbackPair(netsim=netsim)
    tx.set_transport(0, pair.endpoint(0))
    rx.set_transport(0, pair.endpoint(1))
    if nack:
        tx.enable_nack(0)
        rx.enable_nack(0)
    tx.bind_assemblers()
    rx.bind_assemblers()
    if fir_interval:
        rx.fir_limiters[0].min_interval_s = fir_interval
    tx.ticker.realtime = rx.ticker.realtime = False
    tx.ticker.warm_up()
    rx.ticker.warm_up()
    for _ in range(ticks):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
    return tx, rx


@pytest.mark.parametrize("codec", ["h264", "h265"])
def test_call_mire_to_display(codec):
    if codec == "h265" and not th.h265_available():
        pytest.skip("libx265/hevc unavailable")
    size = (128, 96) if codec == "h264" else (64, 64)
    tx, rx = _call(codec, Format(kind="yuv420", width=size[0], height=size[1], fps=25.0),
                   80 if codec == "h264" else 100)
    assert tx.stats[0].frames_sent >= 15
    assert rx.stats[0].frames_received >= 8
    assert np.abs(rx._last_rx[0]).mean() > 0.05


def test_h264_fir_recovery_under_loss():
    ns = NetworkSimulator(NetSimParams(loss_rate=25.0, seed=3))
    tx, rx = _call("h264", Format(kind="yuv420", width=128, height=96, fps=25.0), 100,
                   netsim=ns, fir_interval=0.3)
    assert rx.packetizers[0].dropped_incomplete > 0
    ns.p.loss_rate = 0.0
    before = rx.stats[0].frames_received
    for _ in range(200):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
    assert rx.stats[0].frames_received - before >= 10
    assert rx.stats[0].fir_sent > 0


def test_h264_nack_retransmission_recovers_frames():
    fmt = Format(kind="yuv420", width=128, height=96, fps=25.0)
    tx, rx = _call("h264", fmt, 200, netsim=NetworkSimulator(NetSimParams(loss_rate=10.0, seed=5)),
                   nack=True)
    assert rx.stats[0].frames_received >= tx.stats[0].frames_sent * 0.6
    _, rx2 = _call("h264", fmt, 200, netsim=NetworkSimulator(NetSimParams(loss_rate=10.0, seed=5)))
    assert rx.stats[0].frames_received > rx2.stats[0].frames_received


def test_h264_capture_read_back_equal_jax(tmp_path):
    """An H.264 RTP stream written as a pcap (one NAL a packet where it
    fits, FU-A beyond) read back by both packages' capture readers,
    depacketized by their ``H264Packetizer``s and decoded: the same access
    units and frames; the last AU, with no packet after it to close it,
    flushed by ``_close_au``."""
    from mediastreamer2_tpu.io.pcap import read_capture as j_read
    from mediastreamer2_tpu.models.video_stream import H264Packetizer as JH264Packetizer
    from mediastreamer2_tpu.net.rtp import RtpPacket as JRtpPacket
    from mediastreamer2_tpu_torch.io.pcap import CapturedPacket, read_capture, write_pcap
    enc = th.H264Encoder(128, 96, 300_000, 25)
    pk = H264Packetizer(mtu=1000)
    caps, seq = [], 500
    for k, frame in enumerate(_frames(128, 96, 12, 4, seed=9)):
        chunks = pk.pack(enc.encode(frame, keyframe=(k == 0)))
        for i, c in enumerate(chunks):
            pkt = RtpPacket(96, seq & 0xFFFF, 3600 * k, 0x1234, c,
                            marker=(i == len(chunks) - 1 and k != 11))
            caps.append(CapturedPacket(0.04 * k, pkt.pack()))
            seq += 1
    path = str(tmp_path / "h264.pcap")
    write_pcap(path, caps)
    results = []
    for read, Pk, Pkt, Dec in ((read_capture, H264Packetizer, RtpPacket, th.H264Decoder),
                               (j_read, JH264Packetizer, JRtpPacket, jh.H264Decoder)):
        p, dec, aus, frames = Pk(mtu=1400), Dec(), [], []
        for cp in read(path):
            p.push(Pkt.unpack(cp.udp_payload))
            while (au := p.pop()) is not None:
                aus.append(au)
                frames += dec.decode(au)
        p._close_au()
        au = p.pop()
        aus.append(au)
        frames += dec.decode(au)
        results.append((aus, frames, dec.width, dec.height))
    assert results[0] == results[1]
    aus, frames, w, h = results[0]
    assert len(aus) == 12 and len(frames) >= 11 and (w, h) == (128, 96)
