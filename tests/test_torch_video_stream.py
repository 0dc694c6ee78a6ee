"""The port's video stream (``mediastreamer2_tpu_torch/models/video_stream.py``)
on the CPU: the JAX package's ``tests/test_video_stream.py`` run on the
port, a 4-leg call through both packages side by side, and the port's
own rules (the card by default, missing libraries raise naming them)."""
import numpy as np
import pytest
import torch

from mediastreamer2_tpu_torch import Factory, Format
from mediastreamer2_tpu_torch.models import video_stream as t_vs
from mediastreamer2_tpu_torch.models.video_stream import (FrameAssembler, VideoStreamBatch,
                                                          fragment_frame)
from mediastreamer2_tpu_torch.net.netsim import NetSimParams, NetworkSimulator
from mediastreamer2_tpu_torch.net.rtp import LoopbackPair, RtpPacket, RtpSession, UdpTransport
from mediastreamer2_tpu_torch.ops import av1 as t_av1
from mediastreamer2_tpu_torch.ops import h264 as t_h264
from mediastreamer2_tpu_torch.ops import vp8 as t_vp8


@pytest.fixture(scope="module")
def tfactory():
    return Factory()


def _vs(factory, B, fmt, **kw):
    return VideoStreamBatch(factory, B, fmt=fmt, fps=fmt.fps, device="cpu", **kw)


def _pair(tx, rx, legs=1, netsim=None, wrap_rx=lambda t: t):
    for leg in range(legs):
        pair = LoopbackPair(netsim=netsim)
        tx.set_transport(leg, pair.endpoint(0))
        rx.set_transport(leg, wrap_rx(pair.endpoint(1)))
    tx.bind_assemblers()
    rx.bind_assemblers()
    for s in (tx, rx):
        s.ticker.realtime = False
        s.ticker.warm_up()


def _run(ticks, *streams):
    for _ in range(ticks):
        for s in streams:
            s.ticker.do_tick()


def _skip_without_vp8():
    if not t_vp8.vp8_available():
        pytest.skip("libvpx missing")


def test_fragment_and_reassemble():
    data = bytes(range(256)) * 40          # 10240 bytes
    chunks = fragment_frame(data, mtu=1400)
    assert all(len(c) <= 1400 for c in chunks)
    asm = FrameAssembler()
    for k, c in enumerate(chunks):
        asm.push(RtpPacket(97, 100 + k, 5555, 1, c, marker=(k == len(chunks) - 1)))
    assert asm.pop() == data


def test_reassembler_drops_incomplete():
    chunks = fragment_frame(b"x" * 5000, mtu=1400)
    asm = FrameAssembler()
    for k, c in enumerate(chunks):
        if k == 1:
            continue                        # lose a middle fragment
        asm.push(RtpPacket(97, k, 777, 1, c, marker=(k == len(chunks) - 1)))
    assert asm.pop() is None
    assert asm.dropped_incomplete == 1


@pytest.mark.parametrize("first", [65534, 65500, 0])
def test_reassembler_keeps_a_frame_across_the_seq_wrap(first):
    """The departure: a frame whose packets span the 16-bit sequence wrap
    (a random initial sequence number puts the wrap inside some frame) is
    whole in the port; the JAX package's assembler sorts the raw numbers
    and drops it as incomplete. Reordered fragments still assemble, and a
    lost one still drops the frame."""
    from mediastreamer2_tpu.models.video_stream import FrameAssembler as JaxAssembler
    data = bytes(range(256)) * 20
    chunks = fragment_frame(data, mtu=600)
    pkts = [RtpPacket(97, (first + k) & 0xFFFF, 900, 1, c, marker=(k == len(chunks) - 1))
            for k, c in enumerate(chunks)]
    wraps = first + len(chunks) > 0x10000
    for order in (pkts, pkts[1:2] + pkts[:1] + pkts[2:]):
        asm, jasm = FrameAssembler(), JaxAssembler()
        for p in order:
            asm.push(p)
            jasm.push(p)
        assert asm.pop() == data and asm.dropped_incomplete == 0
        assert (jasm.pop() is None) == wraps and jasm.dropped_incomplete == int(wraps)
    asm = FrameAssembler()
    for p in pkts[:2] + pkts[3:]:
        asm.push(p)
    assert asm.pop() is None and asm.dropped_incomplete == 1


def test_reassembler_interframe_seq_gap():
    asm = FrameAssembler()
    for k, (seq, ts) in enumerate([(10, 100), (11, 200)]):
        asm.push(RtpPacket(97, seq, ts, 1, b"f%d" % k, marker=True))
    assert asm.seq_gaps == 0 and asm.dropped_incomplete == 0
    asm.push(RtpPacket(97, 14, 500, 1, b"later", marker=True))   # 12-13 lost
    assert asm.seq_gaps == 1 and asm.dropped_incomplete == 0
    assert asm.pop() == b"f0"
    asm.reset_continuity()                  # a fresh session's seq space
    asm.push(RtpPacket(97, 40000, 600, 1, b"new", marker=True))
    assert asm.seq_gaps == 1


def test_video_call_mire_to_display(tfactory):
    fmt = Format(kind="yuv420", width=64, height=48, fps=25.0)
    tx, rx = _vs(tfactory, 2, fmt), _vs(tfactory, 2, fmt)
    _pair(tx, rx, legs=2)
    _run(60, tx, rx)
    assert tx.stats[0].frames_sent >= 10
    assert rx.stats[0].frames_received >= 5
    assert np.abs(rx._last_rx[0]).mean() > 0.05


def test_video_call_under_loss_counts_incomplete(tfactory):
    fmt = Format(kind="yuv420", width=64, height=48, fps=25.0)
    tx, rx = _vs(tfactory, 1, fmt), _vs(tfactory, 1, fmt)
    _pair(tx, rx, netsim=NetworkSimulator(NetSimParams(loss_rate=20.0, seed=7)))
    _run(80, tx, rx)
    assert rx.assemblers[0].dropped_incomplete > 0
    assert rx.stats[0].frames_received > 0


def test_video_bundle_aggregator_multi_ssrc():
    pair = LoopbackPair()
    shape = (24 * 3 // 2, 32)
    rxr = t_vs.VideoBundleReceiver(pair.endpoint(1), frame_shape=shape)
    senders = [RtpSession(pair.endpoint(0), payload_type=97, ssrc=0x100 + k, clock_rate=90000)
               for k in range(3)]
    rng = np.random.default_rng(5)
    frames = {s.ssrc: (rng.random(shape) * 255).astype(np.uint8) for s in senders}
    for _ in range(3):
        for s in senders:
            chunks = fragment_frame(frames[s.ssrc].tobytes(), 512)
            s.ts += 3600
            for i, c in enumerate(chunks):
                s.send_payload(c, ts_increment=0, marker=(i == len(chunks) - 1))
        rxr.poll()
    got = rxr.latest_frames()
    assert sorted(got) == [0x100, 0x101, 0x102]
    for ssrc, frame in got.items():
        np.testing.assert_array_equal(frame, frames[ssrc])
    assert all(b["frames_received"] >= 2 for b in rxr.branches.values())


def test_preview_only_graph(tfactory):
    vs = _vs(tfactory, 1, Format(kind="yuv420", width=64, height=48, fps=25.0))
    vs.ticker.realtime = False
    vs.ticker.warm_up()
    _run(30, vs)
    assert vs.sessions == [None]
    assert int(vs.ticker.state["cam"]["frame_idx"][0]) == 30


class _DropFirstN:
    """Transport filter: swallow the first N delivered packets."""

    def __init__(self, inner, n):
        self.inner, self.n = inner, n

    def send(self, data):
        self.inner.send(data)

    def recv_all(self):
        out = self.inner.recv_all()
        while self.n > 0 and out:
            out.pop(0)
            self.n -= 1
        return out

    def close(self):
        self.inner.close()


def test_first_iframe_lost_recovers_via_starter(tfactory):
    _skip_without_vp8()
    fmt = Format(kind="yuv420", width=64, height=48, fps=10.0)
    tx, rx = _vs(tfactory, 1, fmt, codec="vp8"), _vs(tfactory, 1, fmt, codec="vp8")
    rx.fir_limiters[0].min_interval_s = 0.2
    _pair(tx, rx, wrap_rx=lambda t: _DropFirstN(t, 4))
    _run(150, tx, rx)
    assert rx.stats[0].fir_sent > 0
    assert rx.stats[0].frames_received >= 5


def test_video_codec_change_over_reclaimed_sessions(tfactory):
    fmt = Format(kind="yuv420", width=64, height=48, fps=10.0)
    tx1, rx1 = _vs(tfactory, 1, fmt), _vs(tfactory, 1, fmt)
    _pair(tx1, rx1)
    _run(30, tx1, rx1)
    assert rx1.stats[0].frames_received >= 2
    tx_sess, rx_sess = tx1.reclaim_sessions()[0], rx1.reclaim_sessions()[0]
    ssrc = tx_sess.ssrc
    _skip_without_vp8()
    tx2, rx2 = _vs(tfactory, 1, fmt, codec="vp8"), _vs(tfactory, 1, fmt, codec="vp8")
    tx2.ticker.warm_up()
    rx2.ticker.warm_up()
    tx2.adopt_session(0, tx_sess)
    rx2.adopt_session(0, rx_sess)
    tx2.bind_assemblers()
    rx2.bind_assemblers()
    tx2.ticker.realtime = rx2.ticker.realtime = False
    _run(60, tx2, rx2)
    assert rx2.stats[0].frames_received >= 3
    assert tx_sess.ssrc == ssrc


def test_video_stats_getters(tfactory):
    fmt = Format(kind="yuv420", width=64, height=48, fps=10.0)
    tx, rx = _vs(tfactory, 1, fmt), _vs(tfactory, 1, fmt)
    _pair(tx, rx)
    _run(100, tx, rx)
    assert 7.0 <= tx.get_sent_framerate(0) <= 11.0
    assert rx.get_received_framerate(0) > 5.0
    assert tx.get_sent_video_size() == (64, 48)
    assert rx.get_received_video_size(0) == (64, 48)


@pytest.mark.parametrize("name", ["h263", "mpeg4", "theora", "snow"])
def test_legacy_codec_calls_h263_mpeg4(tfactory, name):
    if not t_h264.legacy_codec_available(name):
        pytest.skip(f"{name} missing from avcodec")
    fmt = Format(kind="yuv420", width=176, height=144, fps=10.0)
    tx, rx = _vs(tfactory, 1, fmt, codec=name), _vs(tfactory, 1, fmt, codec=name)
    _pair(tx, rx)
    _run(80, tx, rx)
    assert tx.stats[0].frames_sent >= 5, name
    assert rx.stats[0].frames_received >= 3, name
    assert np.abs(rx._last_rx[0]).mean() > 0.05, name


def test_video_iterate_applies_tmmbr(tfactory):
    _skip_without_vp8()
    from mediastreamer2_tpu_torch.models.video_presets import VideoQualityController
    from mediastreamer2_tpu_torch.net.rtcp import Feedback
    fmt = Format(kind="yuv420", width=64, height=48, fps=25.0)
    tx, rx = _vs(tfactory, 1, fmt, codec="vp8"), _vs(tfactory, 1, fmt, codec="vp8")
    pair = LoopbackPair()
    tx.set_transport(0, pair.endpoint(0))
    rx.set_transport(0, pair.endpoint(1))
    tx.sessions[0].attach_rtcp()
    rx.sessions[0].attach_rtcp()
    applied = []
    tx.attach_quality_controller(VideoQualityController(applied.append))
    tx.bind_assemblers()
    rx.bind_assemblers()
    tx.ticker.realtime = rx.ticker.realtime = False
    _run(20, tx, rx)
    fb = Feedback("tmmbr", rx.sessions[0].ssrc, tx.sessions[0].ssrc, 150_000)
    pair.endpoint(1).send(fb.pack())
    tx.ticker.do_tick()
    tx.iterate()
    assert tx.stats[0].bitrate_cap == 150_000
    assert applied and applied[-1].bitrate_bps <= 150_000
    _run(20, tx, rx)
    assert rx.stats[0].frames_received > 0


def test_rx_keyframe_sniff():
    kf = t_vs._rx_is_keyframe
    assert kf("vp8", bytes([0x10, 0, 0, 1, 2])) is True
    assert kf("vp8", bytes([0x11, 0, 0, 1, 2])) is False
    assert kf("h264", b"\x00\x00\x00\x01\x65" + b"\x00" * 8) is True
    assert kf("h264", b"\x00\x00\x00\x01\x41" + b"\x00" * 8) is False
    assert kf("h265", b"\x00\x00\x01" + bytes([19 << 1, 1]) + b"\x00" * 8) is True
    assert kf("h265", b"\x00\x00\x01" + bytes([1 << 1, 1]) + b"\x00" * 8) is False
    assert kf("mjpeg", b"\xff\xd8\xff") is None
    assert kf("vp8", b"") is None


def test_fir_latch_survives_limiter_window(tfactory):
    _skip_without_vp8()
    vs = _vs(tfactory, 1, Format(kind="yuv420", width=64, height=48, fps=25.0), codec="vp8")
    t = UdpTransport()
    t.set_remote("127.0.0.1", t.local_port)      # self-loop
    vs.set_transport(0, t)
    vs.bind_assemblers()
    vs.ticker.realtime = False
    vs.ticker.warm_up()
    _run(12, vs)
    assert vs.stats[0].frames_received > 0
    vs._await_kf_rx[0] = True
    vs.fir_limiters[0]._last = vs._now_s()            # window just opened
    fir0 = vs.stats[0].fir_sent
    vs.ticker.do_tick()
    assert vs.stats[0].fir_sent == fir0               # suppressed, latched
    assert vs._await_kf_rx[0]
    for _ in range(int(vs.fir_limiters[0].min_interval_s / 0.01) + 30):
        vs.ticker.do_tick()
        if not vs._await_kf_rx[0]:
            break
    assert vs.stats[0].fir_sent > fir0
    assert not vs._await_kf_rx[0]
    t.close()


def test_four_leg_call_equal_jax(tfactory, factory):
    """4 + 4 legs for 30 ticks, a 128x96 mire sent at 64x48 over
    LoopbackPair with 10% loss, through the JAX package and through the
    port: equal frames received and lost, received frames within one u8
    code, ``frame_mean`` within 1e-5 on every tick."""
    from mediastreamer2_tpu.core.block import Format as JFormat
    from mediastreamer2_tpu.models.video_stream import VideoStreamBatch as JVideoStreamBatch
    from mediastreamer2_tpu.net.netsim import (NetSimParams as JNetSimParams,
                                               NetworkSimulator as JNetworkSimulator)
    from mediastreamer2_tpu.net.rtp import LoopbackPair as JLoopbackPair
    B, ticks = 4, 30
    out = []
    for Vs, Fmt, Pair, Sim, Params, fac, kw in (
            (JVideoStreamBatch, JFormat, JLoopbackPair, JNetworkSimulator, JNetSimParams,
             factory, {}),
            (VideoStreamBatch, Format, LoopbackPair, NetworkSimulator, NetSimParams,
             tfactory, {"device": "cpu"})):
        fmt = Fmt(kind="yuv420", width=128, height=96, fps=25.0)
        small = Fmt(kind="yuv420", width=64, height=48, fps=25.0)
        tx = Vs(fac, B, fmt=fmt, out_fmt=small, fps=25.0, **kw)
        rx = Vs(fac, B, fmt=fmt, out_fmt=small, fps=25.0, **kw)
        for leg in range(B):
            pair = Pair(netsim=Sim(Params(loss_rate=10.0, seed=leg)))
            tx.set_transport(leg, pair.endpoint(0))
            rx.set_transport(leg, pair.endpoint(1))
        tx.bind_assemblers()
        rx.bind_assemblers()
        means = []
        rx.ticker.event_queue.set_handler("display.frame_mean",
                                          lambda ev: means.append((ev.tick, ev.leg, ev.value)))
        for s in (tx, rx):
            s.ticker.realtime = False
            s.ticker.warm_up()
        frames = []
        for _ in range(ticks):
            tx.ticker.do_tick()
            rx.ticker.do_tick()
            rx.ticker.event_queue.pump()
            frames.append(rx._last_rx_u8.copy())
        out.append(([s.frames_received for s in rx.stats], [s.frames_sent for s in tx.stats],
                    [a.dropped_incomplete for a in rx.assemblers], np.stack(frames), means))
    (jrx, jtx, jdrop, jframes, jmeans), (trx, ttx, tdrop, tframes, tmeans) = out
    assert trx == jrx and ttx == jtx and tdrop == jdrop
    assert min(trx) >= 3 and sum(jdrop) > 0
    diff = np.abs(tframes.astype(np.int16) - jframes.astype(np.int16))
    assert diff.max() <= 1 and tframes.max() > 0
    assert [m[:2] for m in tmeans] == [m[:2] for m in jmeans] and len(tmeans) > 0
    np.testing.assert_allclose([m[2] for m in tmeans], [m[2] for m in jmeans], rtol=0, atol=1e-5)


def test_tx_frames_equal_jax_at_vga_to_qvga(tfactory, factory):
    """The u8 boundary at the phase-12 shape: a VGA mire sent at QVGA,
    two legs, five ticks; the tx frames of both packages within one code."""
    from mediastreamer2_tpu.core.block import Format as JFormat
    from mediastreamer2_tpu.models.video_stream import VideoStreamBatch as JVideoStreamBatch
    got = []
    for Vs, Fmt, fac, kw in ((JVideoStreamBatch, JFormat, factory, {}),
                             (VideoStreamBatch, Format, tfactory, {"device": "cpu"})):
        vs = Vs(fac, 2, fmt=Fmt(kind="yuv420", width=640, height=480, fps=25.0),
                out_fmt=Fmt(kind="yuv420", width=320, height=240, fps=25.0), fps=25.0, **kw)
        vs.ticker.realtime = False
        seen = []
        vs.ticker.set_io(pull=vs._pull, push=lambda t, ext: seen.append(ext["tx_frames"]))
        for _ in range(5):
            vs.ticker.do_tick()
        got.append(np.stack(seen))
    assert got[1].dtype == np.uint8 and got[1].shape == (5, 2, 360, 320)
    assert np.abs(got[1].astype(np.int16) - got[0].astype(np.int16)).max() <= 1


def test_runs_on_the_card_unless_told_cpu(tfactory, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoStreamBatch(tfactory, 1)
    from mediastreamer2_tpu_torch.models.video_e2e_bench import VideoE2EBench
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoE2EBench(tfactory, 1, codec=None)


@pytest.mark.parametrize("codec,module,attr,library", [
    ("vp8", t_vp8, "_vpx", "libvpx"), ("h264", t_h264, "_av", "libavcodec"),
    ("h265", t_h264, "_av", "libavcodec"), ("av1", t_av1, "_aom", "libaom"),
    ("h263", t_h264, "_av", "libavcodec"), ("mjpeg", t_h264, "_av", "libavcodec")])
def test_missing_codec_library_raises_naming_it(tfactory, monkeypatch, codec, module, attr,
                                                library):
    """No fallback to the dummy codec: a leg whose library is missing
    raises when the stream is made."""
    monkeypatch.setattr(module, attr, None)
    monkeypatch.setattr(t_h264, "_CTX_OFF", None)      # as on a host that never probed
    fmt = Format(kind="yuv420", width=64, height=48, fps=25.0)
    with pytest.raises(RuntimeError, match=library):
        _vs(tfactory, 1, fmt, codec=codec)


def test_snapshot_writes_a_jpeg_or_names_pil(tfactory, tmp_path, monkeypatch):
    fmt = Format(kind="yuv420", width=64, height=48, fps=25.0)
    tx, rx = _vs(tfactory, 1, fmt), _vs(tfactory, 1, fmt)
    _pair(tx, rx)
    _run(10, tx, rx)
    try:
        import PIL  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="PIL"):
            rx.snapshot(0, str(tmp_path / "s.jpg"))
    else:
        path = rx.snapshot(0, str(tmp_path / "s.jpg"))
        assert open(path, "rb").read(2) == b"\xff\xd8"
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(RuntimeError, match="PIL"):
        rx.snapshot(0, str(tmp_path / "t.jpg"))


def test_video_presets_equal_jax():
    """``models/video_presets.py``: the ladder, the presets and the quality
    controller's walk equal the JAX package's; QVGA at 15 fps is the step
    for 170 kbit/s (a VGA camera sent at QVGA, phase 12a's shape)."""
    import dataclasses
    from mediastreamer2_tpu.models import video_presets as jp
    from mediastreamer2_tpu_torch.models import video_presets as tp
    astuple = lambda ladder: [dataclasses.astuple(c) for c in ladder]      # noqa: E731
    assert astuple(tp.DEFAULT_LADDER) == astuple(jp.DEFAULT_LADDER)
    presets = tp.VideoPresets(), jp.VideoPresets()
    for name in ("default", "high-fps", "custom"):
        assert astuple(presets[0].get(name)) == astuple(presets[1].get(name))
    custom = [(640, 480, 25.0, 400_000), (320, 240, 15.0, 200_000)]
    presets[0].register("mine", [tp.VideoConfiguration(*c) for c in custom[::-1]])
    presets[1].register("mine", [jp.VideoConfiguration(*c) for c in custom[::-1]])
    assert astuple(presets[0].get("mine")) == astuple(presets[1].get("mine")) == custom
    applied = [], []
    ctls = (tp.VideoQualityController(applied[0].append, max_width=1280),
            jp.VideoQualityController(applied[1].append, max_width=1280))
    for bps in (3_000_000, 170_000, 170_000, 20_000, 600_000, 1_600_000):
        got, want = (c.on_bandwidth_estimate(bps) for c in ctls)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert astuple(applied[0]) == astuple(applied[1]) and len(applied[0]) == 5
    assert tp.VideoQualityController(lambda c: None).on_bandwidth_estimate(170_000).name \
        == "320x240@15"
