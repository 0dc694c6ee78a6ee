"""The port's VP8 host codec (``mediastreamer2_tpu_torch/ops/vp8.py``,
libvpx through ctypes with the probed ABI) against the JAX package's on
the CPU: the same frames and settings give byte-equal VP8 frames and equal
decoded planes; RFC 7741 payload descriptors and partitions byte-equal;
and the JAX ``tests/test_vp8.py`` cases on the port, a VP8 call included.
Skipped where libvpx is missing.

libvpx in realtime mode picks its speed from the encode times it
measures when ``cpu_used`` is positive (both packages' default, 10): the
same frames then give other bytes from run to run under load, within one
package (``test_default_speed_is_timed_so_its_bar_is_quality``). Byte
equality is held at a fixed speed (``cpu_used=-10``: speed 10, no
timing), in both packages; the default is held to the JAX tests' quality
bars."""
import numpy as np
import pytest

from mediastreamer2_tpu.ops import vp8 as jvp8

from mediastreamer2_tpu_torch import Factory, Format
from mediastreamer2_tpu_torch.models.video_stream import VideoStreamBatch
from mediastreamer2_tpu_torch.net.rtp import LoopbackPair
from mediastreamer2_tpu_torch.ops import vp8

pytestmark = pytest.mark.skipif(not vp8.vp8_available(), reason="libvpx missing")
W, H = 64, 48


def _gradient(w=W, h=H, off=0):
    y = ((np.arange(h)[:, None] * 3 + np.arange(w)[None, :] + off) % 220).astype(np.uint8)
    return y, np.full((h // 2, w // 2), 100, np.uint8), np.full((h // 2, w // 2), 160, np.uint8)


FIXED = -10                 # libvpx speed 10, not picked from measured times


def test_vp8_frames_byte_equal_jax():
    """Eight frames with a forced keyframe at 4, at two bitrates, at a
    fixed speed; the decoders of both packages return equal planes from
    the same bytes."""
    for bitrate in (400_000, 120_000):
        encs = (vp8.Vp8Encoder(W, H, bitrate_bps=bitrate, cpu_used=FIXED),
                jvp8.Vp8Encoder(W, H, bitrate_bps=bitrate, cpu_used=FIXED))
        decs = vp8.Vp8Decoder(), jvp8.Vp8Decoder()
        for i in range(8):
            got, want = (e.encode_planes(*_gradient(off=i * 4), force_keyframe=(i == 4))
                         for e in encs)
            assert got == want and got[1] == (i in (0, 4))
            a, b = (d.decode(got[0]) for d in decs)
            for p, q in zip(a, b):
                np.testing.assert_array_equal(p, q)


def test_vp8_roundtrip_quality():
    enc, dec = vp8.Vp8Encoder(W, H, bitrate_bps=400_000), vp8.Vp8Decoder()
    for i in range(5):
        y, u, v = _gradient(off=i * 4)
        data, is_key = enc.encode_planes(y, u, v)
        assert (i == 0) == is_key
        dy, du, dv = dec.decode(data)
    assert float(((dy.astype(float) - y.astype(float)) ** 2).mean()) < 30.0
    assert abs(float(du.mean()) - 100) < 6 and abs(float(dv.mean()) - 160) < 6


def test_vp8_forced_keyframe():
    enc = vp8.Vp8Encoder(W, H)
    y, u, v = _gradient()
    enc.encode_planes(y, u, v)
    assert not enc.encode_planes(y, u, v)[1]
    assert enc.encode_planes(y, u, v, force_keyframe=True)[1]


def test_vp8_payload_descriptor_equal_jax():
    for frags, pid in (([b"abc", b"def"], None), ([b"xyz"], 12345), ([b"q" * 10] * 3, 42)):
        packed = vp8.vp8_payload_pack(frags, picture_id=pid)
        assert packed == jvp8.vp8_payload_pack(frags, picture_id=pid)
        for k, p in enumerate(packed):
            assert vp8.vp8_payload_unpack(p) == (frags[k], k == 0, pid)
    short = bytes([0x90, 0x80, 42]) + b"qq"               # 7-bit picture id
    assert vp8.vp8_payload_unpack(short) == (b"qq", True, 42) == jvp8.vp8_payload_unpack(short)


def test_partition_mode_byte_equal_jax():
    rng = np.random.default_rng(4)
    y = (rng.random((48, 64)) * 255).astype(np.uint8)
    u = v = np.full((24, 32), 128, np.uint8)
    got, want = (m.Vp8Encoder(64, 48, fps=25, token_partitions_log2=2, cpu_used=FIXED
                              ).encode_partitions(y, u, v, force_keyframe=True)
                 for m in (vp8, jvp8))
    assert got == want
    parts, key = got
    assert key and len(parts) == 5
    out = vp8.Vp8Decoder().decode(b"".join(parts))
    assert out is not None and out[0].shape == (48, 64)
    for mtu in (1400, 120):
        payloads = vp8.vp8_packetize_partitions(parts, mtu=mtu, picture_id=7)
        assert payloads == jvp8.vp8_packetize_partitions(parts, mtu=mtu, picture_id=7)
        assert [vp8.vp8_partition_id(p) for p in payloads] == \
            [jvp8.vp8_partition_id(p) for p in payloads]
    payloads = vp8.vp8_packetize_partitions(parts, mtu=1400, picture_id=7)
    assert [vp8.vp8_partition_id(pl) for pl in payloads] == [0, 1, 2, 3, 4]
    assert all(pl[0] & 0x10 for pl in payloads)
    assert b"".join(vp8.vp8_payload_unpack(pl)[0] for pl in payloads) == b"".join(parts)


def test_vp8_frame_codec_byte_equal_jax():
    """``Vp8FrameCodec`` (the stream's per-leg codec) on packed I420 bytes,
    at a fixed speed."""
    codecs = (vp8.Vp8FrameCodec(W, H, bitrate_bps=300_000, cpu_used=FIXED),
              jvp8.Vp8FrameCodec(W, H, bitrate_bps=300_000, cpu_used=FIXED))
    for i in range(6):
        y, u, v = _gradient(off=5 * i)
        frame = y.tobytes() + np.stack([u, v], 1).tobytes()
        got, want = (c.encode(frame, keyframe=(i == 0)) for c in codecs)
        assert got == want
        assert codecs[0].decode(got) == codecs[1].decode(want)


def test_vp8_video_call():
    fmt = Format(kind="yuv420", width=W, height=H, fps=25.0)
    mk = lambda: vp8.Vp8FrameCodec(W, H, bitrate_bps=300_000)     # noqa: E731
    f = Factory()
    tx = VideoStreamBatch(f, 1, fmt=fmt, fps=25.0, codec_factory=mk, device="cpu")
    rx = VideoStreamBatch(f, 1, fmt=fmt, fps=25.0, codec_factory=mk, device="cpu")
    pair = LoopbackPair()
    tx.set_transport(0, pair.endpoint(0))
    rx.set_transport(0, pair.endpoint(1))
    tx.bind_assemblers()
    rx.bind_assemblers()
    tx.ticker.realtime = rx.ticker.realtime = False
    for _ in range(60):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
    assert rx.stats[0].frames_received >= 5
    assert float(np.abs(rx._last_rx[0]).mean()) > 0.05


def test_vp8_available_is_verified():
    assert vp8.vp8_available() is True and vp8._verified is True


def test_default_speed_is_timed_so_its_bar_is_quality():
    """At the default ``cpu_used`` (10) libvpx picks its speed from encode
    times: under load two runs of the same frames in one package can give
    other bytes. Every run still decodes to the gradient within the
    quality bar of ``test_vp8_roundtrip_quality``, in both packages."""
    for m in (vp8, jvp8):
        enc, dec = m.Vp8Encoder(W, H, bitrate_bps=400_000), m.Vp8Decoder()
        for i in range(8):
            y, u, v = _gradient(off=i * 4)
            dy, du, dv = dec.decode(enc.encode_planes(y, u, v)[0])
            assert float(((dy.astype(float) - y.astype(float)) ** 2).mean()) < 30.0
            assert abs(float(du.mean()) - 100) < 6 and abs(float(dv.mean()) - 160) < 6
