"""The port's AV1 host codec (``mediastreamer2_tpu_torch/ops/av1.py``,
libaom through ctypes with the probed ABI) against the JAX package's on
the CPU: byte-equal temporal units and equal decoded planes for the same
frames, and the JAX ``tests/test_av1.py`` cases on the port. Skipped
where libaom is missing."""
import numpy as np
import pytest

from mediastreamer2_tpu.ops import av1 as jav1

from mediastreamer2_tpu_torch import Factory, Format
from mediastreamer2_tpu_torch.models.video_stream import VideoStreamBatch
from mediastreamer2_tpu_torch.net.rtp import LoopbackPair
from mediastreamer2_tpu_torch.ops import av1

pytestmark = pytest.mark.skipif(not av1.av1_available(), reason="libaom missing")
W, H = 64, 48


def _planes(off=0):
    y = ((np.arange(H)[:, None] * 3 + np.arange(W)[None, :] + off) % 210).astype(np.uint8)
    return y, np.full((H // 2, W // 2), 110, np.uint8), np.full((H // 2, W // 2), 150, np.uint8)


def test_av1_units_byte_equal_jax():
    encs = av1.Av1Encoder(W, H, bitrate_bps=300_000), jav1.Av1Encoder(W, H, bitrate_bps=300_000)
    decs = av1.Av1Decoder(), jav1.Av1Decoder()
    for i in range(6):
        got, want = (e.encode_planes(*_planes(i * 7), force_keyframe=(i == 3)) for e in encs)
        assert got == want and got[1] == (i in (0, 3))
        a, b = (d.decode(got[0]) for d in decs)
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p, q)


def test_av1_roundtrip():
    enc, dec = av1.Av1Encoder(W, H, bitrate_bps=300_000), av1.Av1Decoder()
    for i in range(4):
        y, u, v = _planes(i * 7)
        data, is_key = enc.encode_planes(y, u, v)
        assert (i == 0) == is_key
        out = dec.decode(data)
        assert out is not None
    assert float(((out[0].astype(float) - y.astype(float)) ** 2).mean()) < 30.0


def test_av1_forced_keyframe():
    enc = av1.Av1Encoder(W, H)
    y, u, v = _planes()
    enc.encode_planes(y, u, v)
    assert enc.encode_planes(y, u, v, force_keyframe=True)[1]


def test_av1_frame_codec_byte_equal_jax():
    codecs = av1.Av1FrameCodec(W, H, bitrate_bps=250_000), jav1.Av1FrameCodec(W, H,
                                                                               bitrate_bps=250_000)
    for i in range(5):
        y, u, v = _planes(3 * i)
        frame = y.tobytes() + np.stack([u, v], 1).tobytes()
        got, want = (c.encode(frame, keyframe=(i == 0)) for c in codecs)
        assert got == want
        assert codecs[0].decode(got) == codecs[1].decode(want)


@pytest.mark.parametrize("codec_arg", ["factory", "name"])
def test_av1_video_call(codec_arg):
    """Full AV1 legs over RTP: a per-leg codec factory (``test_av1.py``)
    and ``codec="av1"``, whose OBU packetizer rides the wire
    (``test_av1_rtp.py``'s call)."""
    fmt = Format(kind="yuv420", width=W, height=H, fps=25.0)
    kw = ({"codec_factory": lambda: av1.Av1FrameCodec(W, H, bitrate_bps=250_000)}
          if codec_arg == "factory" else {"codec": "av1"})
    f = Factory()
    tx = VideoStreamBatch(f, 1, fmt=fmt, fps=25.0, device="cpu", **kw)
    rx = VideoStreamBatch(f, 1, fmt=fmt, fps=25.0, device="cpu", **kw)
    pair = LoopbackPair()
    tx.set_transport(0, pair.endpoint(0))
    rx.set_transport(0, pair.endpoint(1))
    tx.bind_assemblers()
    rx.bind_assemblers()
    tx.ticker.realtime = rx.ticker.realtime = False
    for _ in range(80):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
    assert tx.stats[0].frames_sent >= 15
    assert rx.stats[0].frames_received >= 8
    assert float(np.abs(rx._last_rx[0]).mean()) > 0.05
