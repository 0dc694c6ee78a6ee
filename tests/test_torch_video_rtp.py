"""The port's RTP video payload formats against the JAX package's, on the
CPU: AV1 OBU packetization (``net/av1_rtp.py``), RTP/JPEG (RFC 2435,
``net/jpeg_rtp.py``) and the H.264 / H.265 / H.263 half of ``net/h26x.py``
(RFC 6184, 7798, 4629), plus the session packetizers of
``models/video_stream.py``. Each packetizer's packets are byte-equal to
the JAX package's for the same input, and each depacketizer returns what
the JAX one returns (the JAX tests ``test_av1_rtp.py``, ``test_jpeg_rtp.py``
and the h26x half of ``test_fec_h26x.py`` run on the port)."""
import io

import numpy as np
import pytest

from mediastreamer2_tpu.net import av1_rtp as JA
from mediastreamer2_tpu.net import h26x as JH
from mediastreamer2_tpu.net import jpeg_rtp as JJ

from mediastreamer2_tpu_torch.net import av1_rtp as A
from mediastreamer2_tpu_torch.net import h26x
from mediastreamer2_tpu_torch.net import jpeg_rtp as J
from mediastreamer2_tpu_torch.net.rtp import RtpPacket


# ------------------------------------------------------------------- AV1
def _mk_obu(obu_t, body, has_size=True):
    hdr = (obu_t & 0x0F) << 3 | (0x02 if has_size else 0)
    if has_size:
        return bytes([hdr]) + A.leb128_encode(len(body)) + body
    return bytes([hdr]) + body


def _tus():
    rng = np.random.default_rng(11)
    body = bytes(range(256)) * 20
    return [
        _mk_obu(1, b"HDR") + _mk_obu(6, body),
        _mk_obu(A.OBU_TEMPORAL_DELIMITER, b"") + _mk_obu(6, b"X" * 30),
        _mk_obu(1, b"SEQHDR") + _mk_obu(6, b"F" * 40),
        b"".join(_mk_obu(int(t), rng.bytes(int(n)))
                 for t, n in zip(rng.choice([1, 3, 4, 6], 6), rng.integers(1, 900, 6))),
        _mk_obu(6, rng.bytes(200), has_size=False),
    ]


def test_leb128():
    for v in (0, 1, 127, 128, 300, 2**20, 2**32 - 1):
        enc = A.leb128_encode(v)
        assert enc == JA.leb128_encode(v)
        assert A.leb128_decode(enc) == (v, len(enc)) == JA.leb128_decode(enc)


def test_split_join_strips_sizes_and_restores():
    tu = _mk_obu(1, b"SEQHDR") + _mk_obu(6, b"F" * 40)
    obus = A.split_obus(tu)
    assert len(obus) == 2 and obus == JA.split_obus(tu)
    assert all(not (o[0] & 0x02) for o in obus)
    assert A.join_obus(obus) == tu == JA.join_obus(obus)


def test_packetize_removes_temporal_delimiter():
    tu = _mk_obu(A.OBU_TEMPORAL_DELIMITER, b"") + _mk_obu(6, b"X" * 30)
    d = A.Depacketizer()
    for p in A.packetize(tu, mtu=100):
        d.push(p)
    assert [A.obu_type(o) for o in A.split_obus(d.pop_tu())] == [6]


def test_fragmentation_z_y_roundtrip():
    body = bytes(range(256)) * 20
    tu = _mk_obu(1, b"HDR") + _mk_obu(6, body)
    pls = A.packetize(tu, mtu=500, new_sequence=True)
    assert len(pls) > 10 and pls[0][0] & 0x08
    assert any(p[0] & 0x40 for p in pls) and any(p[0] & 0x80 for p in pls)
    d = A.Depacketizer()
    for p in pls:
        d.push(p)
    obus = A.split_obus(d.pop_tu())
    assert [A.obu_type(o) for o in obus] == [1, 6] and obus[1][1:] == body


@pytest.mark.parametrize("mtu", [60, 300, 500, 1200])
@pytest.mark.parametrize("new_sequence", [False, True])
def test_av1_packets_byte_equal_jax(mtu, new_sequence):
    for tu in _tus():
        pls = A.packetize(tu, mtu=mtu, new_sequence=new_sequence)
        assert pls == JA.packetize(tu, mtu=mtu, new_sequence=new_sequence)
        d, jd = A.Depacketizer(), JA.Depacketizer()
        for p in pls[:-1] if mtu == 60 else pls:     # mtu 60: the last packet lost
            d.push(p)
            jd.push(p)
        assert d.pop_tu() == jd.pop_tu()


def test_av1_codec_over_rtp_packetization():
    from mediastreamer2_tpu_torch.ops.av1 import Av1Decoder, Av1Encoder, av1_available
    if not av1_available():
        pytest.skip("libaom unavailable")
    enc, dec = Av1Encoder(64, 48, fps=25), Av1Decoder()
    rng = np.random.default_rng(7)
    y = (rng.random((48, 64)) * 255).astype(np.uint8)
    u = v = np.full((24, 32), 128, np.uint8)
    tu, key = enc.encode_planes(y, u, v, force_keyframe=True)
    pls = A.packetize(tu, mtu=300, new_sequence=key)
    assert pls == JA.packetize(tu, mtu=300, new_sequence=key)
    d = A.Depacketizer()
    for p in pls:
        d.push(p)
    frame = dec.decode(d.pop_tu())
    assert frame is not None and frame[0].shape == (48, 64)


# ------------------------------------------------------------ RTP/JPEG
def _make_jpeg(w=160, h=128, quality=85, seed=0, subsampling=2):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(seed)
    img = np.clip(np.cumsum(rng.standard_normal((h, w, 3)), axis=1) * 8
                  + 128, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality, subsampling=subsampling)
    return buf.getvalue()


def test_parse_jfif_fields():
    jpeg = _make_jpeg()
    got = J._parse_jfif(jpeg)
    assert got == JJ._parse_jfif(jpeg)
    jtype, w, h, qt, scan, dri = got
    assert (w, h) == (160, 128) and jtype & 0x3F == 1
    assert 0 in qt and len(qt[0]) == 64 and len(scan) > 1000


@pytest.mark.parametrize("mtu", [200, 500, 1400])
def test_jpeg_roundtrip_bit_faithful_and_equal_jax(mtu):
    from PIL import Image
    for seed, sub in ((0, 2), (3, 1)):
        jpeg = _make_jpeg(seed=seed, subsampling=sub)
        payloads = J.jpeg_packetize(jpeg, mtu=mtu)
        assert payloads == JJ.jpeg_packetize(jpeg, mtu=mtu)
        assert all(len(p) <= mtu for p in payloads)
        de, jde = J.JpegDepacketizer(), JJ.JpegDepacketizer()
        for k, p in enumerate(payloads):
            de.push(p, marker=(k == len(payloads) - 1))
            jde.push(p, marker=(k == len(payloads) - 1))
        out = de.pop()
        assert out == jde.pop() and out is not None
        dec = np.asarray(Image.open(io.BytesIO(out)).convert("RGB"), np.float64)
        ref = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"), np.float64)
        psnr = 10 * np.log10(255 ** 2 / max(((dec - ref) ** 2).mean(), 1e-9))
        assert psnr > 60, psnr


def test_jpeg_lost_marker_discards_frame():
    payloads = J.jpeg_packetize(_make_jpeg(), mtu=400)
    de = J.JpegDepacketizer()
    for p in payloads[:-1]:
        de.push(p, marker=False)
    assert de.pop() is None
    p2 = J.jpeg_packetize(_make_jpeg(seed=2), mtu=400)
    for k, p in enumerate(p2):
        de.push(p, marker=(k == len(p2) - 1))
    assert de.pop() is not None


# ------------------------------------------------------------------ h26x
def _fake_nal(t, size, fill=0xAB):
    return bytes([t]) + bytes([fill]) * (size - 1)


def _h265_nal(t, size, seed):
    body = np.random.default_rng(seed).bytes(size - 2)
    return bytes([(t & 0x3F) << 1, 1]) + body


def test_annexb_split_and_join():
    nals = [_fake_nal(h26x.NAL_SPS, 20), _fake_nal(h26x.NAL_PPS, 8),
            _fake_nal(h26x.NAL_IDR, 3000)]
    stream = h26x.to_annexb(nals)
    assert stream == JH.to_annexb(nals)
    assert h26x.split_annexb(stream) == nals == JH.split_annexb(stream)
    stream3 = b"\x00\x00\x01" + nals[0] + b"\x00\x00\x01" + nals[1]
    assert h26x.split_annexb(stream3) == nals[:2] == JH.split_annexb(stream3)


@pytest.mark.parametrize("mtu", [200, 1400])
def test_h264_packetize_unpack_roundtrip_equal_jax(mtu):
    nals = [_fake_nal(h26x.NAL_SPS, 18), _fake_nal(h26x.NAL_PPS, 9),
            _fake_nal(h26x.NAL_IDR, 5000), _fake_nal(1, 900), _fake_nal(1, 60),
            _fake_nal(6, 40)]
    payloads = h26x.packetize(nals, mtu=mtu)
    assert payloads == JH.packetize(nals, mtu=mtu)
    assert any(p[0] & 0x1F == h26x.NAL_FU_A for p in payloads)
    assert all(len(p) <= mtu for p in payloads)
    un, jun = h26x.H264Unpacker(), JH.H264Unpacker()
    out = []
    for p in payloads:
        got = un.push(p)
        assert got == jun.push(p)
        out.extend(got)
    assert out == nals and un.errors == 0 == jun.errors
    # a lost middle fragment: both unpackers count the same error
    un, jun = h26x.H264Unpacker(), JH.H264Unpacker()
    fu = [k for k, p in enumerate(payloads) if p[0] & 0x1F == h26x.NAL_FU_A]
    for k, p in enumerate(payloads):
        if k != fu[1]:
            assert un.push(p) == jun.push(p)
    assert un.errors == jun.errors


def test_h264_stap_aggregation():
    small = [_fake_nal(h26x.NAL_SPS, 12), _fake_nal(h26x.NAL_PPS, 6)]
    payloads = h26x.packetize(small, mtu=1400)
    assert payloads == JH.packetize(small, mtu=1400)
    assert len(payloads) == 1 and payloads[0][0] & 0x1F == h26x.NAL_STAP_A
    assert h26x.H264Unpacker().push(payloads[0]) == small


def test_parameter_set_store():
    ps, jps = h26x.ParameterSetStore(), JH.ParameterSetStore()
    sps, pps = _fake_nal(h26x.NAL_SPS, 15), _fake_nal(h26x.NAL_PPS, 7)
    assert not ps.ready
    for s in (ps, jps):
        s.process(sps)
        s.process(pps)
    assert ps.ready and jps.ready
    idr = [_fake_nal(h26x.NAL_IDR, 100)]
    assert ps.prepend_for_idr(idr) == [sps, pps] + idr == jps.prepend_for_idr(idr)
    assert ps.prepend_for_idr([_fake_nal(1, 50)]) == [_fake_nal(1, 50)]


@pytest.mark.parametrize("mtu", [300, 1400])
def test_h265_packets_byte_equal_jax(mtu):
    """RFC 7798 single NALs, AP aggregation and FU fragmentation on
    synthetic VPS / SPS / PPS / IDR / trailing NALs (2-byte headers)."""
    ps_nals = [_h265_nal(32, 24, 1), _h265_nal(33, 40, 2), _h265_nal(34, 9, 3)]
    frame = [_h265_nal(19, 27000, 4), _h265_nal(1, 700, 5), _h265_nal(1, 90, 6)]
    for nals in (ps_nals, frame, ps_nals + frame):
        payloads = h26x.h265_packetize(nals, mtu=mtu)
        assert payloads == JH.h265_packetize(nals, mtu=mtu)
        un, jun = h26x.H265Unpacker(), JH.H265Unpacker()
        out = []
        for p in payloads:
            got = un.push(p)
            assert got == jun.push(p)
            out.extend(got)
        assert out == nals and un.errors == 0
    assert len(h26x.h265_packetize(ps_nals, mtu=1400)) == 1          # one AP
    assert (h26x.h265_packetize(ps_nals, mtu=1400)[0][0] >> 1) & 0x3F == 48
    assert [h26x.h265_nal_type(n) for n in ps_nals] == [32, 33, 34]
    assert h26x.h265_is_irap(frame[0]) and not h26x.h265_is_irap(frame[1])
    st, jst = h26x.H265ParameterSetStore(), JH.H265ParameterSetStore()
    for n in ps_nals:
        st.process(n)
        jst.process(n)
    assert st.ready
    out = st.prepend_for_irap(frame[:1])
    assert out == jst.prepend_for_irap(frame[:1])
    assert [h26x.h265_nal_type(n) for n in out[:3]] == [32, 33, 34]
    assert h26x.split_annexb(h26x.to_annexb(out)) == out


def _h263_frame(seed, n):
    """A byte stream that starts with an H.263 picture start code."""
    return b"\x00\x00\x80\x02" + np.random.default_rng(seed).bytes(n)


def test_h263_rfc4629_byte_equal_jax():
    for frame, mtu in ((_h263_frame(1, 3000), 500), (_h263_frame(2, 300), 1400),
                       (b"\x12\x34" + _h263_frame(3, 100), 64)):
        payloads = h26x.h263_packetize(frame, mtu=mtu)
        assert payloads == JH.h263_packetize(frame, mtu=mtu)
        d, jd = h26x.H263Depacketizer(), JH.H263Depacketizer()
        for k, p in enumerate(payloads):
            d.push(p, marker=(k == len(payloads) - 1))
            jd.push(p, marker=(k == len(payloads) - 1))
        out = d.pop()
        assert out == jd.pop() == frame


def test_h263_rfc4629_roundtrip_with_real_codec():
    from mediastreamer2_tpu_torch.ops.h264 import legacy_codec_available, make_legacy_codec
    if not legacy_codec_available("h263"):
        pytest.skip("h263 unavailable")
    w, h = 176, 144
    Enc, Dec = make_legacy_codec("h263")
    enc, dec = Enc(w, h, bitrate_bps=400_000, fps=10, gop=5), Dec()
    y = (np.random.default_rng(8).random((h, w)) * 255).astype(np.uint8)
    frame = enc.encode(y.tobytes() + bytes([128] * (w * h // 4)) * 2, keyframe=True)
    assert frame.startswith(b"\x00\x00")
    payloads = h26x.h263_packetize(frame, mtu=500)
    assert payloads == JH.h263_packetize(frame, mtu=500)
    assert len(payloads) > 1 and payloads[0][0] & 0x04 and not payloads[1][0] & 0x04
    d = h26x.H263Depacketizer()
    for k, p in enumerate(payloads):
        d.push(p, marker=(k == len(payloads) - 1))
    out = d.pop()
    assert out == frame
    frames = dec.decode(out)
    assert frames and len(frames[0]) == w * h * 3 // 2


# ------------------------------------------- the session packetizers
def _session_inputs():
    h264_au = h26x.to_annexb([_fake_nal(h26x.NAL_SPS, 18), _fake_nal(h26x.NAL_PPS, 9),
                              _fake_nal(h26x.NAL_IDR, 4000)])
    h265_au = h26x.to_annexb([_h265_nal(32, 24, 1), _h265_nal(33, 40, 2),
                              _h265_nal(34, 9, 3), _h265_nal(19, 5000, 4)])
    av1_tu = _mk_obu(1, b"HDR") + _mk_obu(6, bytes(range(256)) * 12)
    return {"Generic": bytes(range(256)) * 30, "H264": h264_au, "H265": h265_au,
            "Av1": av1_tu, "H263Session": _h263_frame(5, 2500)}


@pytest.mark.parametrize("kind", ["Generic", "H264", "H265", "Av1", "H263Session",
                                  "JpegSession"])
def test_session_packetizers_byte_equal_jax(kind):
    """Each of the stream's packetizers packs the same payloads as JAX's,
    reassembles them over an RTP sequence, and drops an access unit with a
    lost packet the same way."""
    from mediastreamer2_tpu.models import video_stream as jvs
    from mediastreamer2_tpu_torch.models import video_stream as tvs
    data = _make_jpeg() if kind == "JpegSession" else _session_inputs()[kind]
    name = f"{kind}Packetizer"
    tp, jp = getattr(tvs, name)(600), getattr(jvs, name)(600)
    chunks = tp.pack(data)
    assert chunks == jp.pack(data) and len(chunks) > 2
    for lose in (None, 1):
        tp, jp = getattr(tvs, name)(600), getattr(jvs, name)(600)
        for frame_no in range(2):
            for k, c in enumerate(chunks):
                if frame_no == 0 and k == lose:
                    continue
                seq = 100 + frame_no * len(chunks) + k
                pkt = RtpPacket(97, seq, 3000 * (frame_no + 1), 1, c,
                                marker=(k == len(chunks) - 1))
                tp.push(pkt)
                jp.push(pkt)
        got = [tp.pop(), tp.pop()]
        assert got == [jp.pop(), jp.pop()]
        assert tp.dropped_incomplete == jp.dropped_incomplete
        assert got[0] is not None
        if lose is None:
            assert tp.dropped_incomplete == 0 and got[1] is not None
