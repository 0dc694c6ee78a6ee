"""The port's offer/answer (``models/offer_answer.py``) against the JAX
package's: ``negotiate`` gives equal answers over a table of offers that
reaches every provider (opus, H.264, H.265, VP8, AV1, speex,
mpeg4-generic) and the default matcher; ``local_capabilities`` is the JAX
list, AAC included where libavcodec is present, and the video codecs,
which the port's video stream runs, are offered as in JAX."""
import dataclasses

import pytest

from mediastreamer2_tpu.models import offer_answer as joa
from mediastreamer2_tpu_torch.models import offer_answer as toa

#: the video codecs the JAX list offers where their libraries are
VIDEO = {"VP8", "H264", "H265", "AV1", "H263", "H263-1998", "MP4V-ES", "theora"}

OFFERS = [
    # (mime, clock, channels, pt, fmtp)
    ("PCMU", 8000, 1, 0, ""), ("PCMA", 8000, 1, 8, ""), ("G722", 8000, 1, 9, ""),
    ("g722", 8000, 1, 9, ""), ("G722", 16000, 1, 9, ""), ("L16", 44100, 1, 11, ""),
    ("L16", 8000, 1, 11, ""), ("G726-32", 8000, 1, 112, ""), ("G726-40", 8000, 1, 100, ""),
    ("telephone-event", 8000, 1, 101, "0-16"), ("GSM", 8000, 1, 3, ""),
    ("G729", 8000, 1, 18, "annexb=no"), ("BV16", 8000, 1, 107, ""),
    ("opus", 48000, 2, 111, "useinbandfec=1;maxplaybackrate=16000;stereo=0"),
    ("opus", 48000, 2, 96, ""), ("OPUS", 48000, 2, 96, "useinbandfec=0"),
    ("H264", 90000, 1, 103, "packetization-mode=1;profile-level-id=42e01f"),
    ("H264", 90000, 1, 104, "packetization-mode=0"),
    ("H264", 90000, 1, 105, "packetization-mode=2"),
    ("H264", 90000, 1, 106, "profile-level-id=640028;packetization-mode=1"),
    ("H264", 90000, 1, 107, "profile-level-id=4d001f"),
    ("H265", 90000, 1, 108, "profile-id=1"), ("H265", 90000, 1, 109, "profile-id=2"),
    ("H265", 90000, 1, 110, ""),
    ("VP8", 90000, 1, 120, "max-fr=60;max-fs=3600"), ("VP8", 90000, 1, 121, ""),
    ("AV1", 90000, 1, 122, "profile=0;level-idx=12"), ("AV1", 90000, 1, 123, "profile=1"),
    ("speex", 16000, 1, 97, "vbr=on;mode=any"), ("speex", 8000, 1, 98, ""),
    ("mpeg4-generic", 16000, 1, 96, "mode=AAC-hbr;config=1408;sizeLength=13"),
    ("mpeg4-generic", 16000, 1, 96, "mode=AAC-lbr"),
    ("mpeg4-generic", 44100, 1, 96, "mode=AAC-hbr"),
    ("unknown", 8000, 1, 99, ""),
]

#: local entries that reach every video provider and AAC's, whatever
#: libraries this host has
LOCAL_VIDEO = [("VP8", 90000, 1, 102, ""), ("H264", 90000, 1, 103, "packetization-mode=1"),
               ("H265", 90000, 1, 104, "profile-id=1"), ("AV1", 90000, 1, 105, "profile=0"),
               ("mpeg4-generic", 16000, 1, 108, "mode=AAC-hbr;config=1408")]


def _as_tuples(answer):
    return [dataclasses.astuple(p) for p in answer]


@pytest.mark.parametrize("offer", OFFERS, ids=lambda o: f"{o[0]}-{o[3]}-{o[4] or 'none'}")
def test_negotiate_equals_jax_for_every_provider(offer):
    local = [dataclasses.astuple(p) for p in joa.local_capabilities()] + LOCAL_VIDEO
    j = joa.negotiate([joa.PayloadTypeDesc(*offer)], [joa.PayloadTypeDesc(*p) for p in local])
    t = toa.negotiate([toa.PayloadTypeDesc(*offer)], [toa.PayloadTypeDesc(*p) for p in local])
    assert _as_tuples(t) == _as_tuples(j)


def test_negotiate_whole_offers_in_priority_order():
    offer = [joa.PayloadTypeDesc(*o) for o in OFFERS]
    local = [dataclasses.astuple(p) for p in joa.local_capabilities()] + LOCAL_VIDEO
    j = joa.negotiate(offer, [joa.PayloadTypeDesc(*p) for p in local])
    t = toa.negotiate([toa.PayloadTypeDesc(*dataclasses.astuple(o)) for o in offer],
                      [toa.PayloadTypeDesc(*p) for p in local])
    assert _as_tuples(t) == _as_tuples(j) and len(t) > 10
    # G722 offered first is answered first, at RFC 3551's 8000 Hz clock, PT 9
    caps = toa.local_capabilities()
    g722_first = sorted(caps, key=lambda p: p.mime != "G722")
    answer = toa.negotiate(g722_first, toa.local_capabilities())
    assert (answer[0].mime, answer[0].clock_rate, answer[0].number) == ("G722", 8000, 9)


def test_a_registered_provider_overrides_the_default(monkeypatch):
    for mod in (joa, toa):
        monkeypatch.setitem(mod._PROVIDERS, "pcmu", lambda off, loc: None)
    offer = [("PCMU", 8000, 1, 0, ""), ("PCMA", 8000, 1, 8, "")]
    j = joa.negotiate([joa.PayloadTypeDesc(*o) for o in offer], joa.local_capabilities())
    t = toa.negotiate([toa.PayloadTypeDesc(*o) for o in offer], toa.local_capabilities())
    assert _as_tuples(t) == _as_tuples(j) == [("PCMA", 8000, 1, 8, "")]


def test_local_capabilities_is_the_jax_list_without_video_or_aac():
    """The port offers what the JAX package offers, in the same order: the
    video codecs since the video stream was ported, AAC (mpeg4-generic,
    with the JAX fmtp) since the stream's AAC legs were, each where this
    host has its library (the name is older than both)."""
    from mediastreamer2_tpu_torch.ops.aac import aac_available
    from mediastreamer2_tpu_torch.ops.vp8 import vp8_available
    j = [dataclasses.astuple(p) for p in joa.local_capabilities()]
    t = [dataclasses.astuple(p) for p in toa.local_capabilities()]
    assert t == j
    assert ("mpeg4-generic" in {p[0] for p in t}) == aac_available()
    assert ("VP8" in {p[0] for p in t}) == vp8_available()
    assert {p[0] for p in t} & VIDEO == {p[0] for p in j} & VIDEO
    assert [p[0] for p in t[:4]] == ["PCMU", "PCMA", "L16", "G722"]
