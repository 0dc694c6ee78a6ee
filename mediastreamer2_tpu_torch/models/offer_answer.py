"""Offer/answer codec negotiation (SDP-level payload matching; port of
``mediastreamer2_tpu/models/offer_answer.py``: plain Python).

Reference: src/voip/offeranswer.c + the factory's offer-answer provider
registry (ms_factory_register_offer_answer_provider,
include/mediastreamer2/msfactory.h:418-434): per-codec contexts that match
fmtp parameters between an offer and the local capability list.

Here: PayloadTypeDesc carries mime/rate/channels/fmtp; providers are
per-mime matcher functions registered on the Factory; `negotiate` produces
the answer list the session layer feeds to AudioStreamBatch/VideoStream.

``local_capabilities`` is the JAX module's list: the audio host codecs
(GSM, Opus, Speex, G.729, BV16, and AAC as mpeg4-generic with the JAX
fmtp) and the video codecs (VP8, H.264, H.265, AV1, H.263, MPEG-4 video,
Theora) are probed through the port's ``ops/host_codecs``, ``ops/aac``,
``ops/vp8``, ``ops/h264`` and ``ops/av1`` as the JAX module probes them,
so each is offered where its library loads.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class PayloadTypeDesc:
    mime: str
    clock_rate: int
    channels: int = 1
    number: int = -1                # RTP payload type number
    fmtp: str = ""

    def key(self):
        return (self.mime.lower(), self.clock_rate, self.channels)


MatchFn = Callable[[PayloadTypeDesc, PayloadTypeDesc], Optional[PayloadTypeDesc]]
_PROVIDERS: Dict[str, MatchFn] = {}


def register_offer_answer_provider(mime: str, fn: MatchFn):
    """cf. ms_factory_register_offer_answer_provider."""
    _PROVIDERS[mime.lower()] = fn


def default_match(offered: PayloadTypeDesc, local: PayloadTypeDesc
                  ) -> Optional[PayloadTypeDesc]:
    if offered.key() != local.key():
        return None
    return PayloadTypeDesc(local.mime, local.clock_rate, local.channels,
                           offered.number, local.fmtp)


def _opus_match(offered, local):
    if offered.mime.lower() != "opus" or local.mime.lower() != "opus":
        return None
    # opus is always 48000/2 on the wire; fmtp carries real config
    fmtp = {}
    for part in (offered.fmtp or "").split(";"):
        if "=" in part:
            k, v = part.strip().split("=", 1)
            fmtp[k] = v
    answer_fmtp = []
    if fmtp.get("useinbandfec") == "1":
        answer_fmtp.append("useinbandfec=1")
    if "maxplaybackrate" in fmtp:
        answer_fmtp.append(f"maxplaybackrate={fmtp['maxplaybackrate']}")
    return PayloadTypeDesc("opus", 48000, 2, offered.number,
                           ";".join(answer_fmtp))


register_offer_answer_provider("opus", _opus_match)


def _h264_match(offered, local):
    """H.264 fmtp negotiation: packetization-mode must be answerable
    (we support 0 and 1), profile-level-id echoed when we can decode it
    (constrained baseline / baseline / main) — the h26x offer-answer
    provider's role."""
    if offered.mime.lower() != "h264" or local.mime.lower() != "h264":
        return None
    fmtp = {}
    for part in (offered.fmtp or "").split(";"):
        if "=" in part:
            k, v = part.strip().split("=", 1)
            fmtp[k.lower()] = v
    pmode = fmtp.get("packetization-mode", "0")
    if pmode not in ("0", "1"):
        return None                       # interleaved mode unsupported
    answer = [f"packetization-mode={pmode}"]
    plid = fmtp.get("profile-level-id", "")
    if plid[:2].lower() in ("42", "4d", ""):   # baseline/CB/main profiles
        if plid:
            answer.append(f"profile-level-id={plid}")
    else:
        return None                       # high profiles: decline
    return PayloadTypeDesc("H264", 90000, 1, offered.number,
                           ";".join(answer))


register_offer_answer_provider("h264", _h264_match)


def _vp8_match(offered, local):
    if offered.mime.lower() != "vp8" or local.mime.lower() != "vp8":
        return None
    # max-fr / max-fs constraints echo back capped to our capability
    fmtp = {}
    for part in (offered.fmtp or "").split(";"):
        if "=" in part:
            k, v = part.strip().split("=", 1)
            fmtp[k.lower()] = v
    answer = []
    if "max-fr" in fmtp:
        answer.append(f"max-fr={min(int(fmtp['max-fr']), 30)}")
    return PayloadTypeDesc("VP8", 90000, 1, offered.number,
                           ";".join(answer))


register_offer_answer_provider("vp8", _vp8_match)


def negotiate(offered: List[PayloadTypeDesc], local: List[PayloadTypeDesc]
              ) -> List[PayloadTypeDesc]:
    """Produce the answer payload list (first-match priority order)."""
    answer = []
    for off in offered:
        for loc in local:
            fn = _PROVIDERS.get(off.mime.lower(), default_match)
            m = fn(off, loc)
            if m is not None:
                answer.append(m)
                break
    return answer


# the framework's default local capability set, mirroring what the factory
# registers (device codecs + host codecs when their libs are present)
def local_capabilities() -> List[PayloadTypeDesc]:
    caps = [
        PayloadTypeDesc("PCMU", 8000, 1, 0),
        PayloadTypeDesc("PCMA", 8000, 1, 8),
        PayloadTypeDesc("L16", 44100, 1, 11),
    ]
    caps.append(PayloadTypeDesc("G722", 8000, 1, 9))   # RFC3551 clock quirk
    for kbps, pt in ((32, 97), (16, 98), (24, 99), (40, 100)):
        caps.append(PayloadTypeDesc(f"G726-{kbps}", 8000, 1, pt))
    caps.append(PayloadTypeDesc("telephone-event", 8000, 1, 101, "0-15"))
    from mediastreamer2_tpu_torch.ops import host_codecs as hc
    if hc.gsm_available():
        caps.append(PayloadTypeDesc("GSM", 8000, 1, 3))
    if hc.opus_available():
        caps.append(PayloadTypeDesc("opus", 48000, 2, 96, "useinbandfec=1"))
    from mediastreamer2_tpu_torch.ops.vp8 import vp8_available
    if vp8_available():
        caps.append(PayloadTypeDesc("VP8", 90000, 1, 102))
    from mediastreamer2_tpu_torch.ops.h264 import h264_available, h265_available
    if h264_available():
        caps.append(PayloadTypeDesc("H264", 90000, 1, 103,
                                    "packetization-mode=1"))
    if h265_available():
        caps.append(PayloadTypeDesc("H265", 90000, 1, 104, "profile-id=1"))
    from mediastreamer2_tpu_torch.ops.av1 import av1_available
    if av1_available():
        caps.append(PayloadTypeDesc("AV1", 90000, 1, 105, "profile=0"))
    if hc.speex_available():
        caps.append(PayloadTypeDesc("speex", 16000, 1, 106))
    if hc.g729_available():
        caps.append(PayloadTypeDesc("G729", 8000, 1, 18))
    if hc.bv16_available():
        caps.append(PayloadTypeDesc("BV16", 8000, 1, 107))   # RFC 4298
    from mediastreamer2_tpu_torch.ops.h264 import legacy_codec_available
    if legacy_codec_available("h263"):
        caps.append(PayloadTypeDesc("H263", 90000, 1, 34))     # RFC 3551
        caps.append(PayloadTypeDesc("H263-1998", 90000, 1, 109))
    if legacy_codec_available("mpeg4"):
        caps.append(PayloadTypeDesc("MP4V-ES", 90000, 1, 111))
    if legacy_codec_available("theora"):
        caps.append(PayloadTypeDesc("theora", 90000, 1, 112))  # RFC 5215
    from mediastreamer2_tpu_torch.ops.aac import aac_available, make_audio_specific_config
    if aac_available():
        cfg = make_audio_specific_config(16000, 1).hex()
        caps.append(PayloadTypeDesc(
            "mpeg4-generic", 16000, 1, 108,
            f"mode=AAC-hbr;config={cfg};sizeLength=13;indexLength=3;"
            "indexDeltaLength=3"))
    return caps


def _h265_match(offered, local):
    """HEVC (RFC 7798): echo profile/tier/level when main-profile."""
    if offered.mime.lower() != "h265" or local.mime.lower() != "h265":
        return None
    fmtp = {}
    for part in (offered.fmtp or "").split(";"):
        if "=" in part:
            k, v = part.strip().split("=", 1)
            fmtp[k.lower()] = v
    if fmtp.get("profile-id", "1") != "1":     # main profile only
        return None
    answer = []
    if "profile-id" in fmtp:
        answer.append("profile-id=1")
    return PayloadTypeDesc("H265", 90000, 1, offered.number,
                           ";".join(answer))


register_offer_answer_provider("h265", _h265_match)


def _av1_match(offered, local):
    """AV1 (aom RTP spec): profile 0, echoed level-idx capped."""
    if offered.mime.lower() != "av1" or local.mime.lower() != "av1":
        return None
    fmtp = {}
    for part in (offered.fmtp or "").split(";"):
        if "=" in part:
            k, v = part.strip().split("=", 1)
            fmtp[k.lower()] = v
    if fmtp.get("profile", "0") != "0":
        return None                            # high/pro profiles declined
    answer = []
    if "level-idx" in fmtp:
        answer.append(f"level-idx={min(int(fmtp['level-idx']), 8)}")
    return PayloadTypeDesc("AV1", 90000, 1, offered.number,
                           ";".join(answer))


register_offer_answer_provider("av1", _av1_match)


def _speex_match(offered, local):
    """Speex (RFC 5574): clock rates must agree; vbr=on echoed."""
    if offered.mime.lower() != "speex" or local.mime.lower() != "speex":
        return None
    if offered.clock_rate != local.clock_rate:
        return None
    answer = []
    for part in (offered.fmtp or "").split(";"):
        if part.strip().startswith("vbr="):
            answer.append(part.strip())
    return PayloadTypeDesc("speex", local.clock_rate, 1, offered.number,
                           ";".join(answer))


register_offer_answer_provider("speex", _speex_match)


def _aac_match(offered, local):
    """mpeg4-generic (RFC 3640): AAC-hbr mode only; the answer echoes OUR
    AudioSpecificConfig (config= is declarative per direction, like the
    reference decoder reading the peer's via dec_add_fmtp, aac-eld.c:775)."""
    if offered.mime.lower() != "mpeg4-generic" or \
            local.mime.lower() != "mpeg4-generic":
        return None
    fmtp = {}
    for part in (offered.fmtp or "").split(";"):
        if "=" in part:
            k, v = part.strip().split("=", 1)
            fmtp[k.lower()] = v
    if fmtp.get("mode", "").lower() != "aac-hbr":
        return None
    if offered.clock_rate != local.clock_rate:
        return None
    return PayloadTypeDesc("mpeg4-generic", local.clock_rate,
                           local.channels, offered.number, local.fmtp)


register_offer_answer_provider("mpeg4-generic", _aac_match)
