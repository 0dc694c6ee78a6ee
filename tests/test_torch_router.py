"""The port's SFU routers (``net/router.py``) against the JAX package's on
the CPU: the JAX cases ``test_audio_router_top_n``,
``test_video_router_keyframe_switching`` (``test_crypto_codecs.py``) and
``test_audio_router_ranks_by_level_extension``
(``test_conference_server.py``), each run on both packages, and a seeded
random packet trace through both packages' routers: the same forwarding
decisions and the same bytes, packet for packet."""
import numpy as np
import pytest

from mediastreamer2_tpu.net import router as j_router
from mediastreamer2_tpu.net import rtp as j_rtp
from mediastreamer2_tpu_torch.net import router as t_router
from mediastreamer2_tpu_torch.net import rtp as t_rtp

PKGS = {"jax": (j_router, j_rtp), "torch": (t_router, t_rtp)}


@pytest.mark.parametrize("pkg", PKGS)
def test_audio_router_top_n(pkg):
    router, rtp = PKGS[pkg]
    r = router.AudioPacketRouter(top_n=2)
    outs = {i: [] for i in range(4)}
    for i in range(4):
        r.add_member(i, outs[i].append)
    r.update_volumes(np.array([0.5, 0.01, 0.3, 0.001]))
    pkt = rtp.RtpPacket(0, 1, 0, 1, b"x")
    r.route(0, pkt)           # loud speaker: forwarded to all others
    assert all(len(outs[i]) == 1 for i in (1, 2, 3))
    r.route(3, pkt)           # quiet member: not in top-2 -> dropped
    assert all(len(outs[i]) == 1 for i in (1, 2))


@pytest.mark.parametrize("pkg", PKGS)
def test_video_router_keyframe_switching(pkg):
    router, rtp = PKGS[pkg]
    reqs = []
    r = router.VideoPacketRouter(request_keyframe=reqs.append)
    outs = {i: [] for i in range(3)}
    for i in range(3):
        r.add_member(i, outs[i].append)
    # member 0 talks first; all outputs lock to it on its keyframe
    r.route(0, rtp.RtpPacket(96, 0, 0, 10, b"kf0"), is_keyframe_start=True)
    assert len(outs[1]) == 1 and len(outs[2]) == 1
    # focus switches to member 1: keyframe requested, no forward until KF
    r.set_focus(1)
    assert reqs == [1]
    r.route(1, rtp.RtpPacket(96, 0, 0, 11, b"p"), is_keyframe_start=False)
    assert len(outs[2]) == 1                # not yet switched
    r.route(1, rtp.RtpPacket(96, 1, 0, 11, b"kf1"), is_keyframe_start=True)
    assert len(outs[2]) == 2                # switched on keyframe
    r.route(0, rtp.RtpPacket(96, 1, 0, 10, b"p0"), is_keyframe_start=False)
    assert len(outs[2]) == 2                # old source no longer forwarded


@pytest.mark.parametrize("pkg", PKGS)
def test_audio_router_ranks_by_level_extension(pkg):
    """The audio SFU ranks speakers from the RFC 6464 header extension
    carried in the packets themselves, with no device volume."""
    router, rtp = PKGS[pkg]
    r = router.AudioPacketRouter(top_n=1)
    sent = {i: [] for i in range(3)}
    for i in range(3):
        r.add_member(i, send=sent[i].append)

    def pkt(level_dbov):
        return rtp.RtpPacket(0, 1, 0, 0x10, b"x" * 20, extensions={1: bytes([level_dbov])})

    # member 0 loud (10 dBov), member 1 quiet (90 dBov)
    r.route(0, pkt(10))
    r.route(1, pkt(90))
    # member 0 is the top speaker: its packets forward, member 1's don't
    n0 = r.route(0, pkt(10))
    n1 = r.route(1, pkt(90))
    assert n0 == 2 and n1 == 0


def _trace(rng, members, n):
    """A seeded packet trace: (kind, member, args) events."""
    out = []
    for k in range(n):
        u = rng.random()
        if u < 0.1:
            out.append(("volumes", None, rng.random(members) ** 3))
        elif u < 0.15:
            out.append(("focus", int(rng.integers(members)), None))
        else:
            ext = ({1: bytes([int(rng.integers(128))])} if rng.random() < 0.3 else None)
            out.append(("packet", int(rng.integers(members)),
                        (int(rng.integers(1 << 16)), int(rng.integers(1 << 32)),
                         rng.bytes(int(rng.integers(1, 200))), bool(rng.random() < 0.2),
                         bool(rng.random() < 0.1), ext)))
    return out


def _replay(pkg, trace, members):
    """Both routers of one package fed the trace; every send recorded as
    (router, to member, bytes), and every audio route's count."""
    router, rtp = PKGS[pkg]
    log = []
    audio = router.AudioPacketRouter(top_n=3)
    video = router.VideoPacketRouter(request_keyframe=lambda i: log.append(("kf", i)))
    for i in range(members):
        audio.add_member(i, lambda d, i=i: log.append(("audio", i, d)))
        video.add_member(i, lambda d, i=i: log.append(("video", i, d)))
    for kind, who, args in trace:
        if kind == "volumes":
            audio.update_volumes(args)
        elif kind == "focus":
            video.set_focus(who)
        else:
            seq, ts, payload, marker, keyframe, ext = args
            pkt = rtp.RtpPacket(96, seq, ts, 0x1000 + who, payload, marker, extensions=ext)
            log.append(("n", audio.route(who, pkt)))
            video.route(who, pkt, is_keyframe_start=keyframe)
    return log


def test_random_trace_forwards_the_same_bytes():
    trace = _trace(np.random.default_rng(13), 6, 3000)
    j, t = _replay("jax", trace, 6), _replay("torch", trace, 6)
    assert t == j
    kinds = {e[0] for e in t}
    assert kinds == {"audio", "video", "kf", "n"}          # every path taken
    assert sum(1 for e in t if e[0] == "video") > 100
