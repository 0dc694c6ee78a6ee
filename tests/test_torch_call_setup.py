"""The port's call setup (``models/call_setup.py``) over real localhost UDP:
ports of ``tests/test_call_setup.py``, driven by ``iterate()`` and
``do_tick`` loops with no pacing sleeps; mixed calls, a JAX ``CallSetup``
against a port one, for each key agreement, ending with mirrored keys; and
a whole call (setup, then G.722 media through ``media_transport()`` into
``AudioStreamBatch``) held by audio_diff to the same call in the JAX
package. UDP arrival differs from run to run, so the two packages'
recordings are held to similarity and energy, not to equal samples. The
DTLS and ZRTP cases skip where libssl or libcrypto is missing."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mediastreamer2_tpu.models import audio_stream as j_as  # noqa: E402
from mediastreamer2_tpu.models import call_setup as j_cs  # noqa: E402
from mediastreamer2_tpu_torch import Factory  # noqa: E402
from mediastreamer2_tpu_torch.core.block import tick_samples  # noqa: E402
from mediastreamer2_tpu_torch.models import audio_stream as t_as  # noqa: E402
from mediastreamer2_tpu_torch.models import call_setup as t_cs  # noqa: E402
from mediastreamer2_tpu_torch.net import dtls, openssl  # noqa: E402
from mediastreamer2_tpu_torch.net.ice import IS_FAILED  # noqa: E402
from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff  # noqa: E402
from mediastreamer2_tpu_torch.utils.signals import make_speechlike  # noqa: E402

S = tick_samples(8000)


@pytest.fixture
def need():
    """``need(key_agreement)``: skip where its library is missing."""
    def check(ka):
        if ka == "dtls" and not dtls.dtls_available():
            pytest.skip("libssl missing")
        if ka == "zrtp" and openssl.libcrypto() is None:
            pytest.skip("libcrypto missing")
    return check


def _connect(a, b, deadline_s=10.0, fingerprints=True):
    """Exchange credentials, candidates and (DTLS) fingerprints, then
    iterate both sides with no sleep until both are ready."""
    if fingerprints and a.dtls is not None:
        a.set_remote_fingerprint(b.local_fingerprint())
        b.set_remote_fingerprint(a.local_fingerprint())
    a.set_remote(*b.local_credentials(), [("127.0.0.1", b.sock.local_port)])
    b.set_remote(*a.local_credentials(), [("127.0.0.1", a.sock.local_port)])
    return _drive(a, b, deadline_s)


def _drive(a, b, deadline_s):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline and not (a.ready and b.ready):
        a.iterate()
        b.iterate()
    return a.ready and b.ready


def _mirrored(a, b):
    return a.srtp_keys[:2] == b.srtp_keys[2:] and a.srtp_keys[2:] == b.srtp_keys[:2]


def _media(make_stream, a, b, sig, ticks):
    """``ticks`` do_ticks of a sender on ``a``'s media transport and a
    recorder on ``b``'s, then 20 more of the recorder; its recording."""
    tx = make_stream(mic_signal=sig)
    rx = make_stream(record_ticks=ticks + 20)
    tx.set_transport(0, a.media_transport())
    rx.set_transport(0, b.media_transport())
    for s in (tx, rx):
        s.ticker.realtime = False
        s.ticker.warm_up()
    for _ in range(ticks):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
    for _ in range(20):
        rx.ticker.do_tick()
    return np.asarray(rx.get_recording())[0], rx


def _port_stream(**kw):
    return t_as.AudioStreamBatch(Factory(), 1, device="cpu", **kw)


@pytest.mark.parametrize("ka", ["none", "dtls", "zrtp"])
def test_ice_then_media(need, ka):
    """Ports of test_ice_then_media, test_ice_dtls_srtp_media and
    test_ice_zrtp_media_sas: nomination, keys (equal SAS for ZRTP), then
    mu-law media over the nominated pair."""
    need(ka)
    a = t_cs.CallSetup(controlling=True, key_agreement=ka)
    b = t_cs.CallSetup(controlling=False, key_agreement=ka)
    try:
        assert _connect(a, b)
        assert a.check_list.selected is not None and b.check_list.selected is not None
        if ka != "none":
            assert _mirrored(a, b) and a.srtp_suite == b.srtp_suite
        if ka == "zrtp":
            assert a.sas is not None and a.sas == b.sas
        ticks = 80
        sig = make_speechlike(S * ticks, 8000, seed=17)
        rec, rx = _media(_port_stream, a, b, sig, ticks)
        sim, _ = audio_diff(sig, rec)
        assert sim > 0.9, f"{ka}: sim {sim}"
        if ka != "none":
            assert rx.sessions[0].transport.auth_failures == 0
        assert b.demuxed["media"] > ticks // 2
    finally:
        a.close()
        b.close()


def test_dtls_fingerprint_verified(need):
    """Matching SDP fingerprints: ready. A wrong one on one side: that side
    ends security_failed with no keys, and media_transport() raises."""
    need("dtls")
    a = t_cs.CallSetup(controlling=True, key_agreement="dtls")
    b = t_cs.CallSetup(controlling=False, key_agreement="dtls")
    try:
        assert _connect(a, b)
        assert a.srtp_keys is not None and not a.security_failed
    finally:
        a.close()
        b.close()
    a = t_cs.CallSetup(controlling=True, key_agreement="dtls")
    b = t_cs.CallSetup(controlling=False, key_agreement="dtls")
    try:
        a.set_remote_fingerprint("sha-256 " + ":".join(["00"] * 32))
        b.set_remote_fingerprint(a.local_fingerprint())
        assert not _connect(a, b, deadline_s=3.0, fingerprints=False)
        assert a.security_failed and a.srtp_keys is None and a.dtls.is_established
        with pytest.raises(AssertionError):
            a.media_transport()
    finally:
        a.close()
        b.close()


def test_trickle_ice_call_setup():
    """RFC 8838 at the CallSetup surface: no candidates at first (the list
    stays open), then they trickle in and the call completes."""
    a = t_cs.CallSetup(controlling=True)
    b = t_cs.CallSetup(controlling=False)
    try:
        a.set_remote(*b.local_credentials(), [], trickle=True)
        b.set_remote(*a.local_credentials(), [], trickle=True)
        for _ in range(20):
            a.iterate()
            b.iterate()
        assert a.ice.state != IS_FAILED and b.ice.state != IS_FAILED and not a.ready
        a.add_candidate("127.0.0.1", b.sock.local_port)
        b.add_candidate("127.0.0.1", a.sock.local_port)
        a.end_of_candidates()
        b.end_of_candidates()
        assert _drive(a, b, 10.0)
        assert a.check_list.selected is not None
    finally:
        a.close()
        b.close()


def test_demux_counts_each_kind():
    """What poll() sorts: STUN to ICE, the rest to the media view."""
    a = t_cs.CallSetup(controlling=True)
    b = t_cs.CallSetup(controlling=False)
    try:
        assert _connect(a, b)
        stun_seen = a.demuxed["stun"] + b.demuxed["stun"]
        assert stun_seen >= 4 and a.demuxed["dtls"] == a.demuxed["zrtp"] == 0
        a.media_transport().send(b"\x80\x00\x00\x01" + bytes(8) + b"media")
        assert b.media_transport().recv_all() == [b"\x80\x00\x00\x01" + bytes(8) + b"media"]
        assert b.demuxed["media"] == 1
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("ka", ["none", "dtls", "zrtp"])
@pytest.mark.parametrize("controlling", ["jax", "torch"])
def test_mixed_call(need, ka, controlling):
    """A JAX CallSetup against a port one over localhost UDP: ICE completes,
    the keys mirror, the suites agree, the SAS strings match."""
    need(ka)
    mods = {"jax": j_cs, "torch": t_cs}
    other = "torch" if controlling == "jax" else "jax"
    a = mods[controlling].CallSetup(controlling=True, key_agreement=ka)
    b = mods[other].CallSetup(controlling=False, key_agreement=ka)
    try:
        assert _connect(a, b)
        assert a.check_list.selected is not None and b.check_list.selected is not None
        if ka != "none":
            assert _mirrored(a, b) and a.srtp_suite == b.srtp_suite
        if ka == "dtls":
            assert a.srtp_suite == "AEAD_AES_128_GCM"
        if ka == "zrtp":
            assert a.sas is not None and a.sas == b.sas
    finally:
        a.close()
        b.close()


def test_whole_g722_call_matches_jax(need, factory):
    """Setup by DTLS-SRTP (AEAD_AES_128_GCM), then 16 kHz G.722 media
    through media_transport(): the port's whole call on the CPU against the
    JAX package's, each recording held to the speech sent, and the two
    recordings held to each other by audio_diff and energy."""
    ka = "dtls"
    need(ka)
    ticks, rate = 100, 16000
    sig = make_speechlike(tick_samples(rate) * ticks, rate, seed=23)
    recs = {}
    for name, cs, make in (
            ("jax", j_cs, lambda **kw: j_as.AudioStreamBatch(factory, 1, codec="g722",
                                                             rate=rate, **kw)),
            ("torch", t_cs, lambda **kw: _port_stream(codec="g722", rate=rate, **kw))):
        a = cs.CallSetup(controlling=True, key_agreement=ka)
        b = cs.CallSetup(controlling=False, key_agreement=ka)
        try:
            assert _connect(a, b)
            recs[name], _ = _media(make, a, b, sig, ticks)
        finally:
            a.close()
            b.close()
    settle = 40 * tick_samples(rate)            # G.722's start transient (as phase 8)
    for name, rec in recs.items():
        sim, lag = audio_diff(sig, rec)
        assert sim > 0.9, f"{name}: sim {sim}"
    j, t = recs["jax"][settle:], recs["torch"][settle:]
    sim, _ = audio_diff(j, t)
    gap_db = 10 * np.log10((np.mean(t.astype(np.float64) ** 2) + 1e-20)
                           / (np.mean(j.astype(np.float64) ** 2) + 1e-20))
    assert sim > 0.99, f"port vs JAX recording sim {sim}"
    assert abs(gap_db) < 1.5, f"port vs JAX energy gap {gap_db} dB"
