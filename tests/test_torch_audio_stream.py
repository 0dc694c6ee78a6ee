"""The port's session layer (``models/audio_stream.py``,
``models/conference.py``) against the JAX package's on the CPU: two-
endpoint calls over loopback RTP (the reference's "marielle/margaux"
tester pattern) and conference servers, each fixture run by both packages
with ``do_tick`` loops (no wall clock), then compared:

* the G.711 codes each stream sends, tick by tick, without the echo
  canceller: equal. A float sum of the port's that landed on the other
  side of a mu-law decision boundary would flip a code; in these fixtures
  none does (0 codes differ);
* the recordings: the bar of ``tools/tpu_correctness.py`` (similarity
  >= 0.999, rms error <= 5e-3, energy gap <= 1.5 dB) on every leg that
  carries audio;
* the fixture's own bars from ``tests/test_audio_stream.py`` and
  ``tests/test_conference_server.py``.
"""
import socket
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each, so that parallel test workers running
# real-time paced tests are not crowded by idle OpenMP threads
torch.set_num_threads(1)

from mediastreamer2_tpu.models import audio_stream as j_as  # noqa: E402
from mediastreamer2_tpu.models import conference as j_conf  # noqa: E402
from mediastreamer2_tpu.net import rtp as j_rtp  # noqa: E402
from mediastreamer2_tpu.net.netsim import NetSimParams, NetworkSimulator  # noqa: E402
from mediastreamer2_tpu_torch import Factory  # noqa: E402
from mediastreamer2_tpu_torch import native  # noqa: E402
from mediastreamer2_tpu_torch.models import audio_stream as t_as  # noqa: E402
from mediastreamer2_tpu_torch.models import conference as t_conf  # noqa: E402
from mediastreamer2_tpu_torch.net import rtp as t_rtp  # noqa: E402
from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff, quality_bar  # noqa: E402
from mediastreamer2_tpu_torch.utils.signals import make_speechlike  # noqa: E402

RATE = 8000
S = RATE // 100


class _Pkg(types.SimpleNamespace):
    """One package's session API, so that each fixture is written once."""

    def stream(self, B, record=0, **kw):
        feats = kw.pop("features", {})
        s = self.mod.AudioStreamBatch(self.factory, B, rate=RATE, record_ticks=record,
                                      features=self.mod.AudioStreamFeatures(**feats),
                                      **kw, **self.kw)
        s.ticker.realtime = False
        s.codes = []                              # the rtp_tx codes of every tick
        push = s.ticker._io_push

        def tapped(tick, out):
            s.codes.append(np.asarray(out["rtp_tx"]).copy())
            push(tick, out)
        s.ticker.set_io(pull=s.ticker._io_pull, push=tapped)
        return s

    def control(self, server):
        return self.conf.AudioConferenceControl(server.ticker, "conf", "levels")


@pytest.fixture(scope="module")
def pkgs(factory):
    return {"jax": _Pkg(name="jax", mod=j_as, conf=j_conf, rtp=j_rtp, factory=factory,
                        kw={}),
            "torch": _Pkg(name="torch", mod=t_as, conf=t_conf, rtp=t_rtp, factory=Factory(),
                          kw={"device": "cpu"})}


def _connect(pkg, a, b, legs, netsim=None):
    for leg in legs:
        pair = pkg.rtp.LoopbackPair(netsim=NetworkSimulator(netsim) if netsim else None)
        a.set_transport(leg, pair.endpoint(0))
        b.set_transport(leg, pair.endpoint(1))


def _alternate(a, b, ticks, b_extra=0):
    """a then b, once a tick each, then b alone for ``b_extra`` ticks."""
    for _ in range(ticks):
        a.ticker.do_tick()
        b.ticker.do_tick()
    for _ in range(b_extra):
        b.ticker.do_tick()


def _both(pkgs, fixture, **kw):
    return fixture(pkgs["jax"], **kw), fixture(pkgs["torch"], **kw)


def _codes_agree(j, t):
    """The two streams sent the same codes, tick by tick."""
    np.testing.assert_array_equal(np.stack(t.codes), np.stack(j.codes))


def _recordings_agree(j_rec, t_rec, legs):
    bar = quality_bar(np.asarray(j_rec)[legs], np.asarray(t_rec)[legs], leg_step=1)
    assert bar["pass"], bar


# -- tests/test_audio_stream.py ------------------------------------------------
def _call(pkg, B=2, ticks=120, netsim=None, tx_features=None, seed=11):
    sig = make_speechlike(S * ticks, RATE, seed=seed)
    tx = pkg.stream(B, mic_signal=sig, features=tx_features or {})
    rx = pkg.stream(B, record=ticks + 50)
    tx.ticker.warm_up()
    rx.ticker.warm_up()
    _connect(pkg, tx, rx, range(B), netsim)
    _alternate(tx, rx, ticks + 20, b_extra=30)
    return sig, tx, rx, rx.get_recording()


def test_call_clean_channel(pkgs):
    (sig, jtx, jrx, jrec), (_, ttx, trx, trec) = _both(pkgs, _call)
    for leg in range(2):
        sim, shift = audio_diff(sig, trec[leg])
        assert sim > 0.9, f"leg {leg}: sim {sim}"
        assert 0 <= shift < 20 * S
    assert trx.sessions[0].stats.recv_packets > 100
    assert ttx.sessions[0].stats.sent_packets > 100
    _codes_agree(jtx, ttx)
    _recordings_agree(jrec, trec, [0, 1])
    np.testing.assert_allclose(trec, jrec, rtol=0, atol=1e-6)


def test_call_with_loss_plc(pkgs):
    """10% seeded loss: the receiver's jitter buffer marks the gaps and
    the PLC conceals them (with JAX's comfort-noise bits)."""
    ns = NetSimParams(loss_rate=10.0, seed=3)
    (sig, _, jrx, jrec), (_, _, trx, trec) = _both(pkgs, _call, ticks=150, netsim=ns)
    assert trx.sessions[0].jitter_buffer.lost > 0
    assert trx.sessions[0].jitter_buffer.lost == jrx.sessions[0].jitter_buffer.lost
    sim, _ = audio_diff(sig, trec[0])
    assert sim > 0.75, f"PLC-concealed sim {sim}"
    np.testing.assert_allclose(trec, jrec, rtol=0, atol=1e-6)


class _Clock:
    """A virtual monotonic clock that both packages' RTP modules read, so
    that a jittered network is deterministic."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def test_call_with_jitter(pkgs, monkeypatch):
    """Jitter up to 30 ms plus 20 ms latency on a virtual clock advanced
    10 ms a tick."""
    clock = _Clock()
    for mod in (j_rtp, t_rtp):
        monkeypatch.setattr(mod, "time", clock)
    ns = NetSimParams(jitter_strength_ms=30.0, latency_ms=20, seed=4)

    def call(pkg):
        clock.now = 1000.0
        sig = make_speechlike(S * 150, RATE, seed=11)
        tx = pkg.stream(1, mic_signal=sig)
        rx = pkg.stream(1, record=200)
        _connect(pkg, tx, rx, [0], ns)
        for _ in range(190):
            tx.ticker.do_tick()
            rx.ticker.do_tick()
            clock.now += 0.01
        return sig, rx.get_recording()
    (sig, jrec), (_, trec) = _both(pkgs, call)
    sim, _ = audio_diff(sig, trec[0])
    assert sim > 0.8, f"jittered sim {sim}"
    np.testing.assert_allclose(trec, jrec, rtol=0, atol=1e-6)


def test_call_dtx_stops_packets(pkgs):
    """VAD/DTX on the sender: speech for 60 ticks, then silence; RFC 3389
    CN at the onset, then no packets."""
    def call(pkg):
        sig = make_speechlike(S * 150, RATE, seed=2)
        sig[60 * S:] = 0.0
        tx = pkg.stream(1, mic_signal=sig, features={"vad_dtx": True})
        rx = pkg.stream(1, record=150)
        _connect(pkg, tx, rx, [0])
        _alternate(tx, rx, 150, b_extra=20)
        return tx, rx.get_recording()
    (jtx, jrec), (ttx, trec) = _both(pkgs, call)
    sent = ttx.sessions[0].stats.sent_packets
    assert 40 < sent < 130, f"DTX should suppress packets, sent {sent}"
    assert sent == jtx.sessions[0].stats.sent_packets
    _codes_agree(jtx, ttx)
    np.testing.assert_allclose(trec, jrec, rtol=0, atol=1e-6)


def test_mixed_call_recording(pkgs):
    """record_mixed: the recording holds the local mic (1700 Hz) and the
    far end (433 Hz); a receive-only recording holds the far end only."""
    ticks = 120
    t = np.arange(S * ticks) / RATE
    mic_a = (0.3 * np.sin(2 * np.pi * 433 * t)).astype(np.float32)
    mic_b = (0.3 * np.sin(2 * np.pi * 1700 * t)).astype(np.float32)

    def band_peak(rec, f):
        spec = np.abs(np.fft.rfft(rec))
        freqs = np.fft.rfftfreq(len(rec), 1 / RATE)
        return spec[(freqs > f - 20) & (freqs < f + 20)].max(), np.median(spec)

    def call(pkg, record_mixed):
        a = pkg.stream(1, mic_signal=mic_a)
        b = pkg.stream(1, mic_signal=mic_b, record=ticks + 40, record_mixed=record_mixed)
        _connect(pkg, a, b, [0])
        _alternate(a, b, ticks + 10, b_extra=30)
        return b.get_recording()[0]
    for mixed in (True, False):
        jrec, trec = _both(pkgs, call, record_mixed=mixed)
        np.testing.assert_allclose(trec, jrec, rtol=0, atol=1e-6)
        far, far_med = band_peak(trec, 433)
        own, own_med = band_peak(trec, 1700)
        assert far / (far_med + 1e-9) > 50
        if mixed:
            mixed_own = own
            assert own / (own_med + 1e-9) > 50
    assert own < mixed_own / 20                  # own mic absent when not mixed


def test_mic_mute_gains_and_rtp_mute(pkgs):
    """enable_mic / set_mic_gain_db / set_spk_gain_db / mute_rtp: a muted
    mic sends silence, gains scale levels, rtp-mute stops packets."""
    ticks = 60

    def call(pkg):
        sig = make_speechlike(S * ticks, RATE, seed=61)
        tx = pkg.stream(3, mic_signal=sig)
        rx = pkg.stream(3, record=ticks + 40)
        _connect(pkg, tx, rx, range(3))
        tx.enable_mic(0, False)                 # leg 0: mic muted
        tx.set_mic_gain_db(2, -6.0)             # leg 2: -6 dB
        rx.set_spk_gain_db(1, 3.0)              # leg 1: +3 dB at the speaker
        _alternate(tx, rx, ticks + 10, b_extra=30)
        tx2 = pkg.stream(2, mic_signal=sig)
        p0, p1 = pkg.rtp.LoopbackPair(), pkg.rtp.LoopbackPair()
        tx2.set_transport(0, p0.endpoint(0))
        tx2.set_transport(1, p1.endpoint(0))
        tx2.mute_rtp(0, True)
        for _ in range(30):
            tx2.ticker.do_tick()
        return sig, tx, rx.get_recording(), tx2
    (sig, jtx, jrec, _), (_, ttx, trec, ttx2) = _both(pkgs, call)
    assert np.abs(trec[0][S * 40:]).max() < 1e-2        # silence came through
    assert audio_diff(sig, trec[1])[0] > 0.9
    e = (trec[:, S * 40:S * ticks] ** 2).mean(axis=1)
    assert e[1] > e[2] * 4                                # +3 dB vs -6 dB
    assert ttx2.sessions[0].stats.sent_packets == 0
    assert ttx2.sessions[1].stats.sent_packets > 20
    _codes_agree(jtx, ttx)
    np.testing.assert_allclose(trec[0], jrec[0], rtol=0, atol=1e-6)
    _recordings_agree(jrec, trec, [1, 2])


def test_stream_direction_one_way(pkgs):
    """set_direction: a sendonly leg discards inbound media; a recvonly leg
    emits no RTP."""
    ticks = 60

    def call(pkg):
        sig = make_speechlike(S * ticks, RATE, seed=71)
        a = pkg.stream(1, mic_signal=sig, record=ticks + 20)
        b = pkg.stream(1, mic_signal=sig, record=ticks + 20)
        _connect(pkg, a, b, [0])
        a.set_direction(0, "sendonly")
        assert a.get_direction(0) == "sendonly"
        _alternate(a, b, ticks + 10, b_extra=10)
        c = pkg.stream(1, mic_signal=sig)
        c.set_transport(0, pkg.rtp.LoopbackPair().endpoint(0))
        c.set_direction(0, "recvonly")
        for _ in range(30):
            c.ticker.do_tick()
        return sig, a.get_recording(), b.get_recording(), c
    (sig, ja, jb, _), (_, ta, tb, tc) = _both(pkgs, call)
    assert audio_diff(sig, tb[0])[0] > 0.9
    assert np.abs(ta[0][S * 5:]).max() < 1e-3
    assert tc.sessions[0].stats.sent_packets == 0
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-6)


def test_echo_limiter_is_one_tick_behind(pkgs):
    """The echo limiter ducks the send volume on the receive side's energy
    of the PREVIOUS tick: before each step the port copies vol_recv's
    energy into vol_send's ``peer_energy`` (a copy, not an alias that the
    step would overwrite). The sent codes match the JAX package, whose
    param is the previous tick's state array."""
    ticks = 60

    def call(pkg):
        sig = make_speechlike(S * ticks, RATE, seed=5)
        a = pkg.stream(2, mic_signal=sig)
        b = pkg.stream(2, mic_signal=sig[::-1].copy())
        _connect(pkg, a, b, range(2))
        for s in (a, b):
            p = s.ticker.params["vol_send"]
            if pkg.name == "jax":
                p["ea_enabled"] = p["ea_enabled"].at[0].set(True)
            else:
                p["ea_enabled"][0] = True
        energies, peers = [], []
        for _ in range(ticks):
            a.ticker.do_tick()
            b.ticker.do_tick()
            peers.append(np.asarray(b.ticker.params["vol_send"]["peer_energy"]).copy())
            energies.append(np.asarray(b.ticker.state["vol_recv"]["energy"]).copy())
        return a, b, np.stack(energies), np.stack(peers)
    (ja, jb, je, jp), (ta, tb, te, tp) = _both(pkgs, call)
    np.testing.assert_array_equal(tp[1:], te[:-1])        # one tick behind
    assert not np.array_equal(tp[1:], te[1:])
    st, pr = tb.ticker.state["vol_recv"]["energy"], tb.ticker.params["vol_send"]["peer_energy"]
    assert st.data_ptr() != pr.data_ptr()
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-9)
    for j, t in ((ja, ta), (jb, tb)):
        _codes_agree(j, t)


# -- tests/test_conference_server.py -------------------------------------------
def _conference(pkg, n, ticks, talkers, features=None, churn=None, seed=42):
    """n client legs against a conference server over loopback RTP, all in
    conference 0; legs ``talkers`` speak. ``churn`` = (tick, leaver,
    joiner). Returns the clients, the server, its control and the active
    talkers at the end (the talkers still speak)."""
    sig = make_speechlike(S * (ticks + 40), RATE, seed=seed)
    mic = np.zeros((n, S * (ticks + 40)), np.float32)
    for leg in talkers:
        mic[leg] = sig
    clients = pkg.stream(n, mic_signal=mic, record=ticks + 50, features=features or {})
    server = pkg.stream(n, conference=True)
    ctl = pkg.control(server)
    conf = ctl.new_conference()
    _connect(pkg, clients, server, range(n))
    first = [leg for leg in range(n) if churn is None or leg != churn[2]]
    for leg in first:
        ctl.add_member(leg, conf)
    clients.ticker.warm_up()
    server.ticker.warm_up()
    for t in range(ticks + 30):
        if churn is not None and t == churn[0]:
            ctl.remove_member(churn[1])
            ctl.add_member(churn[2], conf)
        clients.ticker.do_tick()
        server.ticker.do_tick()
    return sig[: S * ticks], clients, server, ctl, ctl.active_talkers()


@pytest.mark.parametrize("aec", [False, True], ids=["plain", "aec_agc"])
def test_three_way_conference_mix_minus(pkgs, aec):
    """Leg 0 talks: legs 1 and 2 hear it, leg 0 does not hear itself, and
    the server names leg 0 the active talker while it still speaks. ``aec_agc`` gives the
    clients the echo canceller and AGC (the chip run's client shape)."""
    ticks = 150
    feats = {"echo_canceller": True, "agc": True} if aec else {}
    (sig, jcl, jsv, _, jtalk), (_, tcl, tsv, _, ttalk) = _both(
        pkgs, _conference, n=3, ticks=ticks, talkers=[0], features=feats)
    jrec, trec = jcl.get_recording(), tcl.get_recording()
    for leg in (1, 2):
        sim, _ = audio_diff(sig, trec[leg])
        assert sim > (0.75 if aec else 0.85), f"listener {leg} sim {sim}"
    assert float((trec[0] ** 2).mean()) < float((trec[1] ** 2).mean()) * 0.05
    assert ttalk == jtalk == {0: [0]}
    _recordings_agree(jrec, trec, [1, 2])
    if not aec:
        _codes_agree(jcl, tcl)
        _codes_agree(jsv, tsv)


def test_conference_membership_churn(pkgs):
    """Mid-call leave and join as a params update: the graph object stays,
    the leaver goes quiet, the joiner starts hearing the talker."""
    ticks, n = 240, 4
    third = ticks // 3
    (_, jcl, jsv, _, _), (_, tcl, tsv, _, _) = _both(
        pkgs, _conference, n=n, ticks=ticks, talkers=[0], churn=(third, 2, 3), seed=9)
    rec = tcl.get_recording()
    seg1 = slice(S * 10, S * (third - 5))
    seg2 = slice(S * (third + 20), S * ticks)
    for seg in (seg1, seg2):
        assert float((rec[1][seg] ** 2).mean()) > 1e-4
    assert float((rec[2][seg1] ** 2).mean()) > 1e-4
    assert float((rec[2][seg2] ** 2).mean()) < 1e-6
    assert float((rec[3][seg1] ** 2).mean()) < 1e-6
    assert float((rec[3][seg2] ** 2).mean()) > 1e-4
    _codes_agree(jcl, tcl)
    _codes_agree(jsv, tsv)
    np.testing.assert_allclose(rec, jcl.get_recording(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("gso", ["probe", "off"])
def test_conference_server_on_batch_edge(pkgs, monkeypatch, gso):
    """The conference server and its clients on the native batched edge,
    all legs on one localhost socket pair. The port sends with UDP GSO
    only where ``native.udp_gso_supported()`` says the kernel takes it;
    ``off`` forces the sendmmsg path (the chip host's case)."""
    if not native.rtp_edge_available():
        pytest.skip("g++ is not installed")
    if gso == "off":
        monkeypatch.setattr(native, "udp_gso_supported", lambda: False)
    B, ticks = 4, 80

    def call(pkg):
        socks = []
        for _ in range(2):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.bind(("127.0.0.1", 0))
            s.setblocking(False)
            socks.append(s)
        srv, cli = socks
        try:
            sig = make_speechlike(S * ticks, RATE, seed=41)
            clients = pkg.stream(B, mic_signal=sig, record=ticks + 40)
            clients.enable_batch_edge(rx_sock=cli, tx_sock=cli, remote=srv.getsockname(),
                                      ssrc_base=0x6000)
            server = pkg.stream(B, conference=True)
            server.enable_batch_edge(rx_sock=srv, tx_sock=srv, remote=cli.getsockname(),
                                     ssrc_base=0x6000)
            ctl = pkg.control(server)
            for leg in range(B):
                ctl.add_member(leg, 0)
            clients.ticker.warm_up()
            server.ticker.warm_up()
            _alternate(clients, server, ticks + 20)
            return (clients, server, clients.get_recording(),
                    [server._edge_rx.stats(i)["recv"] for i in range(B)])
        finally:
            srv.close()
            cli.close()
    if gso == "off":                      # the JAX package always turns GSO on
        jcl = jsv = jrec = None
        tcl, tsv, trec, recv = call(pkgs["torch"])
        assert tsv.gso is False and tcl.gso is False
    else:
        (jcl, jsv, jrec, _), (tcl, tsv, trec, recv) = _both(pkgs, call)
        assert tsv.gso == native.udp_gso_supported()
    assert np.abs(trec).max() > 0.01
    assert min(recv) >= ticks // 2
    if jcl is not None:
        _codes_agree(jcl, tcl)
        _codes_agree(jsv, tsv)
        np.testing.assert_allclose(trec, jrec, rtol=0, atol=1e-6)


def test_session_entry_points_run_on_the_card_unless_told_cpu(monkeypatch):
    """``device=None`` is the card: without one the stream raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_as.AudioStreamBatch(Factory(), 1)


def test_waiting_features_raise():
    """What still waits raises, naming its wait (G.722, SRTP, RTCP and
    iterate are ported now: tests/test_torch_g722.py, test_torch_srtp.py,
    test_torch_rtcp_qos.py)."""
    f = Factory()
    for kw in ({"codec": "opus"}, {"codec": "g726_32"},
               {"features": t_as.AudioStreamFeatures(baudot=True)}):
        with pytest.raises(NotImplementedError, match="not ported"):
            t_as.AudioStreamBatch(f, 1, device="cpu", **kw)
    s = t_as.AudioStreamBatch(f, 1, device="cpu")
    s.set_transport(0, t_rtp.LoopbackPair().endpoint(0))
    for fn in (lambda: s.link_video(None), lambda: s.save_av_recording("x.mkv")):
        with pytest.raises(NotImplementedError, match="not ported"):
            fn()
