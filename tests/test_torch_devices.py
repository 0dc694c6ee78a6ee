"""The port's device layer (``core/quirks.py``, ``core/devices.py``,
``core/alsa.py``, ``core/pulse.py``, ``core/v4l2.py``, ``ops/screenshare.py``)
against the JAX package's on the CPU: the seven cases of
``tests/test_quirks_alsa.py`` and the card, webcam and gain cases of
``tests/test_native_and_devices.py``. Where both packages compute
something (quirk features, the pixel conversions, a card's blocks, the
quirk-configured streams' recordings) the port's equals JAX's; the gated
backends register nothing and raise naming their library where it is
missing, as in the JAX package."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mediastreamer2_tpu.core import alsa as j_alsa  # noqa: E402
from mediastreamer2_tpu.core import devices as j_dev  # noqa: E402
from mediastreamer2_tpu.core import pulse as j_pulse  # noqa: E402
from mediastreamer2_tpu.core import quirks as j_q  # noqa: E402
from mediastreamer2_tpu.core import v4l2 as j_v4l2  # noqa: E402
from mediastreamer2_tpu.models import audio_stream as j_as  # noqa: E402
from mediastreamer2_tpu.net import rtp as j_rtp  # noqa: E402
from mediastreamer2_tpu.ops import screenshare as j_ss  # noqa: E402
from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder  # noqa: E402
from mediastreamer2_tpu_torch.core import alsa as t_alsa  # noqa: E402
from mediastreamer2_tpu_torch.core import devices as t_dev  # noqa: E402
from mediastreamer2_tpu_torch.core import pulse as t_pulse  # noqa: E402
from mediastreamer2_tpu_torch.core import quirks as t_q  # noqa: E402
from mediastreamer2_tpu_torch.core import v4l2 as t_v4l2  # noqa: E402
from mediastreamer2_tpu_torch.core.ticker import Ticker  # noqa: E402
from mediastreamer2_tpu_torch.models import audio_stream as t_as  # noqa: E402
from mediastreamer2_tpu_torch.net import rtp as t_rtp  # noqa: E402
from mediastreamer2_tpu_torch.ops import screenshare as t_ss  # noqa: E402
from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff  # noqa: E402
from mediastreamer2_tpu_torch.utils.signals import make_speechlike  # noqa: E402


# -- tests/test_quirks_alsa.py --------------------------------------------------
def test_quirk_lookup_and_apply():
    q = t_q.lookup_quirks("Jabra", "SPEAK 510")
    assert q is not None and q.flags & t_q.HAS_BUILTIN_AEC
    ft = t_q.apply_quirks(t_as.AudioStreamFeatures(echo_canceller=True, agc=True), q)
    assert ft.echo_canceller is False and ft.agc is True       # the device cancels echo
    for model in (("Jabra", "SPEAK 510"), ("poly", "sync 20"), ("generic", "usb headset")):
        jq, tq = j_q.lookup_quirks(*model), t_q.lookup_quirks(*model)
        assert dataclasses.asdict(tq) == dataclasses.asdict(jq)
        jf = j_q.apply_quirks(j_as.AudioStreamFeatures(echo_canceller=True, agc=True), jq)
        tf = t_q.apply_quirks(t_as.AudioStreamFeatures(echo_canceller=True, agc=True), tq)
        assert dataclasses.asdict(tf) == dataclasses.asdict(jf)
    ft2 = t_q.apply_quirks(t_as.AudioStreamFeatures(), t_q.lookup_quirks("generic", "usb headset"))
    assert ft2.mic_eq_gains and ft2.ec_delay_ms == 120
    assert t_q.lookup_quirks("unknown", "device") is None
    t_q.register_quirks(t_q.DeviceQuirks("acme", "box", flags=t_q.HAS_BUILTIN_AGC))
    try:
        assert t_q.apply_quirks(t_as.AudioStreamFeatures(agc=True),
                                t_q.lookup_quirks("ACME", "Box")).agc is False
    finally:
        t_q._DB.pop(("acme", "box"))


def _quirk_call(mod, rtp, factory, kw, ft, sig, ticks):
    tx = mod.AudioStreamBatch(factory, 1, mic_signal=sig, features=ft, **kw)
    rx = mod.AudioStreamBatch(factory, 1, record_ticks=ticks + 40, features=ft, **kw)
    pair = rtp.LoopbackPair()
    tx.set_transport(0, pair.endpoint(0))
    rx.set_transport(0, pair.endpoint(1))
    tx.ticker.realtime = rx.ticker.realtime = False
    tx.ticker.warm_up()
    rx.ticker.warm_up()
    for _ in range(ticks + 10):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
    return tx, rx, rx.get_recording()[0]


def test_quirk_eq_built_into_stream(factory):
    """A stream built with the quirk's EQ gains carries mic_eq / spk_eq and
    still passes audio (> 0.85); unpaced here, tick by tick, the port's
    recording equals JAX's to 1e-5."""
    S, ticks = 80, 80
    sig = make_speechlike(S * ticks, 8000, seed=3)
    recs = []
    for mod, q, rtp, f, kw in ((j_as, j_q, j_rtp, factory, {}),
                               (t_as, t_q, t_rtp, Factory(), {"device": "cpu"})):
        ft = q.apply_quirks(mod.AudioStreamFeatures(), q.lookup_quirks("generic", "usb headset"))
        ft.spk_eq_gains = [(1000.0, 0.9, 400.0)]
        tx, rx, rec = _quirk_call(mod, rtp, f, kw, ft, sig, ticks)
        assert "mic_eq" in tx.ticker.state and "spk_eq" in rx.ticker.state
        recs.append(rec)
    np.testing.assert_allclose(recs[1], recs[0], atol=1e-5)
    sim, _ = audio_diff(sig, recs[1])
    assert sim > 0.85, sim


def test_alsa_gated_detection():
    """Without libasound detection registers nothing and never raises (with
    it, the card registers as alsa:default), as in the JAX package."""
    assert t_alsa.alsa_available() == j_alsa.alsa_available()
    mgr = t_dev.SndCardManager()
    t_alsa.detect_alsa_cards(mgr)
    if t_alsa.alsa_available():
        assert mgr.get_card("alsa:default") is not None
    else:
        assert mgr.get_card("alsa:default") is None
        with pytest.raises(RuntimeError, match="libasound"):
            t_alsa.AlsaSndCard()


def test_screenshare_gated_and_pixel_path():
    """Headless: the gate is False without X11 / DISPLAY and the source
    raises; the BGRA -> I420 pixel path equals JAX's and reads red right
    (BT.601)."""
    assert t_ss.screenshare_available() == j_ss.screenshare_available()
    if not t_ss.screenshare_available():
        with pytest.raises(RuntimeError):
            t_ss.ScreenShareSource(64, 48)
    bgra = np.zeros((48, 64, 4), np.uint8)
    bgra[..., 2] = 255
    block = t_ss.bgra_to_i420_block(bgra)
    assert block.shape == (72, 64)
    y, uv = block[:48], block[48:].reshape(24, 2, 32)
    assert abs(y.mean() - (0.257 * 255 + 16) / 255) < 0.01
    assert abs(uv[:, 0].mean() - (-0.148 * 255 + 128) / 255) < 0.01
    assert abs(uv[:, 1].mean() - (0.439 * 255 + 128) / 255) < 0.01
    noise = np.random.default_rng(4).integers(0, 256, (48, 64, 4), dtype=np.uint8)
    np.testing.assert_array_equal(t_ss.bgra_to_i420_block(noise), j_ss.bgra_to_i420_block(noise))


def test_v4l2_gated_and_yuyv_conversion():
    """Headless: no /dev/video* -> gated; the YUYV -> I420 path is exact and
    equals JAX's."""
    assert t_v4l2.list_devices() == j_v4l2.list_devices()
    if not t_v4l2.list_devices():
        assert t_v4l2.v4l2_available() is False
    w, h = 8, 4
    yuyv = np.zeros((h, w * 2), np.uint8)
    yuyv[:, 0::4], yuyv[:, 2::4], yuyv[:, 1::4], yuyv[:, 3::4] = 200, 100, 60, 180
    block = t_v4l2.yuyv_to_i420_block(yuyv, w, h)
    assert block.shape == (h * 3 // 2, w)
    np.testing.assert_allclose((block[:h] * 255)[:, 0::2], 200, atol=0.5)
    np.testing.assert_allclose((block[:h] * 255)[:, 1::2], 100, atol=0.5)
    uv = (block[h:] * 255).reshape(h // 2, 2, w // 2)
    np.testing.assert_allclose(uv[:, 0], 60, atol=0.5)
    np.testing.assert_allclose(uv[:, 1], 180, atol=0.5)
    noise = np.random.default_rng(5).integers(0, 256, (16, 32), dtype=np.uint8)
    np.testing.assert_array_equal(t_v4l2.yuyv_to_i420_block(noise, 16, 16),
                                  j_v4l2.yuyv_to_i420_block(noise, 16, 16))


def test_delay_line_and_ec_delay_wiring():
    """delay_line shifts each leg by whole ticks; a stream built with the
    ec_delay_ms quirk carries the delay node ahead of the AEC's far pin."""
    S = 80
    g = GraphBuilder(Factory(), batch=2)
    g.chain(g.add("ext_source", "in", fmt=Format(rate=8000)),
            g.add("delay_line", "dl", max_delay_ms=100), g.add("ext_sink", "out"))
    tk = Ticker(g.build(), device="cpu", realtime=False)
    tk.params["dl"]["delay_ticks"].copy_(torch.tensor([0, 3]))
    outs = []
    tk.set_io(pull=lambda t: {"in": np.full((2, S), float(t + 1), np.float32)},
              push=lambda t, o: outs.append(np.asarray(o["out"])))
    tk.warm_up()
    for _ in range(6):
        tk.do_tick()
    assert outs[5][0, 0] == 6.0 and outs[5][1, 0] == 3.0
    ft = t_q.apply_quirks(t_as.AudioStreamFeatures(echo_canceller=True),
                          t_q.lookup_quirks("generic", "usb headset"))
    st = t_as.AudioStreamBatch(Factory(), 1, features=ft, device="cpu")
    assert "ec_delay" in st.ticker.state and "ec" in st.ticker.state
    assert st.ticker.state["ec_delay"]["ring"].shape[1] == 200 // 10 + 1
    st.ticker.params["ec_delay"]["delay_ticks"].fill_(ft.ec_delay_ms // 10)


def test_pulse_card_gated():
    """The PulseAudio card mirrors the ALSA gating: without libpulse-simple
    its detector registers nothing and the card raises naming it."""
    assert t_pulse.pulse_available() == j_pulse.pulse_available()
    mgr = t_dev.SndCardManager()
    if not t_pulse.pulse_available():
        with pytest.raises(RuntimeError, match="libpulse-simple"):
            t_pulse.PulseSndCard()
        t_pulse.detect_pulse_cards(mgr)
        assert all(c.driver != "pulse" for c in mgr.cards)
        assert [c.name for c in mgr.cards] == [c.name for c in j_dev.SndCardManager().cards]
        return
    card = next((c for c in mgr.cards if c.driver == "pulse"), None)  # pragma: no cover
    if card is None:                                                   # pragma: no cover
        pytest.skip("libpulse present but no PulseAudio daemon")
    blk = card.pull(0, 2)                                              # pragma: no cover
    assert blk.shape == (2, card.samples_per_tick)                     # pragma: no cover
    card.close()                                                       # pragma: no cover


# -- tests/test_native_and_devices.py -------------------------------------------
def test_sndcard_manager():
    mgr = t_dev.SndCardManager()
    assert mgr.get_card("null") is not None
    fc = t_dev.FileSndCard(signal=np.ones(800, np.float32) * 0.1, rate=8000)
    mgr.add_card(fc)
    assert mgr.get_card("file") is fc
    blk = fc.pull(0, batch=3)
    assert blk.shape == (3, 80) and np.allclose(blk, 0.1)
    fc.push(0, blk)
    assert len(fc.played) == 1
    assert mgr.get_default(t_dev.CAP_CAPTURE) is not None
    sig = make_speechlike(1000, 8000, seed=2)
    for tick in (0, 5, 12):                       # the last one past the signal's end
        np.testing.assert_array_equal(t_dev.FileSndCard(signal=sig).pull(tick, 2),
                                      j_dev.FileSndCard(signal=sig).pull(tick, 2))
    cb = t_dev.CallbackSndCard("cb", pull_cb=lambda t, b: np.full((b, 480), t, np.float32),
                               builtin_ec=True)
    assert cb.capabilities == t_dev.CAP_CAPTURE | t_dev.CAP_BUILTIN_EC
    assert cb.pull(3, 2).max() == 3.0 and t_dev.SndCard("n", "null", 0).pull(0, 1).shape == (1, 480)


def test_webcam_manager():
    """The mire camera names the port's ``mire`` filter (the frame it
    makes is the JAX mire's: tests/test_torch_video.py); the static camera
    converts its picture as JAX's does."""
    mgr = t_dev.WebCamManager()
    assert mgr.get_cam("mire") is not None and mgr.get_cam("static_image") is not None
    name, params = mgr.get_default().graph_source()
    assert name == "mire" and params["fmt"] == Format(kind="yuv420", width=320, height=240,
                                                      fps=30.0)
    g = GraphBuilder(Factory(), batch=2)
    g.chain(g.add(name, "cam", **params), g.add("ext_sink", "out"))
    cg = g.build()
    _, out, _ = cg.step(cg.init_state("cpu"), cg.init_params("cpu"), {})
    assert tuple(out["out"].shape) == (2, 360, 320)
    frame = mgr.get_cam("static_image").get_frame(batch=2)
    assert frame.shape == (2, 240 * 3 // 2, 320) and not frame.any()
    fmt = Format(kind="yuv420", width=16, height=8, fps=15.0)
    img = np.random.default_rng(6).random((8, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(t_dev.StaticImageWebCam(fmt, image=img).get_frame(1),
                               j_dev.StaticImageWebCam(fmt, image=img).get_frame(1), atol=1e-6)
    with pytest.raises(NotImplementedError, match="get_frame"):
        mgr.get_cam("static_image").graph_source()


def test_sound_card_volume_gains():
    """MS_AUDIO_CAPTURE / PLAYBACK_SET_VOLUME_GAIN at the card boundary,
    applied by the base class to every card alike."""
    card = t_dev.FileSndCard(signal=np.ones(800, np.float32) * 0.5, rate=8000)
    assert card.pull(0, 2).max() == np.float32(0.5)
    card.set_input_gain(0.2)
    assert abs(card.pull(0, 2).max() - 0.1) < 1e-6
    card.set_output_gain(2.0)
    card.push(0, np.ones((1, 80), np.float32) * 0.25)
    assert abs(card.played[-1].max() - 0.5) < 1e-6


def test_stream_sound_card_gain_surface():
    """audio_stream_set_sound_card_input / output_gain: the stream's card
    plays its ``spk`` block times the output gain and captures its mic
    times the input gain; without a card the setters raise and the getters
    read -1."""
    card = t_dev.FileSndCard(signal=np.ones(8000, np.float32) * 0.5, rate=8000)
    st = t_as.AudioStreamBatch(Factory(), 1, snd_card=card, device="cpu",
                               features=t_as.AudioStreamFeatures(plc=False, volume=False))
    st.set_sound_card_input_gain(0.5)
    st.set_sound_card_output_gain(1.5)
    assert st.get_sound_card_input_gain() == 0.5 and st.get_sound_card_output_gain() == 1.5
    assert np.allclose(st._mic_block(0, 1, 80), 0.25)
    st.ticker.realtime = False
    spk = []
    push = st.ticker._io_push
    st.ticker.set_io(pull=st.ticker._io_pull,
                     push=lambda t, o: (spk.append(o["spk"].copy()), push(t, o)))
    st.set_transport(0, t_rtp.LoopbackPair().endpoint(0))
    for _ in range(3):
        st.ticker.do_tick()
    np.testing.assert_array_equal(np.stack(card.played), np.stack(spk) * np.float32(1.5))
    bare = t_as.AudioStreamBatch(Factory(), 1, device="cpu")
    with pytest.raises(RuntimeError, match="no sound card"):
        bare.set_sound_card_output_gain(2.0)
    assert bare.get_sound_card_input_gain() == -1.0 == bare.get_sound_card_output_gain()
