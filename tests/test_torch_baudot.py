"""The port's Baudot TTY (``ops/baudot.py`` and its place in
``AudioStreamBatch``) against the JAX package on the CPU.

Tolerances: the generator's audio ``atol`` 2.5e-5 per tick from equal
state. Its phase is a cumsum of 80 float32 steps of ~1.1-1.4 rad on top of
the carried phase, so it reaches ~113 rad, where one float32 ulp is
7.6e-6; XLA accumulates it in float32 and PyTorch's CPU cumsum in double,
so the two differ by a few ulps of the phase, times the amplitude 0.4:
measured 1.22e-5 at worst over this test's 120 ticks; the bar is 8 ulps
(0.4 x 8 x 7.6e-6). The detector's envelopes ``rtol`` 1e-4 (with
``atol`` 1e-6 for windows near silence: the four correlations are one
matrix product here, two einsums each there); decoded text exact."""
import os
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mediastreamer2_tpu.core.block import Format as JFormat  # noqa: E402
from mediastreamer2_tpu.core.factory import Factory as JFactory  # noqa: E402
from mediastreamer2_tpu.core.graph import GraphBuilder as JGraphBuilder  # noqa: E402
from mediastreamer2_tpu.ops import baudot as jb  # noqa: E402
from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder, tick_samples  # noqa: E402
from mediastreamer2_tpu_torch.models.audio_stream import (AudioStreamBatch,  # noqa: E402
                                                          AudioStreamFeatures)
from mediastreamer2_tpu_torch.net.rtp import LoopbackPair  # noqa: E402
from mediastreamer2_tpu_torch.ops import baudot as tb  # noqa: E402
from mediastreamer2_tpu_torch.utils.convert import from_jax, to_numpy  # noqa: E402

GEN_ATOL = 2.5e-5
ENV_RTOL, ENV_ATOL = 1e-4, 1e-6


def test_ita2_tables_and_bit_schedules_equal_jax():
    assert (tb._LTRS, tb._FIGS, tb.LTRS_SHIFT, tb.FIGS_SHIFT) == \
        (jb._LTRS, jb._FIGS, jb.LTRS_SHIFT, jb.FIGS_SHIFT)
    assert (tb.MARK_HZ, tb.SPACE_HZ, tb.DEFAULT_BAUD, tb.MAX_BITS, tb.ENV_DECIM) == \
        (jb.MARK_HZ, jb.SPACE_HZ, jb.DEFAULT_BAUD, jb.MAX_BITS, jb.ENV_DECIM)
    assert tb.char_to_code("E", False) == (1, False)
    assert tb.char_to_code("3", False) == (1, True)     # FIGS table
    for text in ("A", "HELLO 123", "SOS 911 OK", "x\ny $5!"):
        assert tb.text_to_bits(text) == jb.text_to_bits(text)
        assert tb.text_to_bits(text, stop_bits=1.0) == jb.text_to_bits(text, stop_bits=1.0)
    assert tb.text_to_bits("A")[:8] == [1] * 8                        # idle marks
    codes = list(range(32)) * 2
    assert tb.bits_to_text(codes) == jb.bits_to_text(codes)


def _graph(builder, factory, fmt, B):
    g = builder(factory, batch=B)
    src = g.add("void_source", "vs", fmt=fmt)
    gen = g.add("baudot_gen", "gen")
    det = g.add("baudot_det", "det")
    g.chain(src, gen, det)
    g.link(det, 0, g.add("ext_sink", "out"), 0)
    return g.build()


def _run_roundtrip(text, ticks=300, B=2, baud=None):
    cg = _graph(GraphBuilder, Factory(), Format(rate=8000), B)
    st, params = cg.init_state("cpu"), cg.init_params("cpu")
    if baud is not None:
        params["gen"]["baud"].fill_(baud)
    st["gen"] = tb.load_text(st["gen"], {0: text}, B)
    framers = [tb.BaudotFramer(**({} if baud is None else {"baud": baud})) for _ in range(B)]
    for _ in range(ticks):
        st, out, ev = cg.step(st, params, {})
        for leg in range(B):
            framers[leg].push_envelopes(ev["det.mark_env"][leg].numpy(),
                                        ev["det.space_env"][leg].numpy())
    return framers


@pytest.mark.parametrize("text,ticks", [("HELLO 123", 300), ("SOS 911 OK", 400)])
def test_roundtrip_text(text, ticks):
    framers = _run_roundtrip(text, ticks)
    assert framers[0].text() == text
    assert framers[1].text() == ""           # the silent leg decodes nothing


def test_europe_mode_50_baud():
    assert _run_roundtrip("EURO 50", 300, B=1, baud=50.0)[0].text() == "EURO 50"


def test_generator_and_detector_match_jax_tick_by_tick():
    """The same text on 3 legs (one silent, one at 50 baud) through both
    packages; at every tick the port starts from the JAX state of that tick
    (carried across by ``from_jax``), so differences do not accumulate:
    audio within GEN_ATOL, envelopes within ENV_RTOL, the ``sending_done``
    event and the integer state equal, and the state's dtypes kept both
    ways."""
    B, ticks = 3, 120
    jcg = _graph(JGraphBuilder, JFactory(), JFormat(rate=8000), B)
    tcg = _graph(GraphBuilder, Factory(), Format(rate=8000), B)
    jst, jparams = jcg.init_state(), jcg.init_params()
    tparams = tcg.init_params("cpu")
    jparams["gen"]["baud"] = jnp.asarray([45.45, 50.0, 45.45], jnp.float32)
    tparams["gen"]["baud"].copy_(torch.tensor([45.45, 50.0, 45.45]))
    jst["gen"] = jb.load_text(jst["gen"], {0: "HI 42", 1: "OK"}, B)
    tst0 = tb.load_text(tcg.init_state("cpu")["gen"], {0: "HI 42", 1: "OK"}, B)
    for k in ("bits", "nbits", "bit_pos"):
        np.testing.assert_array_equal(tst0[k].numpy(), np.asarray(jst["gen"][k]))
    jstep = jax.jit(jcg.step)
    done = np.zeros(B, bool)
    for t in range(ticks):
        tst = {n: from_jax({k: np.asarray(v) for k, v in jst[n].items()}, "cpu")
               for n in ("gen", "det")}
        assert tst["gen"]["nbits"].dtype == torch.int32
        assert tst["gen"]["phase"].dtype == tst["det"]["tail"].dtype == torch.float32
        jst, jout, jev = jstep(jst, jparams, {})
        tst, tout, tev = tcg.step(tst, tparams, {})
        np.testing.assert_allclose(tout["out"].numpy(), np.asarray(jout["out"]), rtol=0,
                                   atol=GEN_ATOL, err_msg=f"tick {t}")
        for k in ("mark_env", "space_env"):
            np.testing.assert_allclose(tev[f"det.{k}"].numpy(), np.asarray(jev[f"det.{k}"]),
                                       rtol=ENV_RTOL, atol=ENV_ATOL, err_msg=f"{k} tick {t}")
        np.testing.assert_array_equal(tev["gen.sending_done"].numpy(),
                                      np.asarray(jev["gen.sending_done"]))
        back = to_numpy(tst["gen"])
        assert back["nbits"].dtype == np.int32 and back["bits"].dtype == np.float32
        np.testing.assert_array_equal(back["nbits"], np.asarray(jst["gen"]["nbits"]))
        np.testing.assert_allclose(back["bit_pos"], np.asarray(jst["gen"]["bit_pos"]),
                                   rtol=1e-6)
        # the phase is taken mod 2 pi: compare on the circle
        dphi = np.abs(back["phase"] - np.asarray(jst["gen"]["phase"]))
        assert np.minimum(dphi, 2 * np.pi - dphi).max() < 1e-4
        np.testing.assert_allclose(to_numpy(tst["det"])["tail"],
                                   np.asarray(jst["det"]["tail"]), rtol=0, atol=GEN_ATOL)
        done |= np.asarray(jev["gen.sending_done"])
    assert done.tolist() == [False, True, False]      # "OK" at 50 baud ends within 1.2 s


def test_baudot_over_audio_stream():
    """Session-level TTY: ``send_baudot_string`` on one stream, the decoded
    text on the peer; without the feature the call raises."""
    f = Factory()
    feats = AudioStreamFeatures(baudot=True, plc=False, volume=False)
    tx = AudioStreamBatch(f, 1, features=feats, device="cpu")
    rx = AudioStreamBatch(f, 1, features=feats, device="cpu")
    names = [n.name for n in rx.graph.nodes]
    assert names.index("baudot_det") == names.index("dec") + 1
    assert [n.name for n in tx.graph.nodes].index("baudot_gen") < names.index("enc")
    tx.ticker.warm_up()
    rx.ticker.warm_up()
    pair = LoopbackPair()
    tx.set_transport(0, pair.endpoint(0))
    rx.set_transport(0, pair.endpoint(1))
    tx.send_baudot_string(0, "SOS 911")
    tx.ticker.realtime = rx.ticker.realtime = False
    for _ in range(350):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
        rx.iterate()                      # pumps detector events
    assert rx.get_baudot_text(0) == "SOS 911"
    plain = AudioStreamBatch(f, 1, device="cpu")
    with pytest.raises(RuntimeError, match="baudot"):
        plain.send_baudot_string(0, "X")


def test_set_baudot_mode_switches_generator_and_framer():
    f = Factory()
    feats = AudioStreamFeatures(baudot=True, plc=False, volume=False)
    tx = AudioStreamBatch(f, 2, features=feats, device="cpu")
    rx = AudioStreamBatch(f, 2, features=feats, device="cpu")
    for leg in range(2):
        pair = LoopbackPair()
        tx.set_transport(leg, pair.endpoint(0))
        rx.set_transport(leg, pair.endpoint(1))
    tx.set_baudot_mode(1, "europe")
    rx.set_baudot_mode(1, "europe")
    with pytest.raises(KeyError):
        tx.set_baudot_mode(0, "mars")
    tx.send_baudot_string(0, "US 45")
    tx.send_baudot_string(1, "EU 50")
    tx.ticker.realtime = rx.ticker.realtime = False
    for _ in range(300):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
        rx.iterate()
    assert tx.ticker.params["baudot_gen"]["baud"].tolist() == pytest.approx([45.45, 50.0])
    assert (rx.get_baudot_text(0), rx.get_baudot_text(1)) == ("US 45", "EU 50")


def test_decode_reference_recordings():
    """Wire interop: the reference's own Baudot TTY recordings
    (tester/sounds/baudot_mono_*_us.wav), read with the standard library."""
    from test_aec_real_speech import FIX      # where the JAX package's tests look
    if not os.path.isdir(FIX):
        pytest.skip("reference fixtures not mounted")

    def decode(fname):
        with wave.open(f"{FIX}/{fname}") as w:
            rate, nch = w.getframerate(), w.getnchannels()
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2").reshape(-1, nch)
        sig = (pcm.astype(np.float32) / 32768.0).mean(axis=1)
        S = tick_samples(rate)
        g = GraphBuilder(Factory(), batch=1)
        src = g.add("ext_source", "in", fmt=Format(rate=rate))
        det = g.add("baudot_det", "det")
        g.chain(src, det)
        g.link(det, 0, g.add("ext_sink", "out"), 0)
        cg = g.build()
        st, params = cg.init_state("cpu"), cg.init_params("cpu")
        framer = tb.BaudotFramer(rate=rate)
        for t in range(len(sig) // S):
            st, out, ev = cg.step(st, params,
                                  {"in": torch.from_numpy(sig[t * S:(t + 1) * S][None].copy())})
            framer.push_envelopes(ev["det.mark_env"][0].numpy(), ev["det.space_env"][0].numpy())
        return framer.text()

    assert decode("baudot_mono_alphabet_us.wav") == "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    assert "0123456789" in decode("baudot_mono_digits_us.wav")
