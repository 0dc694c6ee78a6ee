"""The port's gateway pieces against the JAX package on the CPU:
``flow_control`` (per tick, <= 1e-6), ``ItcBridge``, ``TranscodeBatch``
(ulaw@8k -> g722@16k by similarity, the JAX test's bar; ulaw -> g726_32 ->
ulaw with the codes on the wire equal to the JAX package's, tolerance 0)
and ``RingStreamBatch`` (<= 1e-6 over 30 ticks)."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mediastreamer2_tpu.core.block import Format as JFormat  # noqa: E402
from mediastreamer2_tpu.core.factory import Factory as JFactory  # noqa: E402
from mediastreamer2_tpu.core.graph import GraphBuilder as JGraphBuilder  # noqa: E402
from mediastreamer2_tpu.models.ring_stream import RingStreamBatch as JRingStreamBatch  # noqa: E402
from mediastreamer2_tpu.models.transcode import TranscodeBatch as JTranscodeBatch  # noqa: E402
from mediastreamer2_tpu.net import rtp as j_rtp  # noqa: E402
from mediastreamer2_tpu_torch import (Factory, Format, GraphBuilder, RingStreamBatch,  # noqa: E402
                                      TranscodeBatch, tick_samples)
from mediastreamer2_tpu_torch.core.ticker import Ticker  # noqa: E402
from mediastreamer2_tpu_torch.models.audio_stream import AudioStreamBatch  # noqa: E402
from mediastreamer2_tpu_torch.net import rtp as t_rtp  # noqa: E402
from mediastreamer2_tpu_torch.ops.fileio import recorder_get_audio  # noqa: E402
from mediastreamer2_tpu_torch.ops.g711 import float_to_pcm16, ulaw_encode  # noqa: E402
from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff  # noqa: E402
from mediastreamer2_tpu_torch.utils.convert import from_jax, to_numpy  # noqa: E402
from mediastreamer2_tpu_torch.utils.itc import ItcBridge  # noqa: E402
from mediastreamer2_tpu_torch.utils.signals import make_speechlike  # noqa: E402

S = tick_samples(8000)


# ---------------------------------------------------------------- flow control
def _fc_graph(builder, factory, fmt, B):
    g = builder(factory, batch=B)
    src = g.add("ext_source", "in", fmt=fmt)
    g.chain(src, g.add("flow_control", "fc"), g.add("ext_sink", "out"))
    return g.build()


def test_flow_control_matches_jax_and_drops_latency():
    """The ramp of the JAX test on leg 0 (a quarter tick dropped at tick
    10), speech with two drop requests on leg 1: outputs within 1e-6 per
    tick, ``dropped`` and ``fill`` equal, ``fill`` ending at S - S//4."""
    B, total = 2, 40
    jcg = _fc_graph(JGraphBuilder, JFactory(), JFormat(rate=8000), B)
    tcg = _fc_graph(GraphBuilder, Factory(), Format(rate=8000), B)
    jst, jp = jcg.init_state(), jcg.init_params()
    tst, tp = tcg.init_state("cpu"), tcg.init_params("cpu")
    speech = make_speechlike(total * S, 8000, seed=4)
    outs = []
    for i in range(total):
        x = np.stack([np.arange(i * S, (i + 1) * S, dtype=np.float32) / (total * S),
                      speech[i * S:(i + 1) * S]])
        drop = np.array([S // 4 if i == 10 else 0, {5: 7, 20: 200}.get(i, 0)], np.int32)
        jp["fc"]["drop_samples"] = jnp.asarray(drop)
        tp["fc"]["drop_samples"].copy_(torch.from_numpy(drop))
        jst, jout, jev = jcg.step(jst, jp, {"in": x})
        tst, tout, tev = tcg.step(tst, tp, {"in": torch.from_numpy(x)})
        np.testing.assert_allclose(tout["out"].numpy(), np.asarray(jout["out"]), rtol=0,
                                   atol=1e-6, err_msg=f"tick {i}")
        np.testing.assert_array_equal(tev["fc.dropped"].numpy(), np.asarray(jev["fc.dropped"]))
        np.testing.assert_array_equal(tst["fc"]["fill"].numpy(), np.asarray(jst["fc"]["fill"]))
        outs.append(tout["out"][0].numpy())
    assert tst["fc"]["fill"].tolist() == [S - S // 4, S - 7 - S // 4]
    assert tst["fc"]["fill"].dtype == torch.int32
    y = np.concatenate(outs)
    assert np.abs(np.diff(y[S:])).max() < 2.0 / (total * S)     # the ramp stays continuous
    # the state crosses the packages both ways, dtypes kept
    carried = from_jax({k: np.asarray(v) for k, v in jst["fc"].items()}, "cpu")
    assert carried["fill"].dtype == torch.int32 and carried["ring"].dtype == torch.float32
    back = to_numpy(tst["fc"])
    assert back["fill"].dtype == np.int32 and back["ring"].dtype == np.float32
    x = speech[None, :S].repeat(B, 0)
    _, jout, _ = jcg.step({"fc": {k: jnp.asarray(v) for k, v in back.items()}}, jp, {"in": x})
    _, tout, _ = tcg.step({"fc": carried}, tp, {"in": torch.from_numpy(x)})
    np.testing.assert_allclose(tout["out"].numpy(), np.asarray(jout["out"]), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- ItcBridge
def test_itc_bridge_counts_overruns_and_underruns():
    b = ItcBridge((2, 4), depth=4)
    assert b.pull().shape == (2, 4) and b.underruns == 1
    for k in range(6):
        b.push(np.full((2, 4), k, np.float32))
    assert b.overruns == 2
    assert [int(b.pull()[0, 0]) for _ in range(4)] == [2, 3, 4, 5]     # oldest dropped
    assert b.underruns == 1
    b.push(torch.full((2, 4), 9.0))                 # a tensor comes to the host first
    got = b.pull()
    assert isinstance(got, np.ndarray) and got[1, 3] == 9.0
    b.as_push_io("snk")(0, {"snk": torch.ones(2, 4)})
    assert b.as_pull_io("src")(0)["src"].sum() == 8


def test_itc_bridge_hands_off_between_two_tickers():
    """A player graph on one ticker feeds a recorder graph on another
    through the bridge, each ticker on its own thread: the recording is the
    signal (one tick of slack; no overrun with the consumer a tick behind)."""
    B, ticks = 2, 30
    sig = make_speechlike(S * ticks, 8000, seed=12)
    f = Factory()
    g = GraphBuilder(f, batch=B)
    g.chain(g.add("file_player", "play", fmt=Format(rate=8000), signal=sig),
            g.add("ext_sink", "out"))
    producer = Ticker(g.build(), device="cpu", realtime=False, name="producer")
    g = GraphBuilder(f, batch=B)
    g.chain(g.add("ext_source", "in", fmt=Format(rate=8000)),
            g.add("file_recorder", "rec", max_ticks=ticks))
    consumer = Ticker(g.build(), device="cpu", realtime=False, name="consumer")
    bridge = ItcBridge((B, S), depth=4)
    producer.set_io(push=bridge.as_push_io("out"))
    consumer.set_io(pull=bridge.as_pull_io("in"))
    turn = [threading.Semaphore(1), threading.Semaphore(0)]

    def run(tk, me):
        for _ in range(ticks):
            turn[me].acquire()
            tk.do_tick()
            turn[1 - me].release()
    threads = [threading.Thread(target=run, args=(tk, i))
               for i, tk in enumerate((producer, consumer))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    rec = recorder_get_audio(consumer.state["rec"], ticks, S)
    np.testing.assert_array_equal(rec[0], sig)
    np.testing.assert_array_equal(rec[1], sig)
    assert (bridge.overruns, bridge.underruns) == (0, 0)


# ---------------------------------------------------------------- TranscodeBatch
def test_transcode_ulaw_to_g722():
    """A sends ulaw@8k -> transcoder -> B receives g722@16k (the JAX test's
    shape and bar: similarity > 0.85 at 8 kHz)."""
    ticks = 70                            # the plain G.722 loop is ~20 ms a call
    sig = make_speechlike(S * ticks, 8000, seed=21)
    f = Factory()
    a = AudioStreamBatch(f, 1, codec="ulaw", rate=8000, mic_signal=sig, device="cpu")
    b = AudioStreamBatch(f, 1, codec="g722", rate=16000, record_ticks=ticks + 40, device="cpu")
    tc = TranscodeBatch(f, 1, codec_in="ulaw", rate_in=8000, codec_out="g722",
                        rate_out=16000, device="cpu")
    assert (tc.S_in, tc.S_out, tc.clock_out) == (80, 80, 8000)
    pa, pb = t_rtp.LoopbackPair(), t_rtp.LoopbackPair()
    a.set_transport(0, pa.endpoint(0))
    tc.set_transports(0, rx=pa.endpoint(1), tx=pb.endpoint(0))
    b.set_transport(0, pb.endpoint(1))
    for s in (a, tc, b):
        s.ticker.warm_up()
        s.ticker.realtime = False
    for _ in range(ticks + 20):
        a.ticker.do_tick()
        tc.ticker.do_tick()
        b.ticker.do_tick()
    rec = b.get_recording()[0]            # 16 kHz
    rec8 = (rec[0::2] + rec[1::2]) / 2.0  # compare at 8k: average-pair decimation
    sim, _ = audio_diff(sig, rec8)
    assert sim > 0.85, sim


def _gateway(Transcode, factory, rtp, ulaw_payloads, **kw):
    """ulaw RTP in -> (ulaw -> g726_32) -> (g726_32 -> ulaw) -> out, one
    leg; returns the codes each transcoder put on the wire, per tick."""
    t1 = Transcode(factory, 1, codec_in="ulaw", rate_in=8000, codec_out="g726_32",
                   rate_out=8000, **kw)
    t2 = Transcode(factory, 1, codec_in="g726_32", rate_in=8000, codec_out="ulaw",
                   rate_out=8000, **kw)
    pin, mid, pout = rtp.LoopbackPair(), rtp.LoopbackPair(), rtp.LoopbackPair()
    sender = rtp.RtpSession(pin.endpoint(0), payload_type=0, clock_rate=8000)
    t1.set_transports(0, rx=pin.endpoint(1), tx=mid.endpoint(0))
    t2.set_transports(0, rx=mid.endpoint(1), tx=pout.endpoint(0))
    wire = ([], [])
    for tc, rec in zip((t1, t2), wire):
        def tapped(tick, out, tc=tc, rec=rec, push=tc._push):
            rec.append(np.asarray(out["tx"])[0].copy())
            push(tick, out)
        tc.ticker.set_io(pull=tc._pull, push=tapped)
        tc.ticker.warm_up()
        tc.ticker.realtime = False
    for payload in ulaw_payloads:
        sender.send_payload(payload, ts_increment=S)
        t1.ticker.do_tick()
        t2.ticker.do_tick()
    return np.stack(wire[0]), np.stack(wire[1]), t1, t2


def test_gateway_wire_codes_equal_jax():
    """The G.711 <-> G.726-32 gateway over 60 ticks of speech: the G.726
    codes leaving the first transcoder and the mu-law codes leaving the
    second equal the JAX package's ``TranscodeBatch`` chain's, and the
    speech comes through (similarity > 0.85 from tick 10 on, a few ticks
    late: two jitter buffers)."""
    ticks = 60
    sig = make_speechlike(S * ticks, 8000, seed=33)
    codes = ulaw_encode(float_to_pcm16(torch.from_numpy(sig))).numpy().astype(np.uint8)
    payloads = [codes[t * S:(t + 1) * S].tobytes() for t in range(ticks)]
    j726, julaw, _, _ = _gateway(JTranscodeBatch, JFactory(), j_rtp, payloads)
    t726, tulaw, t1, t2 = _gateway(TranscodeBatch, Factory(), t_rtp, payloads, device="cpu")
    assert t726.shape == (ticks, S) and 0 <= t726.min() and t726.max() <= 15
    assert t726.max() >= 14                                  # the codec ran on speech
    np.testing.assert_array_equal(t726, j726)
    np.testing.assert_array_equal(tulaw, julaw)
    # 16-bit big-endian codes on the G.726 hop, one byte a code on the G.711 hops
    assert t1._encode(t726[5]) == t726[5].astype(">i2").tobytes()
    assert len(t2._encode(tulaw[5])) == S
    from mediastreamer2_tpu_torch.ops.g711 import pcm16_to_float, ulaw_decode
    heard = pcm16_to_float(ulaw_decode(torch.from_numpy(tulaw.reshape(-1).astype(np.int32))))
    # the decoders run on the jitter buffers' empty first ticks (code 0, as in
    # the JAX package) and play a loud transient: compare from tick 10 on
    _, lag = audio_diff(sig, heard.numpy())
    assert 0 < lag <= 8 * S, lag
    sim, _ = audio_diff(sig[S * 10 - lag:len(sig) - lag], heard.numpy()[S * 10:])
    assert sim > 0.85, (sim, lag)


def test_transcode_takes_the_payload_types_codecs_only():
    """dvi4 has no payload type in the stream's profile, as in the JAX
    package: a transcoder builds, its transports cannot be set."""
    tc = TranscodeBatch(Factory(), 1, codec_in="ulaw", rate_in=8000, codec_out="dvi4",
                        rate_out=8000, device="cpu")
    pair = t_rtp.LoopbackPair()
    with pytest.raises(KeyError):
        tc.set_transports(0, rx=pair.endpoint(0), tx=pair.endpoint(1))


# ---------------------------------------------------------------- RingStreamBatch
@pytest.mark.parametrize("out_rate", [None, 16000])
def test_ring_stream_matches_jax(out_rate):
    """3 legs ringing a 12-tick tone burst on a loop for 30 ticks, straight
    and through the 8k -> 16k resampler: the speaker blocks within 1e-6."""
    B, ticks = 3, 30
    t = np.arange(S * 12) / 8000
    ring = (0.5 * np.sin(2 * np.pi * 440 * t) * (t < 0.08)).astype(np.float32)

    def run(stream):
        got = []
        stream.ticker.set_io(push=lambda tick, out: got.append(np.asarray(out["spk"]).copy()))
        stream.ticker.warm_up()
        stream.ticker.realtime = False
        for _ in range(ticks):
            stream.ticker.do_tick()
        return np.concatenate(got, axis=1)
    want = run(JRingStreamBatch(JFactory(), B, ring, 8000, out_rate=out_rate))
    got = run(RingStreamBatch(Factory(), B, ring, 8000, out_rate=out_rate, device="cpu"))
    assert got.shape == want.shape == (B, ticks * tick_samples(out_rate or 8000))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got[:, -S:]).max() > 0.1 or np.abs(got).max() > 0.4    # it looped
    once = RingStreamBatch(Factory(), B, ring, 8000, loop=False, device="cpu")
    assert not once.ticker.params["play"]["loop"].any()
