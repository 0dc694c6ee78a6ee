"""The port's AAC (``ops/aac.py``: libavcodec's AAC-LC over ctypes, RFC 3640
payloads) against the JAX package's on the CPU, the seven cases of
``tests/test_aac.py``: the encoder's access units and the RFC 3640
payloads byte-equal to JAX's, the AudioSpecificConfig, the AAC stream over
RTP (payloads equal to the JAX stream's, recordings within 1e-6), the
mpeg4-generic offer and BV16's gating. A case that needs libavcodec skips
where it is missing; there the constructors must raise naming it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mediastreamer2_tpu.models import audio_stream as j_as  # noqa: E402
from mediastreamer2_tpu.net import rtp as j_rtp  # noqa: E402
from mediastreamer2_tpu.ops import aac as j_aac  # noqa: E402
from mediastreamer2_tpu_torch import Factory  # noqa: E402
from mediastreamer2_tpu_torch.models import audio_stream as t_as  # noqa: E402
from mediastreamer2_tpu_torch.net import rtp as t_rtp  # noqa: E402
from mediastreamer2_tpu_torch.ops import aac as t_aac  # noqa: E402
from mediastreamer2_tpu_torch.ops import host_codecs as t_hc  # noqa: E402
from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff  # noqa: E402
from mediastreamer2_tpu_torch.utils.signals import make_speechlike  # noqa: E402

needs_aac = pytest.mark.skipif(not t_aac.aac_available(), reason="libavcodec aac missing")


def test_availability_agrees_and_absence_names_libavcodec(monkeypatch):
    assert t_aac.aac_available() == j_aac.aac_available()
    monkeypatch.setattr(t_aac, "_av", None)
    for make in (lambda: t_aac.AacEncoder(16000, 1), lambda: t_aac.AacDecoder(16000, 1),
                 lambda: t_aac.AacStreamCodec(16000, 1)):
        with pytest.raises(RuntimeError, match="libavcodec"):
            make()


def _aus(mod, sig, blocks, rate=16000, channels=1):
    enc = mod.AacEncoder(rate, channels)
    return [au for i in range(blocks) for au in enc.encode(sig[i * 1024:(i + 1) * 1024])]


@needs_aac
@pytest.mark.parametrize("rate,channels", [(16000, 1), (48000, 2)])
def test_codec_roundtrip_bytes_equal_and_quality(rate, channels):
    """tests/test_aac.py::test_codec_roundtrip_quality: the port's access
    units equal JAX's, both decoders give equal samples, and the round
    trip keeps the speech (> 0.8)."""
    sig = make_speechlike(1024 * 20, rate, seed=3)
    x = sig if channels == 1 else np.stack([sig, -0.5 * sig], axis=1)
    j, t = _aus(j_aac, x, 20, rate, channels), _aus(t_aac, x, 20, rate, channels)
    assert t == j and len(t) >= 18
    outs = []
    for mod in (j_aac, t_aac):
        dec = mod.AacDecoder(rate, channels)
        outs.append(np.concatenate([o for o in (dec.decode(au) for au in t) if o.size]))
    np.testing.assert_array_equal(outs[1], outs[0])
    sim, _ = audio_diff(sig, outs[1][:, 0])
    assert sim > 0.8, f"aac roundtrip sim {sim}"


@needs_aac
def test_rfc3640_aggregation_and_fragmentation():
    rng = np.random.default_rng(0)
    noise = (rng.standard_normal(12 * 1024) * 0.3).astype(np.float32)
    aus = _aus(t_aac, noise, 12)
    assert aus and aus == _aus(j_aac, noise, 12)
    for mtu in (48, 120, 1400):
        payloads = t_aac.rfc3640_pack(aus, mtu=mtu)
        assert payloads == j_aac.rfc3640_pack(aus, mtu=mtu)
        asm = t_aac.AacRtpAssembler()
        rec = []
        for p in payloads:
            assert len(p) <= mtu + 4
            rec += asm.push(p)
            assert t_aac.rfc3640_unpack(p) == j_aac.rfc3640_unpack(p)
        assert rec == aus, f"mtu={mtu}"


def test_fragment_au_size_is_complete_au():
    """RFC 3640 §3.2.3.1: fragments carry the COMPLETE AU size."""
    au = bytes(range(256)) * 2
    payloads = t_aac.rfc3640_pack([au], mtu=100)
    assert payloads == j_aac.rfc3640_pack([au], mtu=100) and len(payloads) > 1
    for p in payloads:
        assert int.from_bytes(p[2:4], "big") >> 3 == len(au)


def test_audio_specific_config():
    for rate, ch in ((8000, 1), (16000, 1), (32000, 2), (48000, 2)):
        cfg = t_aac.make_audio_specific_config(rate, ch)
        assert cfg == j_aac.make_audio_specific_config(rate, ch)
        assert t_aac.parse_audio_specific_config(cfg) == (rate, ch)
        assert t_aac._adts_header(rate, ch, 300) == j_aac._adts_header(rate, ch, 300)


def _aac_call(mod, rtp, factory, kw, sig, ticks):
    tx = mod.AudioStreamBatch(factory, 1, codec="aac", rate=16000, mic_signal=sig, **kw)
    rx = mod.AudioStreamBatch(factory, 1, codec="aac", rate=16000, record_ticks=ticks + 60, **kw)
    pair = rtp.LoopbackPair()
    tx.set_transport(0, pair.endpoint(0))
    rx.set_transport(0, pair.endpoint(1))
    sent = []
    send = tx.sessions[0].send_payload
    tx.sessions[0].send_payload = lambda p, **k: (sent.append((bytes(p), k)), send(p, **k))[1]
    tx.ticker.realtime = rx.ticker.realtime = False
    tx.ticker.warm_up()
    rx.ticker.warm_up()
    for _ in range(ticks + 20):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
    for _ in range(40):
        rx.ticker.do_tick()
    return sent, rx.get_recording()[0]


@needs_aac
def test_aac_stream_over_rtp(factory):
    """tests/test_aac.py::test_aac_stream_over_rtp on both packages, tick by
    tick: 1,024-sample AUs spanning 6.4 ticks through sample-granular FIFOs;
    the RTP timestamps advance by the AU; the payloads equal JAX's and the
    recordings agree within 1e-6; the bar, > 0.8 against the speech."""
    assert t_as.PAYLOAD_TYPES["aac"] == 98
    ticks = 120
    sig = make_speechlike(160 * ticks, 16000, seed=11)
    j_sent, j_rec = _aac_call(j_as, j_rtp, factory, {}, sig, ticks)
    t_sent, t_rec = _aac_call(t_as, t_rtp, Factory(), {"device": "cpu"}, sig, ticks)
    assert t_sent == j_sent and len(t_sent) >= 15
    assert {k["ts_increment"] for _, k in t_sent} == {t_aac.AAC_FRAME_SAMPLES}
    np.testing.assert_allclose(t_rec, j_rec, atol=1e-6)
    sim, _ = audio_diff(sig, t_rec)
    assert sim > 0.8, f"aac stream sim {sim}"
    with pytest.raises(ValueError, match="1024"):
        t_as.AudioStreamBatch(Factory(), 1, codec="aac", rate=16000, device="cpu").set_ptime(0, 20)


@needs_aac
def test_offer_answer_mpeg4_generic():
    from mediastreamer2_tpu_torch.models.offer_answer import (PayloadTypeDesc,
                                                              local_capabilities, negotiate)
    caps = local_capabilities()
    assert [c for c in caps if c.mime == "mpeg4-generic"], "aac capability missing"
    offer = PayloadTypeDesc("mpeg4-generic", 16000, 1, 97,
                            "mode=AAC-hbr;config=1408;sizeLength=13;indexLength=3;"
                            "indexDeltaLength=3")
    ans = negotiate([offer], caps)
    assert ans and ans[0].number == 97 and "mode=AAC-hbr" in ans[0].fmtp
    bad = PayloadTypeDesc("mpeg4-generic", 16000, 1, 97, "mode=generic")
    assert negotiate([bad], caps) == []


def test_bv16_gated_like_reference():
    """Without libbv16 the codec is absent (a reference build without
    ENABLE_BV16), and the stream refuses it naming the library."""
    if not t_hc.bv16_available():
        with pytest.raises(RuntimeError, match="libbv16"):
            t_hc.Bv16Codec()
        with pytest.raises(RuntimeError, match="libbv16"):
            t_as.AudioStreamBatch(Factory(), 1, codec="bv16", device="cpu")
    else:                                   # pragma: no cover (library absent here)
        c = t_hc.Bv16Codec()
        sig = make_speechlike(800, 8000, seed=1)
        sim, _ = audio_diff(sig, c.decode(c.encode(sig), frame_samples=800))
        assert sim > 0.7
